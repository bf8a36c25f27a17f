"""Smoke run of monodetr_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, and any failure exits non-zero:
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits 1 when no CUDA device is present;
  2. build the CUDA kernels from monodetr_torch/csrc;
  3. each kernel against its plain PyTorch version on the card at the
     slice's shapes, in f32 (TF32 off) and bf16: max |error| against a
     stated tolerance, and the kernel's and the plain version's times;
  4. the slice: MonoDETR at the full width of configs/monodetr.yaml, seeded
     random weights, `Tester.inference` over 3 batches of 16 synthetic
     384x1280 images in bf16 with the launch counters checked, then the f32
     forward at B=2 against the same model run through the plain versions.
The second-to-last line is the kernel report (JSON); the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from monodetr_torch import _build  # noqa: E402
from monodetr_torch.ops.attention import attention_plain, fused_attention  # noqa: E402
from monodetr_torch.ops.msda import ms_deform_attn  # noqa: E402
from monodetr_torch.ops.msda_enc import (  # noqa: E402
    ms_deform_attn_enc_fused, ms_deform_attn_enc_fused_plain, window_limit)
from monodetr_torch.ops.msda_sep import ms_deform_attn_sep  # noqa: E402

LEVELS = ((48, 160), (24, 80), (12, 40), (6, 20))  # 384x1280 / 8, 16, 32, 64
S = sum(h * w for h, w in LEVELS)
H, D, L, P, G = 8, 32, 4, 4, 6
DEPTH_TOKENS = 24 * 80
# max |kernel - plain| allowed.  f32: both sum in f32 in another order, and
# the plain MSDA re-normalises pixel positions for grid_sample (~1e-5 px at
# widths up to 160); bf16: the output is rounded to bf16 (2^-8 relative)
# at values of order 1.
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}

KERNELS = {
    "msda_enc_fused": dict(
        fn=ms_deform_attn_enc_fused, route="cuda",
        source="monodetr_torch/csrc/msda.cu",
        replaces="monodetr_tpu/ops/msda_enc_pallas.py:653"),
    "msda_sep": dict(
        fn=ms_deform_attn_sep, route="cuda",
        source="monodetr_torch/csrc/msda.cu",
        replaces="monodetr_tpu/ops/msda_sep_pallas.py:337"),
    "attention_fwd": dict(
        fn=fused_attention, route="cuda",
        source="monodetr_torch/csrc/attention.cu",
        replaces="monodetr_tpu/ops/attention_pallas.py:162"),
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20):
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment():
    if not torch.cuda.is_available():
        log("environment: no CUDA device; this smoke run needs one card")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"environment: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


def phase_build():
    t0 = time.time()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.relative_to(REPO)} in {time.time() - t0:.1f} s")


def kernel_inputs(name, B, dtype, gen):
    """Inputs at the slice's shapes, made on the card from a generator."""
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    if name == "msda_enc_fused":
        lim = window_limit(G)
        value = randn(B, S, H, D).to(dtype)
        off = ((torch.rand(B, S, 2 * H * L * P, generator=gen, device=dev) * 2 - 1)
               * (lim + 1.0)).to(dtype)  # some beyond the window: clamped
        logits = randn(B, S, H * L * P, scale=2.0).to(dtype)
        return (value, LEVELS, off, logits, G)
    if name == "msda_sep":
        Q = 50
        value = randn(B, S, H, D).to(dtype)
        loc = torch.rand(B, Q, H, L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
        att = torch.softmax(randn(B, Q, H, L * P), -1).view(B, Q, H, L, P)
        return (value, LEVELS, loc, att)
    q = randn(B, H, DEPTH_TOKENS, D).to(dtype)
    k = randn(B, H, DEPTH_TOKENS, D).to(dtype)
    v = randn(B, H, DEPTH_TOKENS, D).to(dtype)
    return (q, k, v, 0, D ** -0.5, 0.0)


def plain_of(name):
    return {
        "msda_enc_fused": ms_deform_attn_enc_fused_plain,
        "msda_sep": ms_deform_attn,
        "attention_fwd": lambda q, k, v, seed, scale, p: attention_plain(q, k, v, scale),
    }[name]


def phase_kernels():
    """Each kernel against its plain version in f32 and bf16 at B=2 and in
    bf16 at the slice's batch of 16, where both are also timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for name, spec in KERNELS.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        errs = []
        for dtype, B in ((torch.float32, 2), (torch.bfloat16, 2), (torch.bfloat16, 16)):
            args = kernel_inputs(name, B, dtype, gen)
            got = spec["fn"](*args)
            want = plain_of(name)(*args)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise RuntimeError(f"{name}: {got.shape}/{got.dtype} vs "
                                   f"{want.shape}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            errs.append(err)
            ok = err <= TOL[dtype] and torch.isfinite(got).all().item()
            tag = f"{str(dtype).replace('torch.', '')} B={B}"
            log(f"kernel {name} {tag}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} {tag} disagrees with its plain version")
        ms = cuda_ms(lambda: spec["fn"](*args))
        plain_ms = cuda_ms(lambda: plain_of(name)(*args))
        log(f"kernel {name} {tag}: {ms:.3f} ms, plain {plain_ms:.3f} ms")
        report[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    return report


class SyntheticLoader:
    """`n_batches` batches of `batch` normalised 384x1280 images from a
    seed, each with a KITTI P2 whose focal length and principal point vary
    a little, in the loader's (batch, infos) format."""

    def __init__(self, n_batches, batch, seed):
        self.n_batches, self.batch, self.seed = n_batches, batch, seed
        # meanshape: False in the shipped config -> zero mean sizes
        self.dataset = type("Dataset", (), {"cls_mean_size": np.zeros((3, 3), np.float32)})

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        p2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                       [0.0, 721.5377, 172.854, 0.2163791],
                       [0.0, 0.0, 1.0, 0.002745884]], np.float32)
        for b in range(self.n_batches):
            n = self.batch
            calibs = np.repeat(p2[None], n, 0)
            calibs[:, 0, 0] = calibs[:, 1, 1] = 700 + 40 * rng.random(n, np.float32)
            calibs[:, :2, 2] += rng.normal(0, 5, (n, 2)).astype(np.float32)
            images = rng.standard_normal((n, 384, 1280, 3), np.float32)
            sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (n, 1))
            infos = [{"img_id": b * n + i, "img_size": sizes[i]} for i in range(n)]
            yield {"images": images, "calibs": calibs, "img_sizes": sizes}, infos


def reset_launches():
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def phase_slice():
    """Tester.inference in bf16 at batch 16 with the launch counts read
    around it; then the f32 forward at B=2, kernels against plain versions."""
    import logging

    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.eval.tester import Tester
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype

    n_batches, batch = 3, 16
    model = build_monodetr(MONODETR_MODEL, seed=444).to("cuda", compute_dtype(MONODETR_MODEL))
    logging.basicConfig(level=logging.WARNING)
    # threshold 0: random weights score every pick near the 0.01 class
    # prior, and the decode of all 50 picks per image is what is checked
    tester = Tester({"threshold": 0.0, "topk": 50}, model, SyntheticLoader(n_batches, batch, 0),
                    logging.getLogger("chip_smoke"), {"save_path": "outputs/"}, "chip_smoke")
    reset_launches()
    results = tester.inference()
    torch.cuda.synchronize()
    counts = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    per_forward = {"msda_enc_fused": 3, "msda_sep": 3, "attention_fwd": 1}
    rows = [r for preds in results.values() for r in preds]
    ok = (counts == {k: v * n_batches for k, v in per_forward.items()}
          and len(results) == n_batches * batch and len(rows) == n_batches * batch * 50
          and np.isfinite(np.asarray(rows, np.float64)).all()
          and all(len(r) == 14 for r in rows))
    txts = len(os.listdir(tester.results_dir))
    log(f"slice: Tester.inference bf16 {n_batches} x {batch} images 384x1280: "
        f"{tester.ms_per_img:.2f} ms/img, launches {counts} (want {per_forward} per "
        f"forward), {len(rows)} KITTI rows in {txts} txts {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("slice: wrong launch counts or decoded rows")
    batch0, _ = next(iter(SyntheticLoader(1, batch, 0)))
    dets = tester.predict(batch0["images"], batch0["calibs"], batch0["img_sizes"])
    if dets.shape != (batch, 50, 37) or not np.isfinite(dets).all():
        raise RuntimeError(f"slice: detections {dets.shape} not finite [B, 50, 37]")
    del model, tester

    # f32, TF32 off: the same model through the kernels and through the
    # plain versions.  max |a - b| / (1 + |b|) <= 1e-3: each kernel differs
    # from its plain version by summation order (<= ~5e-5 per op), which
    # the layer norms and the inverse-sigmoid refinement may amplify.
    tol = 1e-3
    model = build_monodetr(MONODETR_MODEL, seed=444).to("cuda", torch.float32)
    b2, _ = next(iter(SyntheticLoader(1, 2, 1)))
    inputs = [torch.from_numpy(b2[k]).cuda() for k in ("images", "calibs", "img_sizes")]
    with torch.no_grad():
        got = model(*inputs)
        want = model.use_plain_ops(True)(*inputs)
    torch.cuda.synchronize()
    errs = {k: ((got[k] - want[k]).abs() / (1 + want[k].abs())).max().item()
            for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth")}
    ok = all(e <= tol for e in errs.values()) and all(
        torch.isfinite(got[k]).all().item() for k in errs)
    log(f"slice: f32 forward B=2, kernels vs plain versions: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("slice: the f32 forward through the kernels disagrees")
    return counts


def main():
    phase_environment()
    phase_build()
    report = phase_kernels()
    counts = phase_slice()
    log(json.dumps({"kernels": [
        dict(name=name, route=spec["route"], source=spec["source"],
             replaces=spec["replaces"], launches=counts[name], **report[name])
        for name, spec in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
