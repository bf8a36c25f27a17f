"""Smoke run of monodetr_torch on one CUDA card.

    python3 chip_smoke.py [--decoder-msda-only]

Phases, one line each (or a few), and any failure exits non-zero:
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits 1 when no CUDA device is present;
  2. build the CUDA kernels from monodetr_torch/csrc;
  3. each forward kernel against its plain PyTorch version on the card at
     the slices' shapes, in f32 (TF32 off) and bf16, with both times;
     kernels 2 and 7 at the 50 eval queries and the 550 training queries,
     timed at both;
  4. each training kernel against its plain version: the MSDA backwards
     and the attention forward and backward with dropout (gradients
     against autograd through the plain versions, f32 at B=2 and bf16 at
     B=16; kernels 2 and 7 at 50 and 550 queries, timed at both, with the
     device time of every launch their wrappers make), kernels 2 and 7 at
     32 samples per head and with all 550 queries' samples inside one 16 x
     16 px patch (a line each with that time beside the uniform one), the
     dropout's properties, and the LAP kernel bit-identical to its plain
     version on 528 matching problems, with a second bound beside its bytes
     bound: the longest problem's chain of dependent steps (counted) times
     the cycles assumed for a step whose cost row lies in shared memory;
  5. the eval slice: MonoDETR at the full width of configs/monodetr.yaml,
     seeded random weights, `Tester.inference` over 2 batches of 16
     synthetic 384x1280 images in bf16, launch counters checked; then the
     f32 forward at B=2 against the same model through the plain versions;
  6. the training slice: the same model with f32 parameters, bf16 compute
     and dropout 0.1, 6 train steps at batch 16 on synthetic images and
     targets, launch counters checked per step, ms/step and img/s; then
     one f32 step at B=2 without dropout through the kernels against the
     same step through the plain versions (matches, losses, gradients);
  7. the opt-in configurations, the same model with its deformable
     attention switched: A (msda_impl 'pallas', dec_msda_impl
     'dense_fused': kernels 5 and 7) trains 4 steps and runs one
     `Tester.inference` batch, B (msda_impl 'sepwin': kernel 6) trains 4
     steps, each with its launch counters, ms/step beside the default's,
     and its f32 step against the plain versions.  Phases 3 and 4 hold
     kernels 5-7 against their plain versions, and kernel 7's scatter-free
     value gradient bit-identical from run to run.  Kernels 5 and 6 are
     also held to them at the window's edge (most positions beyond the
     window: kernel 6 clamps them and masks their gradient, kernel 5
     samples them as they are, outside the rectangles its backward stages
     in shared memory), and a line gives that backward's shared-memory
     bytes and blocks per SM.
The kernel report (JSON) sums each kernel's launches over the main-path
runs of phases 5-7 and fails if one of them is 0; it is the second-to-last
line.  Beside each kernel's time and its plain version's it gives the
least time the card could take for the same work at the timed shape
(`bound_ms`: the larger of the bytes it must move over 3.35 TB/s and its
operations over the peak rate of their type, `bound_by` says which; for
kernels 2 and 7 the line's numbers are those at 550 queries, and `q50` holds
the same at 50; `device_ms` the device time of each launch of a backward)
and, for attention, the time of F.scaled_dot_product_attention at the same
shapes and dropout (`library_ms`, a yardstick the port never calls; null
for the kernels that no single PyTorch call computes).  Attention is also
timed, with the library, at the other dropout rate (forward at 0.1,
backward at 0), which gives dropout's share of its time.  The last line is
{"ok": true, "device": {...}}.

With --decoder-msda-only the run is phases 1 and 2 and what phases 3 and 4
do for kernels 2 and 7, and prints neither report nor last line: under a
minute for those kernels' times, e.g. of two checkouts one after the other
on one card (the wrappers it calls are `ms_deform_attn_sep`,
`ms_deform_attn_dense_fused` and their `_bwd`).
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from monodetr_torch import _build  # noqa: E402
from monodetr_torch.ops.attention import (  # noqa: E402
    attention_keep_mask, attention_plain, fused_attention, fused_attention_bwd)
from monodetr_torch.ops.lap import lap_solve, lap_solve_plain  # noqa: E402
from monodetr_torch.models.transformer import encoder_reference_points  # noqa: E402
from monodetr_torch.ops.msda import ms_deform_attn  # noqa: E402
from monodetr_torch.ops.msda_dense import (  # noqa: E402
    ms_deform_attn_dense, ms_deform_attn_dense_fused, ms_deform_attn_dense_fused_bwd)
from monodetr_torch.ops.msda_enc import (  # noqa: E402
    ms_deform_attn_enc_fused, ms_deform_attn_enc_fused_bwd, ms_deform_attn_enc_fused_plain,
    window_limit)
from monodetr_torch.ops.msda_pallas import (  # noqa: E402
    ms_deform_attn_pallas_packed, ms_deform_attn_pallas_packed_bwd,
    ms_deform_attn_pallas_packed_plain, pack, to_lanes)
from monodetr_torch.ops.msda_sep import ms_deform_attn_sep, ms_deform_attn_sep_bwd  # noqa: E402
from monodetr_torch.ops.msda_sepwin import (  # noqa: E402
    ms_deform_attn_sepwin, ms_deform_attn_sepwin_bwd)
from monodetr_torch.ops.msda_windowed import (  # noqa: E402
    WIN_HEADS, backward_occupancy, ms_deform_attn_windowed, window_bounds, window_tiles)
from monodetr_torch.train.synthetic import SyntheticLoader  # noqa: E402

LEVELS = ((48, 160), (24, 80), (12, 40), (6, 20))  # 384x1280 / 8, 16, 32, 64
S = sum(h * w for h, w in LEVELS)
H, D, L, P, G = 8, 32, 4, 4, 6
DEPTH_TOKENS = 24 * 80
TRAIN_QUERIES = 550
# max |kernel - plain| allowed.  f32: both sum in f32 in another order, and
# the plain MSDA re-normalises pixel positions for grid_sample (~1e-5 px at
# widths up to 160); bf16: the output is rounded to bf16 (2^-8 relative)
# at values of order 1.
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# gradients, max |a - b| / (1 + max |b|): f32 sums by atomics in another
# order; bf16 rounds every input and output to 2^-8 relative
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): bytes/s of
# device memory, f32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s
HBM_BYTES_S, F32_FLOPS, BF16_TC_FLOPS = 3.35e12, 67e12, 989e12
# the least f32 operations per (query, head, sample, channel) of the MSDA
# functions: forward the 4 corner multiply-adds; backward the 4 dot products
# of the output gradient with the corner values (the weight and both
# position gradients follow per sample from those 4 sums) and the 4
# multiply-adds of the value gradient
MSDA_FLOPS = {"fwd": 8, "bwd": 16}
# the LAP function's second bound: cycles ASSUMED (not measured on this
# card) for one step of a sequential solver's chain at its best, the cost
# rows in shared memory: a row's load (~30), the update of a lane's two
# columns (~40), and the argmin's 5 dependent shuffles, each with its compare
# and select (~35), at the H100 SXM's 1.755 GHz boost clock
LAP_ROW_CYCLES, LAP_UPDATE_CYCLES, LAP_ARGMIN_CYCLES = 30, 40, 5 * 35
LAP_STEP_CYCLES = LAP_ROW_CYCLES + LAP_UPDATE_CYCLES + LAP_ARGMIN_CYCLES
SM_CLOCK_HZ = 1.755e9

KERNELS = {
    "msda_enc_fused": dict(
        fn=ms_deform_attn_enc_fused, route="cuda", source="monodetr_torch/csrc/msda.cu",
        replaces="monodetr_tpu/ops/msda_enc_pallas.py:653"),
    "msda_enc_fused_bwd": dict(
        fn=ms_deform_attn_enc_fused_bwd, route="cuda", source="monodetr_torch/csrc/msda.cu",
        replaces="monodetr_tpu/ops/msda_enc_pallas.py:597"),
    "msda_sep": dict(
        fn=ms_deform_attn_sep, route="cuda", source="monodetr_torch/csrc/msda_loc.cu",
        replaces="monodetr_tpu/ops/msda_sep_pallas.py:337"),
    "msda_sep_bwd": dict(
        fn=ms_deform_attn_sep_bwd, route="cuda", source="monodetr_torch/csrc/msda_loc.cu",
        replaces="monodetr_tpu/ops/msda_sep_pallas.py:290"),
    "attention_fwd": dict(
        fn=fused_attention, route="cuda", source="monodetr_torch/csrc/attention.cu",
        replaces="monodetr_tpu/ops/attention_pallas.py:162"),
    "attention_bwd": dict(
        fn=fused_attention_bwd, route="cuda", source="monodetr_torch/csrc/attention.cu",
        replaces="monodetr_tpu/ops/attention_pallas.py:222"),
    "lap": dict(
        fn=lap_solve, route="cuda", source="monodetr_torch/csrc/lap.cu",
        replaces="monodetr_tpu/ops/lap_pallas.py:148"),
    "msda_pallas": dict(
        fn=ms_deform_attn_pallas_packed, route="cuda", source="monodetr_torch/csrc/msda_win.cu",
        replaces="monodetr_tpu/ops/msda_pallas.py:675"),
    "msda_pallas_bwd": dict(
        fn=ms_deform_attn_pallas_packed_bwd, route="cuda",
        source="monodetr_torch/csrc/msda_win.cu", replaces="monodetr_tpu/ops/msda_pallas.py:578"),
    "msda_sepwin": dict(
        fn=ms_deform_attn_sepwin, route="cuda", source="monodetr_torch/csrc/msda_win.cu",
        replaces="monodetr_tpu/ops/msda_sepwin_pallas.py:524"),
    "msda_sepwin_bwd": dict(
        fn=ms_deform_attn_sepwin_bwd, route="cuda", source="monodetr_torch/csrc/msda_win.cu",
        replaces="monodetr_tpu/ops/msda_sepwin_pallas.py:458"),
    "msda_dense_fused": dict(
        fn=ms_deform_attn_dense_fused, route="cuda", source="monodetr_torch/csrc/msda_loc.cu",
        replaces="monodetr_tpu/ops/msda_dense_pallas.py:310"),
    "msda_dense_fused_bwd": dict(
        fn=ms_deform_attn_dense_fused_bwd, route="cuda",
        source="monodetr_torch/csrc/msda_loc.cu",
        replaces="monodetr_tpu/ops/msda_dense_pallas.py:265"),
}
# the opt-in configurations: overrides of configs/monodetr.yaml's model
CONFIG_A = {"msda_impl": "pallas", "dec_msda_impl": "dense_fused"}
CONFIG_B = {"msda_impl": "sepwin", "dec_msda_impl": "sep"}


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, flops, flops_per_s):
    """(ms, 'bytes' or 'operations'): the least time for the work, the larger
    of its bytes over the memory rate and its operations over their peak."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_S
    t_ops = 1e3 * flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def msda_bound(direction, tensors, B, Q, lp=L * P):
    """MSDA: every input read once and every output written once, and the
    f32 operations of B * Q query rows x H heads x lp samples x D channels."""
    return bound(nbytes(*tensors), MSDA_FLOPS[direction] * B * Q * H * lp * D, F32_FLOPS)


def attention_bound(direction, q, k, bytes_moved):
    """Attention: its products on the bf16 tensor cores, 2 B H Tq Tk D
    operations each (forward Q K^T and P V; backward those and dP, dQ, dK,
    dV: five), and the given bytes."""
    B, Hh, Tq, Dd = q.shape
    n = {"fwd": 2, "bwd": 5}[direction]
    return bound(bytes_moved, 2 * n * B * Hh * Tq * k.shape[2] * Dd, BF16_TC_FLOPS)


def reset_launches():
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def read_launches():
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


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


def randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def enc_offsets(gen, B):
    """Offsets at odd multiples of 1/32 px, some beyond the window: with the
    grid centres at multiples of 1/16 px, no sample sits within 0.01 px of
    an integer position, where the plain version's re-normalised position
    may land on the other side of the one-sided bilinear derivative."""
    lim = window_limit(G)
    off = (torch.rand(B, S, 2 * H * L * P, generator=gen, device="cuda") * 2 - 1) * (lim + 1)
    return (torch.floor(off * 16) * 2 + 1) / 32


def sep_locations(gen, B, Q):
    """Normalised locations whose pixel positions are >= 0.1 px from any
    integer (see enc_offsets), some outside the level."""
    wh = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device="cuda")
    u = torch.rand(B, Q, H, L, P, 2, generator=gen, device="cuda")
    px = torch.floor(u * (wh[:, None] + 2) - 2) + 0.5 + (u * 997 % 1 - 0.5) * 0.8
    return (px + 0.5) / wh[:, None]


def window_locations(gen, B):
    """Normalised locations [B, S, H, L, P, 2] of the encoder's grid
    queries at offsets of odd multiples of 1/32 px, some up to 1 px beyond
    the window (clamped): off integer positions (see enc_offsets) and
    >= 0.02 px from the clamp bound, where the kernels' strict mask and the
    plain version's clamp gradient may differ."""
    lim = window_limit(G)
    wh = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device="cuda")
    grid = torch.from_numpy(encoder_reference_points(LEVELS)).cuda()[None, :, None, None, None]
    off = (torch.rand(B, S, H, L, P, 2, generator=gen, device="cuda") * 2 - 1) * (lim + 1)
    return grid + (torch.floor(off * 16) * 2 + 1) / 32 / wh[:, None]


def edge_locations(gen, B):
    """As window_locations, out to 3 px beyond the window on either side:
    about 3 positions in 5 lie beyond it."""
    lim = window_limit(G)
    wh = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device="cuda")
    grid = torch.from_numpy(encoder_reference_points(LEVELS)).cuda()[None, :, None, None, None]
    off = (torch.rand(B, S, H, L, P, 2, generator=gen, device="cuda") * 2 - 1) * (lim + 3)
    return grid + (torch.floor(off * 16) * 2 + 1) / 32 / wh[:, None]


def weights(gen, B, Q):
    return torch.softmax(randn(gen, B, Q, H, L * P), -1).view(B, Q, H, L, P)


def forward_inputs(name, B, dtype, gen, q=50):
    """Inputs at the slices' shapes, made on the card from a generator."""
    if name == "msda_enc_fused":
        return (randn(gen, B, S, H, D).to(dtype), LEVELS, enc_offsets(gen, B).to(dtype),
                randn(gen, B, S, H * L * P, scale=2.0).to(dtype), G)
    if name in ("msda_sep", "msda_dense_fused"):
        return (randn(gen, B, S, H, D).to(dtype), LEVELS, sep_locations(gen, B, q),
                weights(gen, B, q))
    if name in ("msda_pallas", "msda_sepwin"):
        value, loc, att = randn(gen, B, S, H, D).to(dtype), window_locations(gen, B), weights(gen, B, S)
        if name == "msda_sepwin":
            return (value, LEVELS, loc, att, G)
        return (value, LEVELS, *pack(LEVELS, loc, att, G), G)
    q, k, v = (randn(gen, B, H, DEPTH_TOKENS, D).to(dtype) for _ in range(3))
    return (q, k, v, 0, D ** -0.5, 0.0)


def forward_plain(name):
    return {
        "msda_enc_fused": ms_deform_attn_enc_fused_plain,
        "msda_sep": ms_deform_attn,
        "attention_fwd": lambda q, k, v, seed, scale, p: attention_plain(q, k, v, scale),
        "msda_pallas": ms_deform_attn_pallas_packed_plain,
        "msda_sepwin": ms_deform_attn_windowed,
        "msda_dense_fused": ms_deform_attn_dense,
    }[name]


LOC_KERNELS = ("msda_sep", "msda_sep_bwd", "msda_dense_fused", "msda_dense_fused_bwd")


FORWARD_KERNELS = ("msda_enc_fused", "msda_sep", "attention_fwd", "msda_pallas", "msda_sepwin",
                   "msda_dense_fused")
BACKWARD_KERNELS = ("msda_enc_fused_bwd", "msda_sep_bwd", "attention_bwd", "msda_pallas_bwd",
                    "msda_sepwin_bwd", "msda_dense_fused_bwd")


def phase_forward_kernels(names=FORWARD_KERNELS):
    """Each forward kernel against its plain version in f32 and bf16 at B=2
    and in bf16 at the batch of 16, where both are also timed; kernels 2 and
    7 at the 50 eval queries and at the 550 training queries, timed at
    both (the report's times are those at 550, the others under `q50`)."""
    report = {}
    cases = [(torch.float32, 2, 50), (torch.bfloat16, 2, 50), (torch.bfloat16, 16, 50)]
    for name in names:
        fn = KERNELS[name]["fn"]
        gen = torch.Generator(device="cuda").manual_seed(0)
        errs, timed = [], {}
        extra = [(torch.float32, 2, TRAIN_QUERIES), (torch.bfloat16, 16, TRAIN_QUERIES)]
        for dtype, B, q in cases + (extra if name in LOC_KERNELS else []):
            args = forward_inputs(name, B, dtype, gen, q)
            got = fn(*args)
            want = forward_plain(name)(*args)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise RuntimeError(f"{name}: {got.shape}/{got.dtype} vs "
                                   f"{want.shape}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            errs.append(err)
            ok = err <= TOL[dtype] and torch.isfinite(got).all().item()
            tag = f"{str(dtype).replace('torch.', '')} B={B}" + (
                f" Q={q}" if name in LOC_KERNELS else "")
            log(f"kernel {name} {tag}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} {tag} disagrees with its plain version")
            if B != 16:
                continue
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: forward_plain(name)(*args))
            tensors = [a for a in args if isinstance(a, torch.Tensor)] + [got]
            library_ms = None
            if name == "attention_fwd":
                q_, k, v, _, scale, p = args
                # q, k, v, o and the f32 log-sum-exp the kernel writes for the backward
                bound_ms, bound_by = attention_bound(
                    "fwd", q_, k, nbytes(*tensors) + q_[..., 0].numel() * 4)
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q_, k, v, dropout_p=p, scale=scale))
                # dropout's share of the time: the same call at p = 0.1
                seed = torch.tensor(0, device="cuda")
                drop_ms = cuda_ms(lambda: fn(q_, k, v, seed, scale, 0.1))
                drop_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q_, k, v, dropout_p=0.1, scale=scale))
                log(f"kernel attention_fwd {tag} 1920x1920 dropout 0.1: {drop_ms:.3f} ms, "
                    f"F.scaled_dot_product_attention {drop_lib_ms:.3f} ms")
            else:
                bound_ms, bound_by = msda_bound("fwd", tensors, B, got.shape[1])
            log(f"kernel {name} {tag}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})"
                + (f", F.scaled_dot_product_attention {library_ms:.3f} ms"
                   if library_ms is not None else ""))
            timed[q] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
            if name in LOC_KERNELS:  # the host's share of so short a call is large
                parts = device_ms_by_launch(lambda: fn(*args))
                log(f"kernel {name} {tag} on the card: {by_launch(parts)}")
                timed[q]["device_ms"] = parts
        report[name] = dict(max_abs_err=max(errs), **timed[q])
        if name in LOC_KERNELS:
            report[name]["q50"] = timed[50]
    return report


def check_grads(name, tag, dtype, got, want):
    """Largest absolute and relative gradient errors; raises past GRAD_TOL."""
    torch.cuda.synchronize()
    abs_err = rel = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"{name} {tag}: gradient {tuple(a.shape)} not finite "
                               f"or not {tuple(b.shape)}")
        e = (a.float() - b.float()).abs().max().item()
        abs_err = max(abs_err, e)
        rel = max(rel, e / (1 + b.float().abs().max().item()))
    ok = rel <= GRAD_TOL[dtype]
    log(f"kernel {name} {tag}: gradients max|a-b|/(1+max|b|) {rel:.3e} "
        f"(tol {GRAD_TOL[dtype]:.0e}), max_abs_err {abs_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} {tag}: gradients disagree with the plain version")
    return abs_err


def backward_case(name, B, dtype, gen, q=TRAIN_QUERIES):
    """(kernel backward as a function of gout, plain forward as a function
    of the differentiable inputs, those inputs, gout) at the training
    shapes; the attention case runs with dropout 0.1 and the kernels'
    keep mask given to the plain version."""
    if name in ("msda_pallas_bwd", "msda_sepwin_bwd"):
        value, loc, att = randn(gen, B, S, H, D).to(dtype), window_locations(gen, B), weights(gen, B, S)
        gout = randn(gen, B, S, H * D).to(dtype)
        if name == "msda_sepwin_bwd":
            return (lambda g: ms_deform_attn_sepwin_bwd(value, LEVELS, loc, att, g, G),
                    lambda v, lc, a: ms_deform_attn_windowed(v, LEVELS, lc, a, G),
                    (value, loc, att), gout)
        fx, fy, lanes = pack(LEVELS, loc, att, G)
        return (lambda g: ms_deform_attn_pallas_packed_bwd(value, LEVELS, fx, fy, lanes, g, G),
                lambda v, x, y, a: ms_deform_attn_pallas_packed_plain(v, LEVELS, x, y, a),
                (value, fx, fy, lanes), gout)
    if name == "msda_dense_fused_bwd":
        value, loc, att = randn(gen, B, S, H, D).to(dtype), sep_locations(gen, B, q), weights(gen, B, q)
        gout = randn(gen, B, q, H * D).to(dtype)
        return (lambda g: ms_deform_attn_dense_fused_bwd(value, LEVELS, loc, att, g),
                lambda v, lc, a: ms_deform_attn_dense(v, LEVELS, lc, a), (value, loc, att), gout)
    if name == "msda_enc_fused_bwd":
        value = randn(gen, B, S, H, D).to(dtype)
        off = enc_offsets(gen, B).to(dtype)
        logits = randn(gen, B, S, H * L * P, scale=2.0).to(dtype)
        gout = randn(gen, B, S, H * D).to(dtype)
        return (lambda g: ms_deform_attn_enc_fused_bwd(value, LEVELS, off, logits, g, G),
                lambda v, o, lg: ms_deform_attn_enc_fused_plain(v, LEVELS, o, lg, G),
                (value, off, logits), gout)
    if name == "msda_sep_bwd":
        value = randn(gen, B, S, H, D).to(dtype)
        loc, att = sep_locations(gen, B, q), weights(gen, B, q)
        gout = randn(gen, B, q, H * D).to(dtype)
        return (lambda g: ms_deform_attn_sep_bwd(value, LEVELS, loc, att, g),
                lambda v, lc, a: ms_deform_attn(v, LEVELS, lc, a), (value, loc, att), gout)
    q = randn(gen, B, H, TRAIN_QUERIES, D).to(dtype)
    k, v = (randn(gen, B, H, DEPTH_TOKENS, D).to(dtype) for _ in range(2))
    gout = randn(gen, B, H, TRAIN_QUERIES, D).to(dtype)
    p, seed = 0.1, torch.tensor(17, device="cuda")
    keep = attention_keep_mask(tuple(q.shape[:3]) + (DEPTH_TOKENS,), seed, p, "cuda")
    with torch.no_grad():
        out = fused_attention(q, k, v, seed, D ** -0.5, p)
    want = attention_plain(q, k, v, D ** -0.5, keep, p)
    fwd_err = (out.float() - want.float()).abs().max().item()
    log(f"kernel attention_fwd dropout 0.1 with the kernels' mask "
        f"{str(dtype).replace('torch.', '')} B={B} 550x1920: max_abs_err {fwd_err:.3e} "
        f"(tol {TOL[dtype]:.0e}) {'ok' if fwd_err <= TOL[dtype] else 'FAIL'}")
    if not fwd_err <= TOL[dtype]:
        raise RuntimeError("attention_fwd with dropout disagrees with its plain version")
    # the forward's lse, as the autograd function keeps it
    lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5, -1)
    return (lambda g: fused_attention_bwd(q, k, v, out, lse, g, seed, D ** -0.5, p),
            lambda q_, k_, v_: attention_plain(q_, k_, v_, D ** -0.5, keep, p), (q, k, v), gout)


def device_ms_by_launch(fn, iters=10):
    """{kernel or memory operation: device ms per call of fn()}, from
    torch.profiler over `iters` calls: what each launch of a wrapper that
    makes several costs on the card, without the host's share.  The
    profiler now and then returns a trace without device events: three
    tries, then None (these times are a reading, no check, so the run goes
    on and says "not measured")."""
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("<")[0].split("(")[0].split("::")[-1].strip() or e.name
                out[name] = out.get(name, 0.0) + e.device_time_total / 1000.0 / iters
        if out:
            return out
    return None


def by_launch(parts):
    if parts is None:
        return "not measured (torch.profiler recorded no device activity)"
    return ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())


def phase_backward_kernels(names=BACKWARD_KERNELS):
    """The backward kernels (attention with dropout) against autograd
    through the plain versions, f32 at B=2 and bf16 at 16; times at 16.
    Kernels 2 and 7 at the 50 eval queries and the 550 training queries,
    timed at both, with the device time of each launch they make (kernel
    2: the zeroing, the kernel, the cast; kernel 7: the query side, the
    binning, the value side); kernel 7's value gradient, summed with no
    atomics, the same bits in two runs at either."""
    report = {}
    for name in names:
        gen = torch.Generator(device="cuda").manual_seed(1)
        errs, timed = [], {}
        cases = [(torch.float32, 2, TRAIN_QUERIES), (torch.bfloat16, 16, TRAIN_QUERIES)]
        if name in LOC_KERNELS:
            cases = [(torch.float32, 2, 50), (torch.bfloat16, 16, 50)] + cases
        for dtype, B, q in cases:
            kernel, plain, inputs, gout = backward_case(name, B, dtype, gen, q)
            got = kernel(gout)
            xs = [x.detach().requires_grad_(True) for x in inputs]
            out = plain(*xs)
            want = torch.autograd.grad(out, xs, gout, retain_graph=True)
            tag = f"{str(dtype).replace('torch.', '')} B={B}" + (
                f" Q={q}" if name in LOC_KERNELS else "")
            errs.append(check_grads(name, tag, dtype, got, want))
            if name == "msda_dense_fused_bwd":
                same = torch.equal(got[0], kernel(gout)[0])
                log(f"kernel {name} {tag}: dvalue bit-identical in a second run {same} "
                    f"{'ok' if same else 'FAIL'}")
                if not same:
                    raise RuntimeError(f"{name}: dvalue differs from run to run")
            if B != 16:
                continue
            ms = cuda_ms(lambda: kernel(gout), iters=10)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, gout, retain_graph=True),
                               iters=10)
            library_ms = None
            if name == "attention_bwd":
                q_, k = inputs[:2]
                # q, k, v, dO, dq, dk, dv, o, and lse and delta (f32 [B, H, Tq]):
                # lse read, delta written and read
                bound_ms, bound_by = attention_bound(
                    "bwd", q_, k, nbytes(*inputs, gout, *got, q_) + 3 * q_[..., 0].numel() * 4)

                def sdpa():
                    return F.scaled_dot_product_attention(*xs, dropout_p=0.1, scale=D ** -0.5)

                library_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa(), xs, gout), iters=10)
                              - cuda_ms(sdpa, iters=10))
                # dropout's share of the time: the same backward at p = 0
                scale = D ** -0.5
                with torch.no_grad():
                    out0 = fused_attention(q_, k, inputs[2], 0, scale, 0.0)
                lse = torch.logsumexp(
                    torch.matmul(q_.float(), k.float().transpose(-1, -2)) * scale, -1)
                nodrop_ms = cuda_ms(lambda: fused_attention_bwd(
                    q_, k, inputs[2], out0, lse, gout, 0, scale, 0.0), iters=10)

                def sdpa0():
                    return F.scaled_dot_product_attention(*xs, scale=scale)

                nodrop_lib_ms = (cuda_ms(lambda: torch.autograd.grad(sdpa0(), xs, gout), iters=10)
                                 - cuda_ms(sdpa0, iters=10))
                log(f"kernel attention_bwd {tag} 550x1920 dropout 0: {nodrop_ms:.3f} ms, "
                    f"F.scaled_dot_product_attention forward+backward minus forward "
                    f"{nodrop_lib_ms:.3f} ms")
                del out0, lse
            else:
                bound_ms, bound_by = msda_bound("bwd", [*inputs, gout, *got], B, gout.shape[1])
            log(f"kernel {name} {tag}: {ms:.3f} ms, plain (autograd backward) {plain_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})"
                + (f", F.scaled_dot_product_attention forward+backward minus forward "
                   f"{library_ms:.3f} ms" if library_ms is not None else ""))
            timed[q] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
            if name in LOC_KERNELS:
                parts = device_ms_by_launch(lambda: kernel(gout))
                log(f"kernel {name} {tag} on the card, by launch: {by_launch(parts)}")
                timed[q]["device_ms"] = parts
        report[name] = dict(max_abs_err=max(errs), **timed[q])
        if name in LOC_KERNELS:
            report[name]["q50"] = timed[50]
        del kernel, plain, inputs, gout, got, xs, out, want
    return report


def clustered_locations(gen, B, Q):
    """Normalised locations all inside one 16 x 16 px patch of level 0
    (pixels 64-80 across, 16-32 down; 8 x 8, 4 x 4 and 2 x 2 px of levels
    1-3), off integer positions as sep_locations'."""
    w0, h0 = LEVELS[0][1], LEVELS[0][0]
    u = torch.rand(B, Q, H, L, P, 2, generator=gen, device="cuda")
    px = torch.floor(u * 16) + 0.5 + (u * 997 % 1 - 0.5) * 0.8  # in the patch, level 0 px
    origin = torch.tensor([64.0, 16.0], device="cuda")
    return (origin + px) / torch.tensor([float(w0), float(h0)], device="cuda")


def phase_loc_extras():
    """Kernels 2 and 7 beyond the slices' shapes.  (1) 32 samples per head
    (L=4, P=8), both directions, f32 at B=2 against the plain version.
    (2) The backward with every sample of all 550 queries inside one 16 x
    16 px patch of level 0, where trained queries cluster: against the
    plain version (f32 B=2, bf16 B=16), timed at B=16 beside the same
    shapes' uniform locations: what contention costs kernel 2's atomics
    and kernel 7's lists."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    wh = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device="cuda")
    B, q, p8 = 2, 50, 8
    value = randn(gen, B, S, H, D)
    u = torch.rand(B, q, H, L, p8, 2, generator=gen, device="cuda")
    px = torch.floor(u * (wh[:, None] + 2) - 2) + 0.5 + (u * 997 % 1 - 0.5) * 0.8
    loc = (px + 0.5) / wh[:, None]
    att = torch.softmax(randn(gen, B, q, H, L * p8), -1).view(B, q, H, L, p8)
    gout = randn(gen, B, q, H * D)
    xs = [x.detach().requires_grad_(True) for x in (value, loc, att)]
    want = ms_deform_attn(xs[0], LEVELS, xs[1], xs[2])
    grads = torch.autograd.grad(want, xs, gout)
    for name, fwd, bwd in (("msda_sep", ms_deform_attn_sep, ms_deform_attn_sep_bwd),
                           ("msda_dense_fused", ms_deform_attn_dense_fused,
                            ms_deform_attn_dense_fused_bwd)):
        got = fwd(value, LEVELS, loc, att)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = err <= TOL[torch.float32] and torch.isfinite(got).all().item()
        log(f"kernel {name} float32 B={B} Q={q} L*P=32: max_abs_err {err:.3e} "
            f"(tol {TOL[torch.float32]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{name} at 32 samples per head disagrees with its plain version")
        check_grads(f"{name}_bwd", f"float32 B={B} Q={q} L*P=32", torch.float32,
                    bwd(value, LEVELS, loc, att, gout), grads)
    del xs, want, grads
    for dtype, B in ((torch.float32, 2), (torch.bfloat16, 16)):
        value = randn(gen, B, S, H, D).to(dtype)
        att = weights(gen, B, TRAIN_QUERIES)
        gout = randn(gen, B, TRAIN_QUERIES, H * D).to(dtype)
        near = clustered_locations(gen, B, TRAIN_QUERIES)
        even = sep_locations(gen, B, TRAIN_QUERIES)
        xs = [x.detach().requires_grad_(True) for x in (value, near, att)]
        want = torch.autograd.grad(ms_deform_attn(xs[0], LEVELS, xs[1], xs[2]), xs, gout)
        tag = f"{str(dtype).replace('torch.', '')} B={B} Q={TRAIN_QUERIES} in one 16x16 px patch"
        for name, bwd in (("msda_sep_bwd", ms_deform_attn_sep_bwd),
                          ("msda_dense_fused_bwd", ms_deform_attn_dense_fused_bwd)):
            check_grads(name, tag, dtype, bwd(value, LEVELS, near, att, gout), want)
            if B == 16:
                ms = cuda_ms(lambda: bwd(value, LEVELS, near, att, gout), iters=10)
                even_ms = cuda_ms(lambda: bwd(value, LEVELS, even, att, gout), iters=10)
                parts = device_ms_by_launch(lambda: bwd(value, LEVELS, near, att, gout))
                log(f"kernel {name} {tag}: {ms:.3f} ms, uniform locations {even_ms:.3f} ms; "
                    f"on the card, by launch: {by_launch(parts)}")
        del xs, want


def phase_window_edges():
    """Kernels 5 and 6 at the window's edge, forward and backward against
    their plain versions, f32 at B=2 and bf16 at B=16: kernel 6 from
    locations of which most lie beyond the window (the clamp and the dloc
    mask), kernel 5 at those positions unclamped (exact beyond the window,
    where its value gradient goes to device memory directly).  Then the
    backward's shared memory and blocks per SM, as the runtime reports."""
    wh = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device="cuda")
    for dtype, B in ((torch.float32, 2), (torch.bfloat16, 16)):
        gen = torch.Generator(device="cuda").manual_seed(4)
        value, loc, att = randn(gen, B, S, H, D).to(dtype), edge_locations(gen, B), weights(gen, B, S)
        gout = randn(gen, B, S, H * D).to(dtype)
        f = loc * wh[:, None] - 0.5
        beyond = ((f - f.clamp(*(x[None, :, None, :, None, :] for x in edge_bounds()))) != 0)
        fx, fy, lanes = (to_lanes(x).contiguous() for x in (f[..., 0], f[..., 1], att))
        tag = f"{str(dtype).replace('torch.', '')} B={B}"
        cases = (
            ("msda_sepwin", lambda: ms_deform_attn_sepwin(value, LEVELS, loc, att, G),
             lambda g: ms_deform_attn_sepwin_bwd(value, LEVELS, loc, att, g, G),
             lambda v, lc, a: ms_deform_attn_windowed(v, LEVELS, lc, a, G), (value, loc, att)),
            ("msda_pallas", lambda: ms_deform_attn_pallas_packed(value, LEVELS, fx, fy, lanes, G),
             lambda g: ms_deform_attn_pallas_packed_bwd(value, LEVELS, fx, fy, lanes, g, G),
             lambda v, x, y, a: ms_deform_attn_pallas_packed_plain(v, LEVELS, x, y, a),
             (value, fx, fy, lanes)))
        for name, forward, backward, plain, inputs in cases:
            xs = [x.detach().requires_grad_(True) for x in inputs]
            want = plain(*xs)
            got = forward()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = err <= TOL[dtype] and torch.isfinite(got).all().item()
            log(f"kernel {name} {tag} at the window's edge ({beyond.float().mean().item():.2f} of "
                f"the positions beyond it): max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} {tag} disagrees with its plain version at the "
                                   f"window's edge")
            grads = backward(gout)
            check_grads(f"{name}_bwd", tag + " at the window's edge", dtype, grads,
                        torch.autograd.grad(want, xs, gout))
            if name == "msda_sepwin":  # dloc passes only inside the window
                masked = (grads[1][beyond] == 0).all().item()
                log(f"kernel msda_sepwin_bwd {tag}: dloc 0 at every clamped position {masked} "
                    f"{'ok' if masked else 'FAIL'}")
                if not masked:
                    raise RuntimeError("msda_sepwin_bwd: a clamped position got a gradient")
            del xs, want, got, grads
    tiles = window_tiles(LEVELS, G)
    shape = {}
    for kernel, name in ((5, "msda_pallas_bwd"), (6, "msda_sepwin_bwd")):
        blocks, smem = backward_occupancy(kernel, torch.bfloat16, LEVELS, G)
        shape[name] = {"smem_bytes": smem, "blocks_per_sm": blocks}
        if smem != tiles.smem_bytes or blocks < 1:
            raise RuntimeError(f"{name}: {smem} bytes of shared memory, {blocks} blocks per SM; "
                               f"the tiling asks for {tiles.smem_bytes}")
    return {"windowed_backward": dict(
        shape, heads_per_block=WIN_HEADS, tile_pixels=list(tiles.side),
        queries_per_tile=tiles.queries, rows_per_head=tiles.rows)}


def edge_bounds():
    """(lo, hi) [S, L, 2] on the card: each grid query's window in every level."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in window_bounds(LEVELS, G))


def phase_dropout():
    """The attention dropout's properties on the card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    scale = D ** -0.5
    q = randn(gen, 2, H, 256, D)
    k, v = randn(gen, 2, H, 384, D), randn(gen, 2, H, 384, D)
    a = fused_attention(q, k, v, 7, scale, 0.1)
    same = torch.equal(a, fused_attention(q, k, v, 7, scale, 0.1))
    differs = not torch.equal(a, fused_attention(q, k, v, 8, scale, 0.1))
    kept = attention_keep_mask((16, H, TRAIN_QUERIES, DEPTH_TOKENS), 5, 0.1, "cuda")
    kept = kept.float().mean().item()
    mean = sum(fused_attention(q, k, v, s, scale, 0.5) for s in range(40)) / 40
    d0 = fused_attention(q, k, v, 0, scale, 0.0)
    bias = ((mean - d0).abs().mean() / d0.abs().mean()).item()
    # out is linear in v: <g, out(v=d)> == <dL/dv, d> iff the backward
    # regenerates the forward's mask
    g, d = randn(gen, *q.shape), randn(gen, *v.shape)
    vv = v.clone().requires_grad_(True)
    (fused_attention(q, k, vv, 7, scale, 0.1) * g).sum().backward()
    lhs = (fused_attention(q, k, d, 7, scale, 0.1) * g).sum().item()
    rhs = (vv.grad * d).sum().item()
    lin = abs(lhs - rhs) / abs(rhs)
    # a central finite difference along a random direction of q, in f32
    qq = q.clone().requires_grad_(True)
    (fused_attention(qq, k, v, 7, scale, 0.1) * g).sum().backward()
    dq = randn(gen, *q.shape)
    eps = 1e-2
    fd = ((fused_attention(q + eps * dq, k, v, 7, scale, 0.1) * g).sum().item()
          - (fused_attention(q - eps * dq, k, v, 7, scale, 0.1) * g).sum().item()) / (2 * eps)
    an = (qq.grad * dq).sum().item()
    fd_err = abs(fd - an) / abs(an)
    ok = (same and differs and abs(kept - 0.9) < 0.005 and bias < 0.35 and lin < 1e-3
          and fd_err < 1e-2)
    log(f"dropout: same seed same output {same}, other seed other output {differs}, "
        f"kept fraction over 16x8x550x1920 {kept:.5f} (0.9 +- 0.005), mean over 40 seeds "
        f"at p=0.5 vs p=0: mean|diff|/mean|out| {bias:.3f} (< 0.35), <g,out(v=d)> vs "
        f"<dv,d> rel {lin:.2e} (< 1e-3), finite difference along q rel {fd_err:.2e} "
        f"(< 1e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("dropout: a property does not hold")


def phase_lap():
    """The LAP kernel on 528 problems (3 layers x 16 images x 11 groups of
    50 queries) from matching costs of random outputs and targets with 0-50
    valid rows, a third of them quantised to 0.25 for ties: bit-identical
    to lap_solve_plain, and as cheap as scipy's assignment."""
    from scipy.optimize import linear_sum_assignment

    from monodetr_torch.models.matcher import BIG_COST, matching_cost

    rng = np.random.RandomState(3)
    Lr, B, Gq, N = 3, 16, 11, 50

    def boxes(*lead):
        return torch.from_numpy(np.concatenate(
            [rng.rand(*lead, 2), rng.rand(*lead, 4) * 0.2 + 0.02], -1).astype(np.float32))

    logits = torch.from_numpy(rng.randn(Lr, B, Gq, N, 3).astype(np.float32) * 2)
    labels = torch.from_numpy(rng.randint(0, 3, (1, B, 1, N)))
    n_valid = rng.randint(0, N + 1, (Lr, B, Gq))
    valid = np.arange(N) < n_valid[..., None]
    cost = matching_cost(logits, boxes(Lr, B, Gq, N), labels, boxes(1, B, 1, N),
                         torch.from_numpy(valid)).transpose(-1, -2)  # [L, B, G, rows, cols]
    ties = torch.from_numpy(rng.rand(Lr, B, Gq) < 0.33)
    cost = torch.where(ties[..., None, None], torch.round(cost * 4) / 4, cost)
    cost = torch.where(torch.from_numpy(valid)[..., None], cost, BIG_COST).contiguous()
    rv = torch.from_numpy(valid)
    cost_d, rv_d = cost.cuda(), rv.cuda()
    got = lap_solve(cost_d, rv_d).cpu()
    steps = torch.zeros(Lr, B, Gq, dtype=torch.int64)
    want = lap_solve_plain(cost, rv, steps)
    same = torch.equal(got, want)
    worse = 0
    c, g = cost.reshape(-1, N, N).numpy(), got.reshape(-1, N).numpy()
    for p, n in enumerate(n_valid.reshape(-1)):
        if n:
            r, cols = linear_sum_assignment(c[p, :n].astype(np.float64))
            worse += not np.isclose(c[p, np.arange(n), g[p, :n]].astype(np.float64).sum(),
                                    c[p, :n][r, cols].astype(np.float64).sum(), rtol=1e-6)
    ms = cuda_ms(lambda: lap_solve(cost_d, rv_d))
    plain_ms = cuda_ms(lambda: lap_solve_plain(cost_d, rv_d), iters=2)
    ok = same and worse == 0
    # the cost rows, validity and assignment once; every valid row's N costs
    # must be compared at least once (f32)
    bound_ms, bound_by = bound(nbytes(cost_d, rv_d, got), 2 * int(n_valid.sum()) * N, F32_FLOPS)
    # what a sequential solver cannot beat: the longest problem's chain.  A
    # card holds all 528 problems at once (a warp each, 4 an SM), so a launch
    # lasts as long as its longest problem: the N rows of the greedy start
    # and then one row per Dijkstra iteration, each step waiting for the last.
    # The count is this run's; the cycles per step are assumed, for rows in
    # shared memory (the kernel reads them from device memory through L2)
    chain = N + int(steps.max())
    chain_ms = 1e3 * chain * LAP_STEP_CYCLES / SM_CLOCK_HZ
    log(f"kernel lap 528 problems of 50x50, {int(ties.sum())} with ties: bit-identical to "
        f"lap_solve_plain {same}, costs above scipy's {worse} {'ok' if ok else 'FAIL'}; "
        f"{ms:.3f} ms, plain (on the card) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    log(f"kernel lap chain bound: {chain_ms:.4f} ms = {chain} dependent steps in the longest "
        f"problem ({N} rows of the greedy start + {int(steps.max())} Dijkstra iterations, counted; "
        f"mean {N + steps.float().mean().item():.1f}) x {LAP_STEP_CYCLES} cycles assumed (a cost "
        f"row from shared memory {LAP_ROW_CYCLES}, the update {LAP_UPDATE_CYCLES}, a 5-step "
        f"shuffle argmin {LAP_ARGMIN_CYCLES}) at {SM_CLOCK_HZ / 1e9:.3f} GHz; {Lr * B * Gq} warps "
        f"over 132 SMs all run at once; the kernel takes {ms / chain_ms:.2f}x that")
    if not ok:
        raise RuntimeError("lap: the kernel disagrees with its plain version or scipy")
    return {"lap": dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None, chain_bound_ms=chain_ms,
                        longest_chain=chain)}


def main_path_counts(per_run, n_runs, label):
    """The launch counts read after a main-path run: fail unless they are
    exactly per_run * n_runs (and 0 for every other kernel)."""
    counts = {k: v for k, v in read_launches().items() if v}
    if counts != {k: v * n_runs for k, v in per_run.items()}:
        raise RuntimeError(f"{label}: launches {counts}, want {per_run} x {n_runs}")
    return counts


def phase_eval_slice(label="eval slice", overrides=None, n_batches=2,
                     per_forward=None, check_plain=True):
    """Tester.inference in bf16 at batch 16 with the launch counts read
    around it; then the f32 forward at B=2, kernels against plain versions."""
    import logging

    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.eval.tester import Tester
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype

    cfg = dict(MONODETR_MODEL, **(overrides or {}))
    batch = 16
    model = build_monodetr(cfg, seed=444).to("cuda", compute_dtype(cfg))
    logging.basicConfig(level=logging.WARNING)
    # threshold 0: random weights score every pick near the 0.01 class
    # prior, and the decode of all 50 picks per image is what is checked
    tester = Tester({"threshold": 0.0, "topk": 50}, model, SyntheticLoader(n_batches, batch, 0),
                    logging.getLogger("chip_smoke"), {"save_path": "outputs/"}, "chip_smoke")
    per_forward = per_forward or {"msda_enc_fused": 3, "msda_sep": 3, "attention_fwd": 1}
    reset_launches()
    results = tester.inference()
    torch.cuda.synchronize()
    counts = main_path_counts(per_forward, n_batches, label)
    rows = [r for preds in results.values() for r in preds]
    ok = (len(results) == n_batches * batch and len(rows) == n_batches * batch * 50
          and np.isfinite(np.asarray(rows, np.float64)).all()
          and all(len(r) == 14 for r in rows))
    txts = len(os.listdir(tester.results_dir))
    log(f"{label}: Tester.inference bf16 {n_batches} x {batch} images 384x1280: "
        f"{tester.ms_per_img:.2f} ms/img, launches {counts} (want {per_forward} per "
        f"forward), {len(rows)} KITTI rows in {txts} txts {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: wrong decoded rows")
    batch0, _ = next(iter(SyntheticLoader(1, batch, 0)))
    dets = tester.predict(batch0["images"], batch0["calibs"], batch0["img_sizes"])
    if dets.shape != (batch, 50, 37) or not np.isfinite(dets).all():
        raise RuntimeError(f"{label}: detections {dets.shape} not finite [B, 50, 37]")
    del model, tester
    if not check_plain:
        return counts

    # f32, TF32 off: the same model through the kernels and through the
    # plain versions.  max |a - b| / (1 + |b|) <= 1e-3: each kernel differs
    # from its plain version by summation order (<= ~5e-5 per op), which
    # the layer norms and the inverse-sigmoid refinement may amplify.
    tol = 1e-3
    model = build_monodetr(cfg, seed=444).to("cuda", torch.float32)
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
    log(f"{label}: f32 forward B=2, kernels vs plain versions: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the f32 forward through the kernels disagrees")
    return counts


DEFAULT_PER_STEP = {"msda_enc_fused": 3, "msda_enc_fused_bwd": 3, "msda_sep": 3,
                    "msda_sep_bwd": 3, "attention_fwd": 4, "attention_bwd": 4, "lap": 1}


def phase_train_slice(label="train slice", overrides=None, per_step=DEFAULT_PER_STEP,
                      n_steps=6, batch=16):
    """bf16 train steps at batch 16 with dropout 0.1 through the kernels;
    launch counts, finite and moving losses, bf16 kernel inputs, step time."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(MONODETR_MODEL, **(overrides or {}))
    model = build_monodetr(cfg, seed=444).cuda()  # f32 parameters
    opt = build_optimizer({"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, model)
    dtype = compute_dtype(cfg)
    step = make_train_step(model, SetCriterion(cfg), opt, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [batch_to_device(b, "cuda") for b, _ in SyntheticLoader(n_steps, batch, 2)]
    seen = set()
    dtype_code = _build.dtype_code

    def recording(dt):  # every MSDA / attention wrapper passes its dtype here
        seen.add(dt)
        return dtype_code(dt)

    _build.dtype_code = recording
    try:
        torch.cuda.synchronize()
        reset_launches()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
        events[0].record()
        losses = []
        for i, b in enumerate(batches):
            losses.append(step(b, 2e-4, gen))
            events[i + 1].record()
        torch.cuda.synchronize()
        counts = main_path_counts(per_step, n_steps, label)
    finally:
        _build.dtype_code = dtype_code
    values = np.stack([lv.values.cpu().numpy() for lv in losses])
    totals = values[:, losses[0].keys_.index("loss_detr")]
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_steps)]
    steady = float(np.mean(ms[2:]))
    ok = (np.isfinite(values).all() and len(set(totals.tolist())) == n_steps
          and seen == {torch.bfloat16} and len(losses[0].keys_) == 2 + 7 * 3 + 1)
    log(f"{label}: {n_steps} train steps, batch {batch}, 384x1280, bf16 compute, f32 "
        f"parameters and AdamW state, dropout 0.1: loss_detr "
        + " ".join(f"{t:.3f}" for t in totals)
        + f"; launches {counts} (want {per_step} per step); kernel dtypes "
        f"{sorted(str(d) for d in seen)} {'ok' if ok else 'FAIL'}")
    log(f"{label}: ms/step by CUDA events " + " ".join(f"{m:.1f}" for m in ms)
        + f"; steps 3-{n_steps}: {steady:.1f} ms/step, {1000 * batch / steady:.1f} img/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    if not ok:
        raise RuntimeError(f"{label}: wrong losses or kernel dtypes")
    del model, opt, step, batches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return counts, steady


def phase_train_vs_plain(label="train vs plain", overrides=None):
    """One f32 train step at B=2 without dropout through the kernels and
    through the plain versions (LAP included): identical matches, losses
    to 1e-4 relative, every gradient to 1e-3 * max|g_plain| + 1e-6."""
    import monodetr_torch.models.matcher as matcher
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.train_step import TARGET_KEYS, batch_to_device

    cfg = dict(MONODETR_MODEL, dropout=0.0, **(overrides or {}))
    model = build_monodetr(cfg, seed=444).cuda()
    with torch.no_grad():  # encoder samples off integer positions (enc_offsets)
        for layer in model.depthaware_transformer.encoder.layers:
            bias = layer.self_attn.sampling_offsets.bias
            bias.copy_(torch.floor(bias * 16) / 16 + 1 / 32)
    plain = copy.deepcopy(model).use_plain_ops(True)
    crit = SetCriterion(cfg)
    b, _ = next(iter(SyntheticLoader(1, 2, 3)))
    b = batch_to_device(b, "cuda")
    targets = {k: b[k] for k in TARGET_KEYS}
    results = []
    for m, lap in ((model, lap_solve), (plain, lap_solve_plain)):
        matcher.lap_solve = lap
        try:
            out = m(b["images"], b["calibs"], b["img_sizes"], train=True)
            matched = crit.match(out, targets)
            losses = crit(out, targets)
        finally:
            matcher.lap_solve = lap_solve
        crit.total(losses).backward()
        results.append((matched, losses, {n: p.grad for n, p in m.named_parameters()
                                          if p.grad is not None}))
    (m_k, l_k, g_k), (m_p, l_p, g_p) = results
    same = torch.equal(m_k, m_p)
    loss_err = max(abs(l_k[k].item() - l_p[k].item()) / max(abs(l_p[k].item()), 1e-12)
                   for k in l_p)
    worst, worst_name = 0.0, ""
    for n, gp in g_p.items():
        e = ((g_k[n] - gp).abs().max() / (1e-3 * gp.abs().max() + 1e-6)).item()
        if e > worst:
            worst, worst_name = e, n
    ok = same and loss_err <= 1e-4 and worst <= 1.0 and g_k.keys() == g_p.keys()
    log(f"{label}: f32 step B=2, dropout 0: matches identical {same}, losses max rel "
        f"{loss_err:.2e} (tol 1e-4), {len(g_p)} gradients: worst |a-b| / (1e-3 max|b| + 1e-6) "
        f"{worst:.3f} at {worst_name} (<= 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the f32 step through the kernels disagrees")


def main(argv):
    if argv not in ([], ["--decoder-msda-only"]):
        sys.exit(f"usage: python3 chip_smoke.py [--decoder-msda-only], not {argv}")
    phase_environment()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv:
        phase_forward_kernels([n for n in FORWARD_KERNELS if n in LOC_KERNELS])
        phase_backward_kernels([n for n in BACKWARD_KERNELS if n in LOC_KERNELS])
        phase_loc_extras()
        return
    report = phase_forward_kernels()
    report.update(phase_backward_kernels())
    phase_loc_extras()
    windowed_backward = phase_window_edges()
    phase_dropout()
    report.update(phase_lap())
    totals = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    add(phase_eval_slice())
    phase_train_vs_plain()
    counts, default_ms = phase_train_slice()
    add(counts)
    a_step = {"msda_pallas": 3, "msda_pallas_bwd": 3, "msda_dense_fused": 3,
              "msda_dense_fused_bwd": 3, "attention_fwd": 4, "attention_bwd": 4, "lap": 1}
    b_step = {"msda_sepwin": 3, "msda_sepwin_bwd": 3, "msda_sep": 3, "msda_sep_bwd": 3,
              "attention_fwd": 4, "attention_bwd": 4, "lap": 1}
    counts, a_ms = phase_train_slice("config A train", CONFIG_A, a_step, n_steps=4)
    add(counts)
    add(phase_eval_slice("config A eval", CONFIG_A, 1, {"msda_pallas": 3, "msda_dense_fused": 3,
                                                        "attention_fwd": 1}, check_plain=False))
    phase_train_vs_plain("config A train vs plain", CONFIG_A)
    counts, b_ms = phase_train_slice("config B train", CONFIG_B, b_step, n_steps=4)
    add(counts)
    phase_train_vs_plain("config B train vs plain", CONFIG_B)
    log(f"train ms/step, bf16 batch 16, steps 3 on: default (fused + sep) {default_ms:.1f}, "
        f"A (pallas + dense_fused) {a_ms:.1f}, B (sepwin + sep) {b_ms:.1f}")
    idle = [k for k, v in totals.items() if v == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the main path: {idle}")
    log(json.dumps(windowed_backward))
    log(json.dumps({"kernels": [
        dict(name=name, route=spec["route"], source=spec["source"],
             replaces=spec["replaces"], launches=totals[name], **report[name])
        for name, spec in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
