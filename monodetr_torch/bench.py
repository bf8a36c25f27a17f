"""Benchmark: monodetr_torch training throughput (images/sec/chip) on one
CUDA card at the reference recipe's shapes (384x1280, batch 16, 550 grouped
queries, the full criterion and the reference AdamW update in each step);
the twin of bench.py, run as `python bench_torch.py`.

    python bench_torch.py [--device cuda]
    BENCH_BACKBONE=resnet101 BENCH_H=768 BENCH_W=2560 BENCH_BS=2 BENCH_REMAT=1 \\
        python bench_torch.py                               # the stress configuration

The model is the shipped one (config.py:MONODETR_MODEL, full width and
depth) with bench_env()'s overrides, its weights from seed 0; f32
parameters and AdamW state, bf16 compute under autocast, dropout 0.1 drawn
from a torch.Generator on the card seeded 1.  One synthetic batch
(make_batch: bench.py's arrays) is moved to the card once, and every step
trains on it at the constant lr 2e-4.  After 4 warm-up steps, 3 windows of
12 steps are timed (bench.py:173-203), each by a pair of CUDA events with
one synchronisation at its end (`--device cpu`: the host clock), and each
gives B / (ms per step).  It runs on the card unless `--device cpu` is
given; without a CUDA device it raises.

Prints exactly one JSON line on stdout, bench.py's keys in its order less
its vs_baseline:
  {"metric": "train_throughput_{H}x{W}_bs{B}", "value": median img/s,
   "unit": "img/s/chip", "runs": [3 img/s], "flops_per_img": GFLOP,
   "mfu": ...}
Everything else (the card's name and power limit, the configuration, the
peak memory, the seconds the FLOP count took, the last loss) goes to
stderr.

flops_per_img: torch.utils.flop_counter.FlopCounterMode over one training
step at the bench's batch and shapes with every kernel switched to its
plain PyTorch version (MonoDETR.use_plain_ops), after the timed windows.
The counter sees the matrix products and convolutions of the step, forward
and backward (with remat, the recomputed forward too); the CUDA kernels
are invisible to it, so the plain attention's products count as kernel 3's
work, and the deformable attention's bilinear sampling counts nothing, as
XLA's cost analysis counts nothing inside a Pallas call.  At 128x256,
B=2, 2+2 layers it is within 5% of XLA's cost_analysis() of the JAX
package's train step (tests/test_torch_bench.py).  A failed count fails
the bench.

mfu: img/s / B x FLOPs per step / 989.4e12, the dense bf16 tensor-core
peak of one H100 SXM at its 700 W limit (NVIDIA's data sheet).

bench_env() reads bench.py's BENCH_* variables with its defaults, all but
BENCH_RNG: that one picks a TPU dropout generator (rbg or threefry), and
the port draws dropout from a torch.Generator.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import MONODETR_MODEL
from .models.criterion import SetCriterion
from .models.monodetr import build_monodetr
from .train.optimizer import build_optimizer
from .train.train_step import batch_to_device, make_train_step

# dense bf16 tensor-core peak of one H100 SXM at 700 W (NVIDIA's data sheet)
H100_BF16_PEAK_FLOPS = 989.4e12
LR = 2e-4
OPTIMIZER = {"type": "adamw", "lr": LR, "weight_decay": 1e-4}
CRITERION = {"num_classes": 3, "dec_layers": 3, "group_num": 11}
WARMUP_STEPS, WINDOWS, WINDOW_STEPS = 4, 3, 12
KEYS = ("metric", "value", "unit", "runs", "flops_per_img", "mfu")


def bench_env():
    """The BENCH_* overrides, as bench.py:bench_env reads them (less
    BENCH_RNG); the defaults are the shipped configuration."""
    remat = os.environ.get("BENCH_REMAT", "0")  # 0|1|backbone|encoder|all
    remat = {"0": False, "1": True}.get(remat, remat)
    return {
        "batch": int(os.environ.get("BENCH_BS", 16)),
        "height": int(os.environ.get("BENCH_H", 384)),
        "width": int(os.environ.get("BENCH_W", 1280)),
        "model_kwargs": dict(
            remat=remat,
            backbone_name=os.environ.get("BENCH_BACKBONE", "resnet50"),
            msda_impl=os.environ.get("BENCH_MSDA", "fused"),  # fused|pallas|sepwin|windowed|gather
            msda_window=int(os.environ.get("BENCH_WINDOW", 6)),
            dec_msda_impl=os.environ.get("BENCH_DEC_MSDA", "sep"),
        ),
    }


def model_config(env):
    """The shipped model dict with bench_env()'s model_kwargs."""
    kw = env["model_kwargs"]
    return dict(MONODETR_MODEL, remat=kw["remat"], backbone=kw["backbone_name"],
                msda_impl=kw["msda_impl"], msda_window=kw["msda_window"],
                dec_msda_impl=kw["dec_msda_impl"])


def make_batch(B, H, W, T=50):
    """bench.py's batch (bench.py:92-120) as numpy arrays: the same draws
    from RandomState(0) in the same order, with the same dtypes (labels 0-1,
    a mask that is not a prefix)."""
    rng = np.random.RandomState(0)
    calib = np.array([[721.54, 0.0, 609.56, 44.86],
                      [0.0, 721.54, 172.85, 0.22],
                      [0.0, 0.0, 1.0, 0.003]], np.float32)
    return {
        "images": rng.randn(B, H, W, 3).astype(np.float32),
        "calibs": np.tile(calib[None], (B, 1, 1)),
        "img_sizes": np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1)),
        "labels": rng.randint(0, 2, (B, T)).astype(np.int32),
        "boxes": np.concatenate(
            [rng.rand(B, T, 2) * 0.8 + 0.1, rng.rand(B, T, 2) * 0.15 + 0.02], -1
        ).astype(np.float32),
        "boxes_3d": np.concatenate(
            [rng.rand(B, T, 2), rng.rand(B, T, 4) * 0.1 + 0.02], -1).astype(np.float32),
        "depth": (rng.rand(B, T, 1) * 50 + 5).astype(np.float32),
        "size_3d": (rng.rand(B, T, 3) + 0.8).astype(np.float32),
        "heading_bin": rng.randint(0, 12, (B, T, 1)).astype(np.int32),
        "heading_res": (rng.randn(B, T, 1) * 0.2).astype(np.float32),
        "mask": rng.rand(B, T) > 0.7,
    }


def count_flops(model, step, batch, gen=None):
    """FLOPs of one call step(batch, LR, gen) through the plain versions of
    the kernels, as torch.utils.flop_counter.FlopCounterMode counts them
    (matrix products, convolutions, forward and backward).  The step trains
    the model; the kernels are switched back on afterwards."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    model.use_plain_ops(True)
    try:
        with counter:
            step(batch, LR, gen)
    finally:
        model.use_plain_ops(False)
    flops = counter.get_total_flops()
    if flops <= 0:
        raise RuntimeError("FlopCounterMode counted no operations in the step")
    return flops


def timed_windows(step, batch, gen, B, device):
    """img/s of WINDOWS windows of WINDOW_STEPS steps after WARMUP_STEPS
    steps: CUDA events around each window on a card, with one
    synchronisation at its end; the host clock on the CPU.  Returns (rates,
    the last losses)."""
    for _ in range(WARMUP_STEPS):
        losses = step(batch, LR, gen)
    rates = []
    for _ in range(WINDOWS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(WINDOW_STEPS):
                losses = step(batch, LR, gen)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / WINDOW_STEPS
        else:
            t0 = time.perf_counter()
            for _ in range(WINDOW_STEPS):
                losses = step(batch, LR, gen)
            ms = (time.perf_counter() - t0) * 1e3 / WINDOW_STEPS
        rates.append(B / (ms / 1e3))
    return rates, losses


def card_line():
    """nvidia-smi's `name, power.limit` of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def result_line(H, W, B, runs, flops_per_step):
    """bench.py's JSON line (bench.py:158-170) less vs_baseline, as a dict,
    in its key order."""
    img_per_sec = float(np.median(runs))
    mfu = img_per_sec / B * flops_per_step / H100_BF16_PEAK_FLOPS
    return {
        "metric": f"train_throughput_{H}x{W}_bs{B}",
        "value": round(img_per_sec, 2),
        "unit": "img/s/chip",
        "runs": [round(r, 2) for r in runs],
        "flops_per_img": round(flops_per_step / B / 1e9, 1),
        "mfu": round(mfu, 4),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")

    env = bench_env()
    B, H, W = env["batch"], env["height"], env["width"]
    cfg = model_config(env)
    model = build_monodetr(cfg, seed=0).to(device)
    step = make_train_step(model, SetCriterion(CRITERION), build_optimizer(OPTIMIZER, model),
                           torch.bfloat16)
    batch = batch_to_device(make_batch(B, H, W), device)
    gen = torch.Generator(device=device).manual_seed(1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    runs, losses = timed_windows(step, batch, gen, B, device)
    loss = float(losses.as_dict()["loss_detr"])
    if not np.isfinite(loss):
        raise RuntimeError(f"bench_torch: loss_detr {loss} after the timed steps")
    where = (f"{card_line()}; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
             if device.type == "cuda" else "cpu (host clock; not a device number)")
    t0 = time.time()
    flops_per_step = count_flops(model, step, batch, gen)
    print(f"bench_torch: {where}; {cfg['backbone']}, batch {B}, {H}x{W}, bf16 compute, "
          f"remat {cfg['remat']!r}, msda_impl {cfg['msda_impl']} (window {cfg['msda_window']}), "
          f"dec_msda_impl {cfg['dec_msda_impl']}, {cfg['enc_layers']}+{cfg['dec_layers']} layers; "
          f"{WARMUP_STEPS} warm-up steps, {WINDOWS} windows of {WINDOW_STEPS}; last loss_detr "
          f"{loss:.4f}; FLOPs counted at batch {B} in {time.time() - t0:.1f} s",
          file=sys.stderr)
    print(json.dumps(result_line(H, W, B, runs, flops_per_step)), flush=True)


if __name__ == "__main__":
    main()
