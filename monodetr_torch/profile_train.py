"""Device-time breakdown of the monodetr_torch training step on one CUDA card.

    python -m monodetr_torch.profile_train [--batch 16] [--steps 3] [--out outputs/profile]
        [--msda-impl fused] [--dec-msda-impl sep]

The shipped model (configs/monodetr.yaml, full width and depth, seeded
random weights; the two impl options switch its deformable attention to
an opt-in path, e.g. pallas + dense_fused) trains on synthetic 384x1280 images and targets in bf16
compute with f32 parameters and dropout 0.1 (train/synthetic.py).  After 3
warm-up steps, 30 steps are timed one by one by CUDA events without the
profiler (steps spread by tens of ms, so one reads their median), then
`--steps` steps run under torch.profiler.
Printed: the unprofiled ms/step (mean, median, min, max), the profiled
window's ms/step, the device time per step of each group of kernels and of
the top kernels, and the device's idle share (1 - summed kernel time /
time; the step runs on one stream, so kernels do not overlap) of the
profiled window and of the median unprofiled step.  The profiler's own
host work lengthens its window, so the second share is the one a step
without it sees.  The Chrome trace is written to <out>/train_trace.json.
Needs a CUDA card.
"""

import argparse
import os
from collections import defaultdict

import numpy as np
import torch

from .config import MONODETR_MODEL
from .models.criterion import SetCriterion
from .models.monodetr import build_monodetr, compute_dtype
from .train.optimizer import build_optimizer
from .train.synthetic import SyntheticLoader
from .train.train_step import batch_to_device, make_train_step

TIMED_STEPS = 30
# kernel-name substrings -> group, first match wins
GROUPS = (
    ("msda_enc_fused_bwd", "port: encoder MSDA bwd (kernel 1)"),
    ("msda_enc_fused", "port: encoder MSDA fwd (kernel 1)"),
    ("msda_pallas_bwd", "port: encoder MSDA bwd (kernel 5)"),
    ("msda_pallas", "port: encoder MSDA fwd (kernel 5)"),
    ("msda_sepwin_bwd", "port: encoder MSDA bwd (kernel 6)"),
    ("msda_sepwin", "port: encoder MSDA fwd (kernel 6)"),
    ("msda_dense_fused_bwd_bin", "port: decoder MSDA bwd, binning (kernel 7)"),
    ("msda_dense_fused_bwd_value", "port: decoder MSDA bwd, value side (kernel 7)"),
    ("msda_dense_fused", "port: decoder MSDA fwd (kernel 7)"),
    ("msda_sep_bwd", "port: decoder MSDA bwd (kernel 2; kernel 7's query side)"),
    ("msda_sep", "port: decoder MSDA fwd (kernel 2)"),
    ("attention_bwd", "port: attention bwd (kernel 3)"),
    ("attention_fwd", "port: attention fwd (kernel 3)"),
    ("lap_kernel", "port: LAP (kernel 4)"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("conv", "convolutions (cuDNN)"),
    ("xmma", "convolutions (cuDNN)"),
    ("cudnn", "convolutions (cuDNN)"),
    ("gemm", "GEMMs (cuBLAS)"),
    ("nvjet", "GEMMs (cuBLAS)"),
    ("cutlass", "GEMMs (cuBLAS)"),
    ("grid_sampler", "grid_sample (depth readout)"),
    ("layer_norm", "norms"),
    ("group_norm", "norms"),
    ("GroupNorm", "norms"),
    ("softmax", "softmax"),
    ("reduce", "reductions"),
    ("scatter", "gather/scatter/index"),
    ("gather", "gather/scatter/index"),
    ("index", "gather/scatter/index"),
    ("philox", "random (dropout masks)"),
    ("distribution", "random (dropout masks)"),
    ("copy", "copies and casts"),
    ("elementwise", "elementwise"),
)


def group_of(name):
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default="outputs/profile")
    parser.add_argument("--msda-impl", default=MONODETR_MODEL["msda_impl"])
    parser.add_argument("--dec-msda-impl", default=MONODETR_MODEL["dec_msda_impl"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train: needs a CUDA card")

    cfg = dict(MONODETR_MODEL, msda_impl=args.msda_impl, dec_msda_impl=args.dec_msda_impl)
    model = build_monodetr(cfg, seed=444).cuda()
    opt = build_optimizer({"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, model)
    step = make_train_step(model, SetCriterion(cfg), opt, compute_dtype(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [batch_to_device(b, "cuda")
               for b, _ in SyntheticLoader(3 + args.steps, args.batch, 4)]
    for b in batches[:3]:
        step(b, 2e-4, gen)
    torch.cuda.synchronize()

    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    events[0].record()
    for i in range(TIMED_STEPS):
        step(batches[i % len(batches)], 2e-4, gen)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for b in batches[3:]:
            step(b, 2e-4, gen)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        ms = e.device_time_total / 1000.0
        by_group[group_of(e.name)] += ms
        by_name[e.name] += ms
        counts[group_of(e.name)] += 1
    busy = sum(by_group.values())
    n = args.steps
    print(f"card: {torch.cuda.get_device_name(0)}; batch {args.batch}, 384x1280, bf16 compute, "
          f"msda_impl {args.msda_impl}, dec_msda_impl {args.dec_msda_impl}")
    med = float(np.median(step_ms))
    print(f"unprofiled: {len(step_ms)} steps by CUDA events, ms/step mean "
          f"{step_ms.mean():.1f} median {med:.1f} min {step_ms.min():.1f} max "
          f"{step_ms.max():.1f}: " + " ".join(f"{m:.1f}" for m in step_ms))
    print(f"profiled window: {window_ms / n:.1f} ms/step (CUDA events, under the profiler); "
          f"kernel time {busy / n:.1f} ms/step; device idle share {1 - busy / window_ms:.3f} "
          f"of the window, {1 - busy / n / med:.3f} of the median unprofiled step; "
          f"{len(kernels) // n} kernels/step")
    print(f"{'group':44s} {'ms/step':>9s} {'share':>7s} {'kernels/step':>13s}")
    for g, ms in sorted(by_group.items(), key=lambda x: -x[1]):
        print(f"{g:44s} {ms / n:9.2f} {ms / busy:7.3f} {counts[g] // n:13d}")
    print("top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda x: -x[1])[:20]:
        print(f"  {ms / n:8.2f} ms/step  {name[:110]}")
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "train_trace.json"))


if __name__ == "__main__":
    main()
