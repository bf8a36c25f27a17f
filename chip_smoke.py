"""Smoke run of monodetr_torch on one CUDA card.

    python3 chip_smoke.py [--decoder-msda-only | --lap-only | --learning-loop-only |
                           --bench-only | --backbone-only]

Phases, one line each (or a few), and any failure exits non-zero:
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits 1 when no CUDA device is present;
  2. build the CUDA kernels from monodetr_torch/csrc (nvcc) and, beside
     them, the loader's and the evaluator's host kernels from
     monodetr_torch/csrc/kitti_native.cpp (g++ -march=native), with the
     host library's path, its build seconds and whether the CPU has
     avx512f;
  3. each forward kernel against its plain PyTorch version on the card at
     the slices' shapes, in f32 (TF32 off) and bf16, with both times;
     kernels 2 and 7 at the 50 eval queries and the 550 training queries,
     timed at both;
  4. each training kernel against its plain version: the MSDA backwards
     and the attention forward and backward with dropout (gradients
     against autograd through the plain versions, f32 at B=2 and bf16 at
     B=16; kernels 2 and 7 at 50 and 550 queries, timed at both, with the
     device time of every launch their wrappers make, as kernel 1's
     backward), kernels 2 and 7 at
     32 samples per head and with all 550 queries' samples inside one 16 x
     16 px patch (a line each with that time beside the uniform one), the
     dropout's properties, the backbone's three epilogue kernels
     (ops/backbone.py) bit-identical to their plain versions at r101x2's
     layer3 and r50's layer1 shapes (batch 16, bf16), each timed beside its
     bytes bound at 3.35 TB/s and the PyTorch passes it replaces
     (phase_backbone_epilogues), and the LAP kernel bit-identical to its plain
     version on 528 matching problems and on its edge cases
     (lap_edge_cases), with its cycles per Dijkstra iteration (one launch
     of the longest problem less one of a problem the greedy start
     solves) and a second bound beside its bytes bound: the longest
     problem's chain of dependent steps (counted) times a step's cycles,
     from the latencies of its links measured on the card by clock64
     (ops/lap.py:lap_step_latencies);
  5. the eval slice: MonoDETR at the full width of configs/monodetr.yaml,
     seeded random weights, `Tester.inference` over 2 batches of 16
     synthetic 384x1280 images in bf16, launch counters checked; then the
     f32 forward at B=2 against the same model through the plain versions;
  6. the training slice: the same model with f32 parameters, bf16 compute
     and dropout 0.1, 6 train steps at batch 16 on synthetic images and
     targets (the step's CUDA graphs captured on the second step and
     replayed on the rest), launch counters checked (train_launches),
     ms/step and img/s; then
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
     in shared memory), kernel 1's backward, which stages the same
     rectangles, with every offset beyond the window (timed at B=16 beside
     the training offsets), and a line gives the three backwards'
     shared-memory bytes and blocks per SM;
  8. the stress configuration (bench.py's BENCH_BACKBONE=resnet101
     BENCH_H=768 BENCH_W=2560 BENCH_BS=2 BENCH_REMAT=1; the default impls,
     bf16): 3 train steps with their launch counters, then 2 with remat
     off, the peak memory and ms/step of each; one `Tester.inference`
     batch, then the f32 forward at B=2 through the kernels against the
     plain versions; one f32 step at B=1 without dropout through the
     kernels against the plain versions (kernels 1-4 at this path's shapes:
     40,800 encoder tokens, attention over 7,680); and one f32 step at B=1
     with dropout 0.1 with remat and without, from one generator seed: the
     losses and the generator's final state bit-equal, every gradient
     within REMAT_GRAD_TOL;
  9. the query variants (`two_stage`, `use_dab`, `two_stage_dino`) of the
     shipped model, default impls, bf16, batch 16, 384x1280, one model
     built per variant: `use_dab` and `two_stage_dino` train 2 steps at
     group_num 11 (550 queries), `two_stage` at group_num 1 (its 50
     proposals), each with its launch counters, its proposal counters
     (tokens scored and picks taken, counted on every step, replays
     included: proposal_counts) and ms/step; two_stage's
     group_num 11 raises the criterion's ValueError; each runs one
     `Tester.inference` batch, then its f32 forward at B=2 through the
     kernels against the plain versions (two_stage's encoder outputs too),
     and one f32 step at B=1 without dropout against the plain versions
     (matches, losses, gradients; each gradient against the nearer of two
     plain steps one ulp of input apart, the plain runs on the kernel
     run's proposal picks: phase_train_vs_plain);
 10. data parallel (parallel/ddp.py) on the card: world size 1 over NCCL
     through init_distributed, one bf16 step at batch 16 with dropout 0.1
     against the step without dp from the same seeds (losses and the
     generator's state bit-equal, the all-reduce returning every gradient
     bit for bit, the gradients beside two steps without dp); then two
     gloo ranks sharing the card, 2 images each, f32 without dropout,
     against one process on the 4 (parallel/dryrun.py:
     compare_with_one_process: losses, gradients, every parameter after
     AdamW against the difference its two gradients imply, identical on
     both ranks, and the parallel eval step's gathered detections).  NCCL refuses two ranks on one card, so NCCL is
     exercised at world size 1 only;
 11. the handoff (data/device_prefetch.py): a synthetic KITTI split of 32
     images (tests/synthetic_kitti.py) through the port's loader and the
     prefetcher into 6 default bf16 train steps at batch 16, with
     torch.cuda.set_sync_debug_mode("error") around the loop (any
     synchronizing call raises); the same loop through the blocking
     pageable copy must raise under that mode; every prefetched batch
     bit-equal to the blocking copy of the same numpy batch; the trainer's
     img/s over one epoch through each handoff (smoke readings);
 12. the CLI (tools/train_val_torch.py) on 8 synthetic images: 2 epochs of
     training with its evaluations, then -e, each in a process of its own
     that must exit 0, write the tester's rows and report its launches;
 13. tools/validate_clamp_torch.py, short: fused G=6 against gather, 10
     bf16 steps at batch 2, 384x1280, max relative loss difference <= 0.1;
 14. the host kernels on the card's host: the warp, the rotated IoU and the
     evaluator's matching against their plain versions (PIL, numpy) at
     tests/test_native.py's and test_native_match.py's tolerances, and
     the whole official evaluation native against plain; then the
     loader's cost per image on this host (PNG decode, the warp native and
     plain, target encoding, the whole item) over 32 synthetic KITTI
     images, one thread (smoke readings);
 15. the pretrained start through the port alone: a seeded state dict in
     torchvision's ResNet-50 layout converted by
     tools/convert_checkpoint_torch.py --torchvision-backbone, the
     Trainer's merged backbone held to it before the first step, 1 epoch
     of the CLI from it as trainer.pretrain_model with its evaluation;
     then a reference-layout MonoDETR .pth converted by the same tool,
     evaluated by the CLI with -e, and its detections on one batch held to
     those of the model it came from (f32, TF32 off, phase 5's tolerance);
 16. the bench (`python bench_torch.py`, monodetr_torch/bench.py), each run
     a process of its own: the default environment, then the stress
     configuration (BENCH_BACKBONE=resnet101 BENCH_H=768 BENCH_W=2560
     BENCH_BS=2 BENCH_REMAT=1); each must exit 0, print bench.py's JSON
     line (its keys in its order) as its last line, with 3 positive runs,
     flops_per_img > 0 and 0 < mfu < 1, and launch the default path's
     kernels 40 steps over (4 warm-up, 3 windows of 12) and the LAP once
     more (the FLOP count's step through the plain versions); both lines
     are printed as they came.
Between phases 4 and 5 runs the bf16 dtype policy (phase_dtype_policy):
one training forward of each path's model at full width (the default, A,
B, the stress configuration at its own size, the three query variants;
f32 parameters under bf16 autocast, dropout 0.1, remat on where the path
has it), every norm and layer output held to bf16, as the JAX model's at
`dtype: bf16`, and the heads' outputs to f32, with a line of each path's
activation bytes by dtype before the per-path lines.
The kernel report (JSON) sums each kernel's launches over the main-path
runs of phases 5-16 and fails if one of them is 0; it is the second-to-last
line.  Beside each kernel's time and its plain version's it gives the
least time the card could take for the same work at the timed shape
(`bound_ms`: the larger of the bytes it must move over 3.35 TB/s and its
operations over the peak rate of their type, `bound_by` says which; for
kernels 2 and 7 the line's numbers are those at 550 queries, and `q50` holds
the same at 50; `device_ms` the device time of each launch of a backward;
for LAP also its chain bound and cycles per Dijkstra iteration)
and, for attention, the time of F.scaled_dot_product_attention at the same
shapes and dropout (`library_ms`, a yardstick the port never calls; null
for the kernels that no single PyTorch call computes).  Attention is also
timed, with the library, at the other dropout rate (forward at 0.1,
backward at 0), which gives dropout's share of its time.  The last line is
{"ok": true, "device": {...}}.

With --decoder-msda-only the run is phases 1 and 2 and what phases 3 and 4
do for kernels 2 and 7, with --encoder-msda-only the same for kernels 1,
5 and 6 and kernel 1's backward with every offset beyond the window
(phase_enc_clustered), with --lap-only phases 1 and 2 and the LAP
part of phase 4, with --learning-loop-only phases 1, 2 and 11-15, and
with --bench-only phases 1, 2 and 16, with --backbone-only phases 1 and 2
and the backbone's epilogues; none prints the report or the last
line.  Each is a
minute or less for those kernels' times, e.g. of two checkouts one after
the other on one card (the wrappers they call are `ms_deform_attn_sep`,
`ms_deform_attn_dense_fused`, `ms_deform_attn_enc_fused`,
`ms_deform_attn_pallas_packed`, `ms_deform_attn_sepwin` and their `_bwd`,
and `lap_solve`; --lap-only also needs `lap_step_latencies` and
`lap_edge_cases` in ops/lap.py).
"""

import contextlib
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
from monodetr_torch.ops.lap import (  # noqa: E402
    lap_edge_cases, lap_solve, lap_solve_plain, lap_step_latencies)
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
from monodetr_torch.utils import trace  # noqa: E402

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

KERNELS = {
    "msda_enc_fused": dict(
        fn=ms_deform_attn_enc_fused, route="cuda", source="monodetr_torch/csrc/msda.cu",
        replaces="monodetr_tpu/ops/msda_enc_pallas.py:653"),
    "msda_enc_fused_bwd": dict(
        fn=ms_deform_attn_enc_fused_bwd, route="cuda", source="monodetr_torch/csrc/msda_win.cu",
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
# the stress configuration (bench.py:61-62, BASELINE.json config 4): the
# default impls on ResNet-101 at twice the input size, batch 2, remat on
STRESS = {"backbone": "resnet101", "remat": True}
STRESS_SIZE, STRESS_BATCH = (768, 2560), 2
# the query variants: overrides of configs/monodetr.yaml's model; two_stage
# trains its num_queries proposals as one group
VARIANTS = {"two_stage": {"two_stage": True, "group_num": 1},
            "use_dab": {"use_dab": True},
            "two_stage_dino": {"two_stage_dino": True}}
# a gradient of the step with remat against the step without, max |a - b| /
# max |b| per tensor: the recompute repeats the kernels' sums, and the
# atomics of kernels 1 and 2 (and cuDNN's weight gradients) add in another
# order from run to run (~1e-7 relative); a dropout mask drawn anew would
# move a gradient by ~1e-1
REMAT_GRAD_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, queued=False):
    """Mean device time of fn() in ms, by CUDA events after a warm-up.
    queued: the launches queue behind a spin of the card (torch.cuda._sleep),
    so the card, not the host, sets the pace even when each launch is
    shorter than its host work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
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


# the kernels' launch counters (utils/trace.py) at the last reset_launches()
LAUNCHES_AT_RESET = {}


def reset_launches():
    LAUNCHES_AT_RESET.clear()
    LAUNCHES_AT_RESET.update(trace.counts())


def read_launches():
    """{kernel: launches since the last reset_launches()}."""
    now = trace.counts()
    return {name: now.get(name, 0) - LAUNCHES_AT_RESET.get(name, 0) for name in KERNELS}


# the backbone's epilogue kernels (ops/backbone.py) count their launches
# under one counter, checked by the eval and train slices beside KERNELS'
BACKBONE = "backbone_epilogue"


def backbone_launches(cfg, train):
    """BACKBONE launches of one forward of cfg's backbone, and with `train`
    of its backward: (a) at the stem, (a) twice and (b) once a block; in
    the backward (d) once a trained block (layers 2-4) but layer2's first,
    whose input is detached; with remat each trained block's forward
    again, recomputed under checkpoint."""
    from monodetr_torch.models.backbone import STAGE_BLOCKS

    blocks = STAGE_BLOCKS[cfg["backbone"]]
    trained = sum(blocks[1:])
    n = 1 + 3 * sum(blocks)
    if train:
        n += trained - 1 + (3 * trained if cfg.get("remat") else 0)
    return n


def backbone_counts(want, label):
    """BACKBONE's launches since the last reset_launches(): fail unless
    they are `want`."""
    got = trace.counts().get(BACKBONE, 0) - LAUNCHES_AT_RESET.get(BACKBONE, 0)
    if got != want:
        raise RuntimeError(f"{label}: {BACKBONE} launches {got}, want {want}")
    return {BACKBONE: got}


# the proposal variants count the tokens their heads score and the picks
# their top-k takes, on every training step, replays included
# (models/transformer.py)
PROPOSALS = ("proposal_tokens", "proposal_picks")


def proposal_counts(cfg, n_steps, batch, size, label):
    """PROPOSALS since the last reset_launches(), over n_steps training
    steps: fail unless they are batch x S tokens and batch x K picks a
    step under `two_stage` or `two_stage_dino` (S the four levels' tokens
    at strides 8-64, K the proposals a training step takes), else 0."""
    got = {k: trace.counts().get(k, 0) - LAUNCHES_AT_RESET.get(k, 0) for k in PROPOSALS}
    tokens = sum(-(-size[0] // 2 ** s) * -(-size[1] // 2 ** s) for s in (3, 4, 5, 6))
    picks = min(tokens, cfg["num_queries"] * (cfg.get("group_num", 11) if cfg["two_stage_dino"]
                                              else 1))
    steps = n_steps * batch * bool(cfg["two_stage"] or cfg["two_stage_dino"])
    want = {"proposal_tokens": steps * tokens, "proposal_picks": steps * picks}
    if got != want:
        raise RuntimeError(f"{label}: proposal counters {got}, want {want}")
    return got


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
    """The CUDA kernels (nvcc) and, beside them in a thread, the host
    kernels of the loader and the evaluator (g++)."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.time()
        return fn(), time.time() - t0

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(timed, _build.build_host)
        lib, seconds = timed(_build.build)
        host_lib, host_seconds = host.result()
    _build.library()
    _build.host_library()
    log(f"build: {lib.relative_to(REPO)} in {seconds:.1f} s")
    log(f"build: host kernels {host_lib.relative_to(REPO)} from "
        f"{_build.HOST_SRC.relative_to(REPO)} (g++ {' '.join(_build.HOST_FLAGS)}) in "
        f"{host_seconds:.1f} s; this host's CPU has avx512f: "
        f"{'avx512f' in _build.cpu_flags().split()}, {os.cpu_count()} cores")


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
ENC_KERNELS = ("msda_enc_fused", "msda_enc_fused_bwd", "msda_pallas", "msda_pallas_bwd",
               "msda_sepwin", "msda_sepwin_bwd")


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
            if name in LOC_KERNELS or name == "msda_enc_fused_bwd":
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
    where its value gradient goes to device memory directly).  Then kernel
    1's backward with every sample at its window's bound
    (phase_enc_clustered), and the shared memory and blocks per SM of the
    three backwards' tile passes, as the runtime reports."""
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
    phase_enc_clustered()
    tiles = window_tiles(LEVELS, G)
    shape = {}
    for kernel, name in ((1, "msda_enc_fused_bwd"), (5, "msda_pallas_bwd"),
                         (6, "msda_sepwin_bwd")):
        blocks, smem = backward_occupancy(kernel, torch.bfloat16, LEVELS, G)
        shape[name] = {"smem_bytes": smem, "blocks_per_sm": blocks}
        if smem != tiles.smem_bytes or blocks < 1:
            raise RuntimeError(f"{name}: {smem} bytes of shared memory, {blocks} blocks per SM; "
                               f"the tiling asks for {tiles.smem_bytes}")
    return {"windowed_backward": dict(
        shape, heads_per_block=WIN_HEADS, tile_pixels=list(tiles.side),
        queries_per_tile=tiles.queries, rows_per_head=tiles.rows)}


def phase_enc_clustered():
    """Kernel 1's backward with every offset beyond the window, so every
    sample sits at a corner of its query's window and many add to the same
    staged rows: against the plain version (f32 B=2, bf16 B=16; doff all
    0), timed at B=16 beside the training inputs of enc_offsets."""
    lim = window_limit(G)
    for dtype, B in ((torch.float32, 2), (torch.bfloat16, 16)):
        gen = torch.Generator(device="cuda").manual_seed(6)
        value = randn(gen, B, S, H, D).to(dtype)
        even = enc_offsets(gen, B)
        off = (torch.sign(even) * (lim + 1 / 32 + even.abs() % 1)).to(dtype)
        even = even.to(dtype)
        logits = randn(gen, B, S, H * L * P, scale=2.0).to(dtype)
        gout = randn(gen, B, S, H * D).to(dtype)
        xs = [x.detach().requires_grad_(True) for x in (value, off, logits)]
        want = torch.autograd.grad(ms_deform_attn_enc_fused_plain(xs[0], LEVELS, xs[1], xs[2], G),
                                   xs, gout)
        tag = f"{str(dtype).replace('torch.', '')} B={B} every offset beyond the window"
        grads = ms_deform_attn_enc_fused_bwd(value, LEVELS, off, logits, gout, G)
        check_grads("msda_enc_fused_bwd", tag, dtype, grads, want)
        masked = (grads[1] == 0).all().item()
        log(f"kernel msda_enc_fused_bwd {tag}: doff 0 everywhere {masked} "
            f"{'ok' if masked else 'FAIL'}")
        if not masked:
            raise RuntimeError("msda_enc_fused_bwd: a clamped offset got a gradient")
        if B == 16:
            ms = cuda_ms(lambda: ms_deform_attn_enc_fused_bwd(value, LEVELS, off, logits, gout, G),
                         iters=10)
            even_ms = cuda_ms(
                lambda: ms_deform_attn_enc_fused_bwd(value, LEVELS, even, logits, gout, G),
                iters=10)
            log(f"kernel msda_enc_fused_bwd {tag}: {ms:.3f} ms, training offsets {even_ms:.3f} ms")
        del xs, want, grads


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


# the epilogue kernels' timing shapes (batch 16, bf16): r101x2's layer3 at
# 768x2560 (48 x 160 at stride 16, inner width 256, blocks' outputs 1024)
# and r50's layer1 at 384x1280 (96 x 320, 64, 256)
BACKBONE_SHAPES = (("r101x2 layer3", 16, 256, 1024, (48, 160)),
                   ("r50 layer1", 16, 64, 256, (96, 320)))


def phase_backbone_epilogues():
    """The backbone's epilogue kernels (ops/backbone.py) at the main path's
    shapes: bit-identical to their plain versions, and each timed by CUDA
    events beside its bytes bound (each input read and the output written
    once, over 3.35 TB/s) and the PyTorch passes it replaces on the plain
    path (the bias add and ReLU; the bias add, residual add and ReLU;
    autograd's add and threshold_backward).  (a) runs at the blocks' inner
    width, (b) and (d) at their output width.  Returns {shape: {kernel:
    row}}."""
    from monodetr_torch.ops import backbone as ob

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    report = {}
    for label, B, width, out_c, (h, w) in BACKBONE_SHAPES:
        def act(C):
            return torch.randn(B, C, h, w, generator=gen, device="cuda").to(bf16).contiguous(
                memory_format=torch.channels_last)

        inner = act(width)
        o3, idn, g_a, g_b, x_out = act(out_c), act(out_c), act(out_c), act(out_c), act(out_c)
        b_in, b3 = (torch.randn(C, generator=gen, device="cuda") for C in (width, out_c))
        v = (1, -1, 1, 1)
        for got, want in ((ob.bias_relu_(inner.clone(), b_in), ob.bias_relu_plain(inner, b_in)),
                          (ob.tail(o3, idn, b3), ob.tail_plain(o3, idn, b3)),
                          (ob.accumulate_mask(g_a, g_b, x_out),
                           ob.accumulate_mask_plain(g_a, g_b, x_out))):
            if not torch.equal(got, want):
                raise RuntimeError(f"backbone epilogues, {label}: a kernel differs from its "
                                   "plain version")
        work, work3 = inner.clone(), o3.clone()
        out3 = torch.empty_like(o3)
        bi, b3h = b_in.to(bf16).view(v), b3.to(bf16).view(v)
        cases = {
            "bias_relu_": (lambda: ob.bias_relu_(work, b_in), nbytes(inner) * 2,
                           lambda: F.relu(work.add_(bi))),
            "tail": (lambda: ob.tail(o3, idn, b3, out=out3), nbytes(o3) * 3,
                     lambda: F.relu(work3.add_(b3h) + idn)),
            "accumulate_mask": (lambda: ob.accumulate_mask(g_a, g_b, x_out, out=out3),
                                nbytes(g_a) * 4,
                                lambda: torch.ops.aten.threshold_backward(g_a + g_b, x_out, 0)),
        }
        rows = {}
        for name, (kernel, moved, passes) in cases.items():
            ms, bound_ms = cuda_ms(kernel), 1e3 * moved / HBM_BYTES_S
            rows[name] = dict(ms=round(ms, 4), bound_ms=round(bound_ms, 4),
                              bound_share=round(bound_ms / ms, 3),
                              pytorch_passes_ms=round(cuda_ms(passes), 4))
            C = out_c if name in ("tail", "accumulate_mask") else width
            log(f"backbone epilogue {name}, {label} ({B}x{C}x{h}x{w} bf16): {ms:.4f} ms, bytes "
                f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of 3.35 TB/s), PyTorch's "
                f"passes {rows[name]['pytorch_passes_ms']:.4f} ms")
        report[label] = rows
        del inner, o3, idn, g_a, g_b, x_out, work, work3, out3
        torch.cuda.empty_cache()
    log(json.dumps({"backbone_epilogues": report}))
    return report


def sm_clock_hz():
    """The SM clock now, from a spin of a known number of cycles
    (torch.cuda._sleep counts clock64) timed by CUDA events."""
    cycles = 200_000_000
    torch.cuda._sleep(cycles // 10)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / (start.elapsed_time(end) * 1e-3)


def phase_lap():
    """The LAP kernel on 528 problems (3 layers x 16 images x 11 groups of
    50 queries) from matching costs of random outputs and targets with 0-50
    valid rows, a third of them quantised to 0.25 for ties: bit-identical
    to lap_solve_plain, and as cheap as scipy's assignment; then
    bit-identical on lap_edge_cases.  Then its cycles per Dijkstra step:
    one launch holding only the longest problem less one holding a problem
    the greedy start solves, over the longest's iterations, times the SM
    clock.  Then its chain bound from the latencies of a step's links,
    measured on this card (`lap_step_latencies`)."""
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
    edge = []
    for name, ec, ev in lap_edge_cases():
        ok_case = torch.equal(lap_solve(torch.from_numpy(ec).cuda(), torch.from_numpy(ev).cuda())
                              .cpu(), lap_solve_plain(torch.from_numpy(ec), torch.from_numpy(ev)))
        edge.append(f"{name} {'ok' if ok_case else 'FAIL'}")
        same = same and ok_case
    ok = same and worse == 0
    # the cost rows, validity and assignment once; every valid row's N costs
    # must be compared at least once (f32)
    bound_ms, bound_by = bound(nbytes(cost_d, rv_d, got), 2 * int(n_valid.sum()) * N, F32_FLOPS)
    log(f"kernel lap 528 problems of 50x50, {int(ties.sum())} with ties: bit-identical to "
        f"lap_solve_plain {same}, costs above scipy's {worse} {'ok' if ok else 'FAIL'}; "
        f"{ms:.4f} ms, plain (on the card) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); edge cases bit-identical: {', '.join(edge)}")
    if not ok:
        raise RuntimeError("lap: the kernel disagrees with its plain version or scipy")

    # cycles per Dijkstra step: the longest problem alone against a problem
    # of the same size that the greedy start solves (every row's argmin its
    # own column), each launch's device time with the card setting the pace
    longest = int(steps.reshape(-1).argmax())
    iters = int(steps.max())
    one = cost.reshape(-1, N, N)[longest:longest + 1].cuda()
    one_rv = rv.reshape(-1, N)[longest:longest + 1].cuda()
    easy = (1.0 - torch.eye(N))[None].cuda()
    easy_rv = torch.ones(1, N, dtype=torch.bool, device="cuda")
    easy_steps = torch.zeros(1, dtype=torch.int64)
    lap_solve_plain(easy.cpu(), easy_rv.cpu(), easy_steps)
    if int(easy_steps) != 0:
        raise RuntimeError("lap: the greedy start's problem needs Dijkstra iterations")
    clock = sm_clock_hz()
    t_long = cuda_ms(lambda: lap_solve(one, one_rv), queued=True)
    t_easy = cuda_ms(lambda: lap_solve(easy, easy_rv), queued=True)
    cycles_per_step = (t_long - t_easy) * 1e-3 * clock / iters
    log(f"kernel lap one problem: the longest ({iters} Dijkstra iterations) {t_long:.4f} ms, "
        f"one the greedy start solves {t_easy:.4f} ms (device time per launch, launches "
        f"queued); SM clock {clock / 1e9:.3f} GHz (torch.cuda._sleep timed): "
        f"{cycles_per_step:.0f} cycles per Dijkstra iteration")
    report = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, cycles_per_step=cycles_per_step,
                  dijkstra_iterations=iters)
    lat = lap_step_latencies()
    # a step's chain: the chosen column's row (r4c, a shared load), that
    # row's costs (a shared load), the update, the argmin; the parallel
    # start's: a row's costs, its argmin, the claim (a shared atomic) and
    # its read back
    step = 2 * lat["shared_load"] + lat["update"] + lat["argmin"]
    start = 3 * lat["shared_load"] + lat["argmin"]
    chain_cycles = iters * step + start
    chain_ms = 1e3 * chain_cycles / clock
    log(f"kernel lap chain bound: {chain_ms:.4f} ms = {iters} Dijkstra iterations (counted in "
        f"the longest problem; mean {steps.float().mean().item():.1f}) x {step:.1f} cycles "
        f"(2 shared loads of {lat['shared_load']:.1f}, the update {lat['update']:.1f}, the "
        f"argmin {lat['argmin']:.1f}: clock64 on this card, lap_step_latencies) + the "
        f"parallel start {start:.1f} cycles, at the SM clock of {clock / 1e9:.3f} GHz "
        f"(probe's own: {lat['clock_ghz']:.3f}); {Lr * B * Gq} warps over 132 SMs all run at "
        f"once; the kernel takes {ms / chain_ms:.2f}x that, {cycles_per_step / step:.2f}x a "
        f"step's links per Dijkstra iteration")
    report.update(chain_bound_ms=chain_ms, step_cycles=step, step_latencies=lat)
    return {"lap": report}


def train_launches(per_step, n_steps, before=0, graphed=True):
    """The port kernels' launches over n_steps training steps of one input
    shape, made by a step object that made `before` steps of that shape
    before them.  On a CUDA card the step object launches every kernel on
    its first two steps of a shape (eager, capture: train/train_step.py:
    StepGraphs) and then the criterion's LAP alone, as a replay launches
    the rest from its graphs; with `graphed` False (remat, data parallel)
    every step launches every kernel."""
    full = min(n_steps, max(0, 2 - before)) if graphed else n_steps
    return {k: v * (n_steps if k == "lap" else full) for k, v in per_step.items()}


def main_path_counts(per_run, n_runs, label):
    """The launch counts read after a main-path run: fail unless they are
    exactly per_run * n_runs (and 0 for every other kernel)."""
    counts = {k: v for k, v in read_launches().items() if v}
    if counts != {k: v * n_runs for k, v in per_run.items()}:
        raise RuntimeError(f"{label}: launches {counts}, want {per_run} x {n_runs}")
    return counts


def phase_dtype_policy():
    """The bf16 dtype policy on every path at full width: one training
    forward of each path's model (f32 parameters under CUDA's bf16
    autocast, dropout 0.1, gradients on, so remat runs) with forward hooks
    on its norms and layers (models/layers.py:recorded_output_dtypes):
    every LayerNorm and GroupNorm output and every encoder, decoder and
    depth-encoder layer output must be bf16, as the JAX model's at `dtype:
    bf16` (tests/test_torch_bf16_policy.py holds the map to JAX's), and the
    heads' outputs f32.  First one line with each path's activation bytes
    by dtype (the outputs of the leaf modules in that forward) and the
    memory that the forward holds for the backward; then one line per
    path."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.layers import policy_modules, recorded_output_dtypes
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.train_step import batch_to_device

    t0 = time.time()
    f32_norms = ("enc_output_norm", "pos_trans_norm")
    out_keys = ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
                "pred_depth_map_logits", "weighted_depth")
    sizes, lines, failed = [], [], []
    paths = ([("default", {}, 16, (384, 1280)), ("A", CONFIG_A, 16, (384, 1280)),
              ("B", CONFIG_B, 16, (384, 1280)), ("stress", STRESS, STRESS_BATCH, STRESS_SIZE)]
             + [(name, overrides, 16, (384, 1280)) for name, overrides in VARIANTS.items()])
    for name, overrides, batch, size in paths:
        cfg = dict(MONODETR_MODEL, **overrides)
        model = build_monodetr(cfg, seed=444).cuda().train()
        b = batch_to_device(next(iter(SyntheticLoader(1, batch, 7, *size)))[0], "cuda")
        by_dtype = {}

        def count(module, args, out):
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + t.numel() * t.element_size()

        leaves = [m.register_forward_hook(count) for m in model.modules()
                  if not list(m.children())]
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            with recorded_output_dtypes(model) as seen, torch.autocast("cuda",
                                                                      dtype=torch.bfloat16):
                out = model(b["images"], b["calibs"], b["img_sizes"], train=True, gen=gen)
        finally:
            for h in leaves:
                h.remove()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        want = {n for n in policy_modules(model) if not n.endswith(f32_norms)}
        wrong = {n: sorted(str(d) for d in seen[n]) for n in want
                 if seen.get(n) != {torch.bfloat16}}
        heads = {k: str(out[k].dtype) for k in out_keys if out[k].dtype != torch.float32}
        ok = set(seen) == want and not wrong and not heads
        sizes.append(f"{name} {by_dtype.get(torch.float32, 0) / 1e9:.3f} GB f32 / "
                     f"{by_dtype.get(torch.bfloat16, 0) / 1e9:.3f} GB bf16, held "
                     f"{held / 2 ** 30:.2f} GiB")
        lines.append(f"bf16 dtype policy {name} ({batch} x {size[0]}x{size[1]}): {len(seen)} "
                     f"norm and layer outputs bf16 {not wrong and set(seen) == want}"
                     + (f" (not bf16: {wrong}; not run: {sorted(want - set(seen))})"
                        if wrong or set(seen) != want else "")
                     + f", heads' outputs f32 {not heads}" + (f" ({heads})" if heads else "")
                     + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        del model, out, b
        torch.cuda.empty_cache()
    log("bf16 dtype policy: activation bytes by dtype (outputs of the leaf modules in one "
        "training forward) and the memory the forward holds for the backward: "
        + "; ".join(sizes))
    for line in lines:
        log(line)
    log(f"bf16 dtype policy in {time.time() - t0:.1f} s")
    if failed:
        raise RuntimeError(f"bf16 dtype policy: {failed} differ from the JAX model's")


def phase_eval_slice(label="eval slice", overrides=None, n_batches=2,
                     per_forward=None, check_plain=True, batch=16, size=(384, 1280), base=None):
    """Tester.inference in bf16 at `batch` with the launch counts read
    around it; then the f32 forward at B=2 and the same `size`, kernels
    against plain versions.  `base`: the f32 model on the card to copy
    (else one is built)."""
    import logging

    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.eval.tester import Tester
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype

    cfg = dict(MONODETR_MODEL, **(overrides or {}))
    def fresh():
        return copy.deepcopy(base) if base is not None else build_monodetr(cfg, seed=444).cuda()

    model = fresh().to(compute_dtype(cfg))
    logging.basicConfig(level=logging.WARNING)
    # threshold 0: random weights score every pick near the 0.01 class
    # prior, and the decode of all 50 picks per image is what is checked
    tester = Tester({"threshold": 0.0, "topk": 50}, model,
                    SyntheticLoader(n_batches, batch, 0, *size),
                    logging.getLogger("chip_smoke"), {"save_path": "outputs/"}, "chip_smoke")
    per_forward = per_forward or {"msda_enc_fused": 3, "msda_sep": 3, "attention_fwd": 1}
    reset_launches()
    results = tester.inference()
    torch.cuda.synchronize()
    counts = main_path_counts(per_forward, n_batches, label)
    counts.update(backbone_counts(n_batches * backbone_launches(cfg, False), label))
    rows = [r for preds in results.values() for r in preds]
    ok = (len(results) == n_batches * batch and len(rows) == n_batches * batch * 50
          and np.isfinite(np.asarray(rows, np.float64)).all()
          and all(len(r) == 14 for r in rows))
    txts = len(os.listdir(tester.results_dir))
    log(f"{label}: Tester.inference bf16 {n_batches} x {batch} images {size[0]}x{size[1]}: "
        f"{tester.ms_per_img:.2f} ms/img, launches {counts} (want {per_forward} and "
        f"{backbone_launches(cfg, False)} {BACKBONE} per forward), {len(rows)} KITTI rows in "
        f"{txts} txts {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: wrong decoded rows")
    batch0, _ = next(iter(SyntheticLoader(1, batch, 0, *size)))
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
    model = fresh().float()
    b2, _ = next(iter(SyntheticLoader(1, 2, 1, *size)))
    inputs = [torch.from_numpy(b2[k]).cuda() for k in ("images", "calibs", "img_sizes")]
    with torch.no_grad():
        got = model(*inputs)
        want = model.use_plain_ops(True)(*inputs)
    torch.cuda.synchronize()
    pairs = {k: (got[k], want[k])
             for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth")}
    if "enc_outputs" in want:  # two_stage's proposals
        pairs.update({"enc_" + k: (got["enc_outputs"][k], want["enc_outputs"][k])
                      for k in ("pred_logits", "pred_boxes")})
    errs = {k: ((a - b).abs() / (1 + b.abs())).max().item() for k, (a, b) in pairs.items()}
    ok = all(e <= tol for e in errs.values()) and all(
        torch.isfinite(a).all().item() for a, _ in pairs.values())
    log(f"{label}: f32 forward B=2 {size[0]}x{size[1]}, kernels vs plain versions: "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the f32 forward through the kernels disagrees")
    return counts


DEFAULT_PER_STEP = {"msda_enc_fused": 3, "msda_enc_fused_bwd": 3, "msda_sep": 3,
                    "msda_sep_bwd": 3, "attention_fwd": 4, "attention_bwd": 4, "lap": 1}


def phase_train_slice(label="train slice", overrides=None, per_step=DEFAULT_PER_STEP,
                      n_steps=6, batch=16, size=(384, 1280), base=None):
    """bf16 train steps at `batch` with dropout 0.1 through the kernels;
    launch counts, finite and moving losses, bf16 kernel inputs, step time
    and the peak memory of the steps (model, AdamW state and batches
    included).  `base`: the f32 model on the card to copy (else one is
    built).  Returns (counts, ms/step from the third step on, or the last
    step's when there are fewer than 3, peak GiB)."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(MONODETR_MODEL, **(overrides or {}))
    # f32 parameters
    model = copy.deepcopy(base) if base is not None else build_monodetr(cfg, seed=444).cuda()
    opt = build_optimizer({"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, model)
    dtype = compute_dtype(cfg)
    step = make_train_step(model, SetCriterion(cfg), opt, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [batch_to_device(b, "cuda") for b, _ in SyntheticLoader(n_steps, batch, 2, *size)]
    seen = set()
    dtype_code = _build.dtype_code

    def recording(dt):  # every MSDA / attention wrapper passes its dtype here
        seen.add(dt)
        return dtype_code(dt)

    _build.dtype_code = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
        events[0].record()
        losses = []
        for i, b in enumerate(batches):
            losses.append(step(b, 2e-4, gen))
            events[i + 1].record()
        torch.cuda.synchronize()
        graphed = not cfg.get("remat")
        counts = main_path_counts(train_launches(per_step, n_steps, graphed=graphed), 1, label)
        counts.update(backbone_counts(train_launches(
            {BACKBONE: backbone_launches(cfg, True)}, n_steps, graphed=graphed)[BACKBONE], label))
        proposals = proposal_counts(cfg, n_steps, batch, size, label)
    finally:
        _build.dtype_code = dtype_code
    values = np.stack([lv.values.cpu().numpy() for lv in losses])
    totals = values[:, losses[0].keys_.index("loss_detr")]
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_steps)]
    steady = float(np.mean(ms[2:] if n_steps > 2 else ms[-1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = (np.isfinite(values).all() and len(set(totals.tolist())) == n_steps
          and seen == {torch.bfloat16} and len(losses[0].keys_) == 2 + 7 * 3 + 1)
    log(f"{label}: {n_steps} train steps, batch {batch}, {size[0]}x{size[1]}, bf16 compute, f32 "
        f"parameters and AdamW state, dropout 0.1: loss_detr "
        + " ".join(f"{t:.3f}" for t in totals)
        + f"; launches {counts} (want {per_step} and {backbone_launches(cfg, True)} "
        f"{BACKBONE} per step on the eager and capture steps, the LAP on every step)"
        + (f"; proposals {proposals} (tokens scored and picks taken, every step)"
           if any(proposals.values()) else "")
        + "; kernel dtypes "
        f"{sorted(str(d) for d in seen)} {'ok' if ok else 'FAIL'}")
    log(f"{label}: ms/step by CUDA events " + " ".join(f"{m:.1f}" for m in ms)
        + f"; steps {min(3, n_steps)}-{n_steps}: {steady:.1f} ms/step, "
        f"{1000 * batch / steady:.1f} img/s; peak memory {peak:.2f} GiB")
    if not ok:
        raise RuntimeError(f"{label}: wrong losses or kernel dtypes")
    del model, opt, step, batches
    torch.cuda.empty_cache()
    return counts, steady, peak


def grad_errors(got, want):
    """Per tensor, max |got - want| / (1e-3 max|want| + 1e-6)."""
    return {n: ((got[n] - g).abs().max() / (1e-3 * g.abs().max() + 1e-6)).item()
            for n, g in want.items()}


def phase_train_vs_plain(label="train vs plain", overrides=None, batch=2, size=(384, 1280),
                         perturbed=False, model=None):
    """One f32 train step at `batch` and `size` without dropout through the
    kernels and through the plain versions (LAP included): identical
    matches, losses to 1e-4 relative, every gradient to 1e-3 * max|g_plain|
    + 1e-6.  `model`: the f32 model on the card to copy (else one is built).

    With `perturbed` (the query variants) the plain step runs a second
    time, on the images times (1 + 2^-23), and a gradient passes where it
    is within that bound of either plain step's; the matches of all three
    runs must be identical.  A decoder sample that a rounding-level move
    takes across a pixel's edge changes its bilinear derivative by a step,
    so two plain steps one ulp of input apart can differ past the bound in
    the decoder's sampling offsets.  Both plain runs take the kernel run's
    proposal picks (`proposal_idx`), since near-tied scores may order
    differently; the plain run's own top-k, from a forward without them,
    must hold at least 99% of those picks."""
    import monodetr_torch.models.matcher as matcher
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.train_step import TARGET_KEYS, batch_to_device

    cfg = dict(MONODETR_MODEL, dropout=0.0, **(overrides or {}))
    model = copy.deepcopy(model) if model is not None else build_monodetr(cfg, seed=444).cuda()
    with torch.no_grad():  # encoder samples off integer positions (enc_offsets)
        for layer in model.depthaware_transformer.encoder.layers:
            bias = layer.self_attn.sampling_offsets.bias
            bias.copy_(torch.floor(bias * 16) / 16 + 1 / 32)
    plain = copy.deepcopy(model).use_plain_ops(True)
    crit = SetCriterion(cfg)
    b, _ = next(iter(SyntheticLoader(1, batch, 3, *size)))
    b = batch_to_device(b, "cuda")
    targets = {k: b[k] for k in TARGET_KEYS}
    runs = [(model, lap_solve, b["images"]), (plain, lap_solve_plain, b["images"])]
    if perturbed:
        runs.append((copy.deepcopy(plain), lap_solve_plain, b["images"] * (1 + 2 ** -23)))
    picks, results = None, []
    for m, lap, images in runs:
        matcher.lap_solve = lap
        try:
            out = m(images, b["calibs"], b["img_sizes"], train=True, proposal_idx=picks)
            matched = crit.match(out, targets)
            losses = crit(out, targets)
        finally:
            matcher.lap_solve = lap_solve
        crit.total(losses).backward()
        picks = out.get("proposal_idx") if picks is None else picks
        results.append((matched, losses, {n: p.grad for n, p in m.named_parameters()
                                          if p.grad is not None}))
    own = None
    if picks is not None:  # the plain run's own top-k against the pinned picks
        with torch.no_grad():
            mine = plain(b["images"], b["calibs"], b["img_sizes"], train=True)["proposal_idx"]
        own = np.mean([np.isin(a, p).mean() for a, p in zip(mine.cpu().numpy(),
                                                            picks.cpu().numpy())])
    (m_k, l_k, g_k), (m_p, l_p, g_p) = results[:2]
    same = all(torch.equal(m, m_p) for m, _, _ in results)
    loss_err = max(abs(l_k[k].item() - l_p[k].item()) / max(abs(l_p[k].item()), 1e-12)
                   for k in l_p)
    errs = grad_errors(g_k, g_p)
    if perturbed:  # each tensor against the nearer of the two plain steps
        other = grad_errors(g_k, results[2][2])
        past = {n: (e, other[n]) for n, e in errs.items() if e > 1.0}
        errs = {n: min(e, other[n]) for n, e in errs.items()}
    worst_name = max(errs, key=errs.get)
    diff = (g_k[worst_name] - g_p[worst_name]).abs().max().item()
    ok = (same and loss_err <= 1e-4 and g_k.keys() == g_p.keys()
          and errs[worst_name] <= 1.0 and (own is None or own >= 0.99))
    log(f"{label}: f32 step B={batch} {size[0]}x{size[1]}, dropout 0: matches identical {same}"
        + (" in all 3 runs" if perturbed else "") + f", losses max rel "
        f"{loss_err:.2e} (tol 1e-4), {len(g_p)} gradients: worst |a-b| / (1e-3 max|b| + 1e-6) "
        f"{errs[worst_name]:.3f} at {worst_name} (max|a-b| {diff:.2e}, max|b| "
        f"{g_p[worst_name].abs().max().item():.2e}) (<= 1"
        + ("; against the nearer of the plain steps on the images and on the images x "
           "(1 + 2^-23); past 1 against the first: "
           + (", ".join(f"{n} {e:.3f}, against the second {f:.3f}" for n, (e, f) in past.items())
              or "none") if perturbed else "")
        + ")"
        + (f"; plain runs pinned to the kernel run's {picks.shape[1]} proposal picks, the plain "
           f"run's own top-k holds {own:.4f} of them (>= 0.99)" if own is not None else "")
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the f32 step through the kernels disagrees")
    del model, plain, results, runs
    torch.cuda.empty_cache()


def phase_stress_remat():
    """One f32 step of the stress model (ResNet-101) at 768x2560, B=1,
    dropout 0.1 from one generator seed, without remat, with remat True and
    without again (two models built from one seed, remat off and on): the
    losses and the generator's final state bit-equal,
    and every gradient within REMAT_GRAD_TOL of its largest entry, beside
    the same measure between the two runs without remat (kernels 1 and 2
    sum the value gradient by atomics, in another order from run to run)."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.train_step import TARGET_KEYS, batch_to_device

    cfg = dict(MONODETR_MODEL, **STRESS, dtype="float32")
    models = {remat: build_monodetr(dict(cfg, remat=remat), seed=444).cuda()
              for remat in (False, True)}
    crit = SetCriterion(cfg)
    b = batch_to_device(next(iter(SyntheticLoader(1, 1, 6, *STRESS_SIZE)))[0], "cuda")
    targets = {k: b[k] for k in TARGET_KEYS}
    runs = []
    for remat in (False, True, False):
        model = models[remat]
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(11)
        out = model(b["images"], b["calibs"], b["img_sizes"], train=True, gen=gen)
        losses = crit(out, targets)
        crit.total(losses).backward()
        runs.append((torch.stack([losses[k].detach() for k in sorted(losses)]),
                     {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
                     gen.get_state()))
        del out, losses
    torch.cuda.synchronize()

    def worst(a, b):
        return max(((a[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                   for n, g in b.items())

    (l0, g0, s0), (l1, g1, s1), (l2, g2, s2) = runs
    remat_err, noise = worst(g1, g0), worst(g2, g0)
    ok = (torch.equal(l1, l0) and torch.equal(s1, s0) and torch.equal(s2, s0)
          and g1.keys() == g0.keys() and torch.isfinite(l0).all().item()
          and remat_err <= REMAT_GRAD_TOL)
    log(f"stress remat: f32 step, resnet101 768x2560 B=1, dropout 0.1, one seed: "
        f"losses bit-equal {torch.equal(l1, l0)}, generator state equal {torch.equal(s1, s0)}, "
        f"{len(g0)} gradients: worst max|remat - no remat| / max|no remat| {remat_err:.2e} (tol "
        f"{REMAT_GRAD_TOL:.0e}); two runs without remat: {noise:.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("stress: the step with remat differs from the step without")
    del models, model, runs
    torch.cuda.empty_cache()


def phase_two_stage_grouped():
    """two_stage at the config's group_num 11: its training forward gives 50
    proposals, which do not split into 11 groups; the train step raises the
    criterion's ValueError (the JAX matcher fails at a reshape there)."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(MONODETR_MODEL, two_stage=True)
    model = build_monodetr(cfg, seed=444).cuda()
    step = make_train_step(model, SetCriterion(cfg), build_optimizer({"type": "adamw"}, model),
                           compute_dtype(cfg))
    b = batch_to_device(next(iter(SyntheticLoader(1, 1, 4)))[0], "cuda")
    try:
        step(b, 2e-4, torch.Generator(device="cuda").manual_seed(0))
    except ValueError as e:
        ok = "two_stage" in str(e) and "group_num: 1" in str(e)
        log(f"two_stage at group_num 11: ValueError {'ok' if ok else 'FAIL'}: {e}")
        if not ok:
            raise
    else:
        raise RuntimeError("two_stage trained at group_num 11; want the criterion's ValueError")
    del model, step
    torch.cuda.empty_cache()


def phase_variants(add):
    """Phase 9: each query variant's train slice (2 steps), eval slice
    (with its f32 forward against the plain versions) and f32 step against
    the plain versions, all from one model built per variant; `add` takes
    each main-path run's launch counts.  Returns the second step's ms by
    variant."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.monodetr import build_monodetr

    ms = {}
    for name, overrides in VARIANTS.items():
        t0 = time.time()
        per_step = dict(DEFAULT_PER_STEP)
        if name == "two_stage":  # 50 x 1920 decoder depth cross-attention: plain
            per_step.update(attention_fwd=1, attention_bwd=1)
        base = build_monodetr(dict(MONODETR_MODEL, **overrides), seed=444).cuda()
        counts, ms[name], _ = phase_train_slice(f"{name} train", overrides, per_step, n_steps=2,
                                                base=base)
        add(counts)
        add(phase_eval_slice(f"{name} eval", overrides, 1, base=base))
        phase_train_vs_plain(f"{name} train vs plain", overrides, batch=1, perturbed=True,
                             model=base)
        del base
        log(f"{name}: phase 9 in {time.time() - t0:.1f} s")
    phase_two_stage_grouped()
    return ms


def phase_dp_nccl():
    """World size 1 over NCCL through init_distributed: one bf16 train step
    of the shipped model at batch 16, dropout 0.1, with dp against the step
    without from the same seeds, and a second step without: the losses and
    the generator's final state bit-equal, the all-reduce returns every
    gradient bit for bit, and the gradients of the step with dp differ from
    the first step's only as much as the second's do (the atomics of
    kernels 1 and 2 add in another order from run to run; in bf16 such a
    difference may flip a rounding).  Returns the dp step's launch counts."""
    import torch.distributed as dist

    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.parallel.ddp import DataParallel, init_distributed
    from monodetr_torch.parallel.dryrun import free_port
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    init_distributed("cuda")
    try:
        backend = dist.get_backend()
        dp = DataParallel()
        exact = []
        sum_grads = dp.sum_grads

        def checked_sum_grads(params):
            before = [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for p in params]
            sum_grads(params)
            exact.append(all(torch.equal(p.grad, g) for p, g in zip(params, before)))

        dp.sum_grads = checked_sum_grads
        cfg = dict(MONODETR_MODEL)
        b = batch_to_device(next(iter(SyntheticLoader(1, 16, 8)))[0], "cuda")
        runs, counts = [], None
        base = build_monodetr(cfg, seed=444).cuda()
        for use_dp in (False, True, False):
            model = copy.deepcopy(base)
            step = make_train_step(model, SetCriterion(cfg),
                                   build_optimizer({"type": "adamw", "lr": 2e-4}, model),
                                   compute_dtype(cfg), dp if use_dp else None)
            gen = torch.Generator(device="cuda").manual_seed(9)
            reset_launches()
            losses = step(b, 2e-4, gen)
            torch.cuda.synchronize()
            if use_dp:
                counts = main_path_counts(DEFAULT_PER_STEP, 1, "dp nccl")
            runs.append((losses.values, {n: p.grad for n, p in model.named_parameters()
                                         if p.grad is not None}, gen.get_state()))
            del model, step
        del base
    finally:
        dist.destroy_process_group()

    def worst(a, b):
        return max(((a[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                   for n, g in b.items())

    (l0, g0, s0), (l1, g1, s1), (l2, g2, s2) = runs
    dp_err, noise = worst(g1, g0), worst(g2, g0)
    ok = (backend == "nccl" and torch.equal(l1, l0) and torch.equal(s1, s0)
          and exact == [True] and g1.keys() == g0.keys() and torch.isfinite(l1).all().item()
          and dp_err <= GRAD_TOL[torch.bfloat16])
    log(f"dp nccl: world 1 over {backend}, bf16 step batch 16 384x1280, dropout 0.1: losses "
        f"bit-equal {torch.equal(l1, l0)}, generator state equal {torch.equal(s1, s0)}, "
        f"all-reduce returns every gradient bit for bit {exact == [True]}, {len(g0)} gradients: "
        f"worst max|dp - no dp| / max|no dp| {dp_err:.2e} (tol {GRAD_TOL[torch.bfloat16]:.0e}); "
        f"two steps without dp: {noise:.2e}; launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("dp nccl: the world-1 step differs from the step without dp")
    del runs
    torch.cuda.empty_cache()
    return counts


def phase_dp_gloo():
    """Two gloo ranks sharing cuda:0, 2 images each at 384x1280, the
    shipped widths and depths in f32 without dropout, against one process on
    the 4 (parallel/dryrun.py:compare_with_one_process): losses 1e-5
    relative, gradients within the train step's tolerance, every parameter
    after AdamW within 1e-5 of the difference its two gradients imply
    (dryrun.py:step_report), with at most 0.1% of the elements implied to
    differ by more than 1e-5, the parameters identical on both ranks, and
    the parallel eval step's gathered detections to 1e-4 of (1 + |b|) (cuDNN
    picks its algorithms by batch size).  Returns rank 0's launch counts of
    its dp step."""
    from monodetr_torch.parallel.dryrun import compare_with_one_process

    t0 = time.time()
    r = compare_with_one_process(2, "cuda:0", "gloo", 384, 1280, 2, 3, 3, timeout=600)
    ok = (r["loss_err"] <= 1e-5 and r["grad_err"] <= 1.0 and r["param_err"] <= 1e-5
          and r["moved_share"] <= 1e-3 and r["n_equal"] == 2
          and r["dets_shape"] == [4, 50, 37] and r["dets_err"] <= 1e-4
          and r["launches"] == DEFAULT_PER_STEP and r["backend"] == "gloo")
    log(f"dp gloo: 2 ranks on {r['device']} over {r['backend']}, 2 images each, f32 step vs one "
        f"process on 4: losses max rel {r['loss_err']:.2e} (tol 1e-5), {r['n_grads']} gradients: "
        f"worst |a-b| / (1e-3 max|b| + 1e-6) {r['grad_err']:.3f} (<= 1), parameters after AdamW "
        f"{r['param_err']:.2e} from the difference their gradients imply (tol 1e-5; implied "
        f"past 1e-5 for {100 * r['moved_share']:.4f}% of the elements, <= 0.1%, at most "
        f"{r['moved_max']:.2e}), identical on {r['n_equal']} of 2 ranks; eval "
        f"detections {r['dets_shape']} {r['dets_err']:.2e} (tol 1e-4); rank 0 launches "
        f"{r['launches']}; {time.time() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("dp gloo: the two-rank step differs from the one-process step")
    return r["launches"]


HANDOFF_IMAGES, HANDOFF_STEPS = 32, 6


def blocking_to_device(batch):
    """The handoff before data/device_prefetch.py: each array copied from
    pageable host memory by a copy that waits for the card."""
    from monodetr_torch.train.train_step import BATCH_KEYS

    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
        "cuda", torch.bool if k == "mask" else None) for k in BATCH_KEYS}


class BlockingHandoff:
    """DevicePrefetcher's interface over blocking_to_device: the trainer's
    loop as it was before the prefetcher."""

    def __init__(self, loader, device):
        self.loader = loader

    def __iter__(self):
        for batch, infos in self.loader:
            yield blocking_to_device(batch), batch, infos


def synthetic_kitti(root, n_train, n_val=2, seed=5):
    """tests/synthetic_kitti.py's KITTI tree (KITTI-size PNGs, 1242x375)
    under `root`, made once.  Imported by file: a `tests` package installed
    elsewhere would shadow the repo's."""
    sys.path.insert(1, os.path.join(REPO, "tests"))
    from synthetic_kitti import make_synthetic_kitti

    if not os.path.exists(os.path.join(root, "ImageSets", "train.txt")):
        make_synthetic_kitti(root, n_train=n_train, n_val=n_val, seed=seed, max_cars=6)
    return root


def phase_handoff():
    """Phase 11: the loader's batches through data/device_prefetch.py into
    the default bf16 train step.  A synthetic KITTI split of 32 images (the
    shipped dataset settings, 384x1280, the port's loader with 4 threads);
    6 steps at batch 16 with torch.cuda.set_sync_debug_mode("error") around
    the prefetch-and-step loop, so that any synchronizing call raises (the
    losses are read after the mode is reset); the same loop through the
    blocking copy raises under the same mode (the check can fail); every
    prefetched device batch equal, bit for bit, to the blocking copy of the
    same numpy batch; then the trainer's img/s over one epoch of the split
    through each handoff (smoke readings).  Returns the 6 steps' launch
    counts."""
    import logging

    from monodetr_torch.config import MONODETR_MODEL, load_config
    from monodetr_torch.data.device_prefetch import DevicePrefetcher
    from monodetr_torch.data.kitti_dataset import KITTIDataset
    from monodetr_torch.data.loader import DataLoader
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train import trainer as trainer_module
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import BATCH_KEYS, make_train_step

    t0 = time.time()
    root = synthetic_kitti(os.path.join(REPO, "tmp", "chip_smoke_kitti"), HANDOFF_IMAGES)
    cfg = load_config(os.path.join(REPO, "configs", "monodetr.yaml"))
    ds = KITTIDataset("train", dict(cfg["dataset"], root_dir=root))
    loader = DataLoader(ds, batch_size=16, shuffle=True, num_workers=4)
    model_cfg = dict(MONODETR_MODEL)
    model = build_monodetr(model_cfg, seed=444).cuda()
    opt = build_optimizer({"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, model)
    step = make_train_step(model, SetCriterion(model_cfg), opt, compute_dtype(model_cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)

    # the negative control, also the warm-up: the blocking copy raises
    torch.cuda.set_sync_debug_mode("error")
    batches = iter(loader)
    try:
        for batch, _ in batches:
            step(blocking_to_device(batch), 2e-4, gen)
        blocking_error = None
    except RuntimeError as e:
        blocking_error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        batches.close()
    step(blocking_to_device(next(iter(loader))[0]), 2e-4, gen)
    torch.cuda.synchronize()

    reset_launches()
    losses, seen = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for epoch in range(HANDOFF_STEPS * 16 // HANDOFF_IMAGES):
            loader.set_epoch(epoch)
            for on_card, batch, _ in DevicePrefetcher(loader, "cuda"):
                losses.append(step(on_card, 2e-4, gen))
                seen.append((on_card, batch))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = main_path_counts(train_launches(DEFAULT_PER_STEP, HANDOFF_STEPS, before=1), 1,
                              "handoff")
    totals = [float(lv.as_dict()["loss_detr"]) for lv in losses]

    def same(on_card, batch):
        blocking = blocking_to_device(batch)
        return all(on_card[k].dtype == blocking[k].dtype and torch.equal(on_card[k], blocking[k])
                   for k in BATCH_KEYS)

    equal = all(same(on_card, batch) for on_card, batch in seen)
    ok = (len(losses) == HANDOFF_STEPS and np.isfinite(totals).all() and equal
          and blocking_error is not None and "synchroniz" in blocking_error)
    log(f"handoff: {HANDOFF_STEPS} bf16 train steps at batch 16 on {len(ds)} synthetic KITTI "
        f"images through the prefetcher under sync debug mode 'error': loss_detr "
        + " ".join(f"{t:.3f}" for t in totals)
        + f"; the blocking copy under the same mode raised: {blocking_error!r}; prefetched "
        f"batches bit-equal to the blocking copies: {equal}; launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("handoff: a sync on the prefetched path, no raise on the blocking "
                           "path, or a prefetched batch that differs")
    del model, opt, step, seen, losses

    logger = logging.getLogger("chip_smoke")
    rates = {}
    for name, handoff in (("prefetched", DevicePrefetcher), ("blocking", BlockingHandoff)):
        model = build_monodetr(model_cfg, seed=444).cuda()
        trainer_module.DevicePrefetcher = handoff
        try:
            trainer = trainer_module.Trainer(
                {"max_epoch": 195}, model, SetCriterion(model_cfg), loader,
                {"warmup": False}, {"type": "adamw", "lr": 2e-4}, logger, "chip_smoke",
                device="cuda", compute_dtype=compute_dtype(model_cfg), seed=444)
            trainer.train_one_epoch(0)  # warm-up
            t1 = time.time()
            trainer.train_one_epoch(1)  # ends in a synchronize
            rates[name] = len(ds) / (time.time() - t1)
        finally:
            trainer_module.DevicePrefetcher = DevicePrefetcher
        del model, trainer
    torch.cuda.empty_cache()
    log(f"handoff: Trainer.train_one_epoch over the {len(ds)} images, batch 16, after a warm-up "
        f"epoch (host clock, smoke readings): prefetched {rates['prefetched']:.1f} img/s, "
        f"blocking {rates['blocking']:.1f} img/s; phase 11 in {time.time() - t0:.1f} s")
    return counts


LAUNCH_REPORT = (
    "import json, runpy, sys; sys.path.insert(0, %r); sys.argv = [%r] + %r; "
    "runpy.run_path(%r, run_name='__main__'); "
    "import chip_smoke; print('launches ' + json.dumps(chip_smoke.read_launches()))")


def run_counted(tool, args, cwd, timeout, env=None):
    """`python tool args` in a process of its own, from `cwd` (with `env`),
    and that process's launches of the kernels (KERNELS' wrappers): (exit
    code, launch counts or None, output tail, the tool's own stdout lines)."""
    code = LAUNCH_REPORT % (REPO, tool, list(args), tool)
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)
    counts, lines = None, []
    for line in proc.stdout.splitlines():
        if line.startswith("launches "):
            counts = {k: v for k, v in json.loads(line[len("launches "):]).items() if v}
        else:
            lines.append(line)
    return proc.returncode, counts, (proc.stdout + proc.stderr)[-2000:], lines


CLI_TOOL = os.path.join(REPO, "tools", "train_val_torch.py")
CLI_PER_FORWARD = {"msda_enc_fused": 3, "msda_sep": 3, "attention_fwd": 1}


def cli_config(workdir, epochs, **sections):
    """A fresh `workdir` holding phase 12's split (8 synthetic KITTI images,
    val == train) and tools/overfit_synthetic_torch.py's config for it at
    `epochs` (batch 8, one epoch a step, the tester at the last epoch and
    after training; threshold 0, so every image gets its 50 rows), each
    config section updated from `sections`; (its path, the config)."""
    import shutil

    import yaml

    sys.path.insert(1, os.path.join(REPO, "tools"))
    from overfit_synthetic_torch import make_config

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    root = synthetic_kitti(os.path.join(workdir, "kitti"), 8, seed=3)
    with open(os.path.join(root, "ImageSets", "train.txt")) as f:
        ids = f.read()
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write(ids)
    cfg_path = make_config(workdir, root, 8, epochs)
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["tester"]["threshold"] = 0.0
    for name, values in sections.items():
        cfg[name].update(values)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path, cfg


def run_cli(label, cfg_path, workdir, extra, want):
    """tools/train_val_torch.py --config cfg_path --device cuda (+ extra) in
    a process of its own, from `workdir`: it must exit 0, write one txt of
    50 rows for each of the 8 images and launch exactly `want`; returns its
    launch counts."""
    import shutil

    data = os.path.join(workdir, "outputs", "overfit", "outputs", "data")
    shutil.rmtree(data, ignore_errors=True)
    rc, counts, tail, _ = run_counted(CLI_TOOL, ["--config", cfg_path, "--device", "cuda"]
                                      + extra, workdir, 600)
    txts = sorted(os.listdir(data)) if os.path.isdir(data) else []
    rows = [len(open(os.path.join(data, t)).read().splitlines()) for t in txts]
    ok = rc == 0 and counts == want and len(txts) == 8 and set(rows) == {50}
    log(f"{label}: tools/train_val_torch.py exit {rc}, {len(txts)} txts of "
        f"{sorted(set(rows))} rows, launches {counts} (want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: {tail}")
    return counts


def phase_cli():
    """Phase 12: the port's CLI (tools/train_val_torch.py) on the card: 2
    epochs on 8 synthetic KITTI images (cli_config), then `-e`; each must
    exit 0 and write one txt of 50 rows per image.  Each run is a process
    of its own; its launches are counted there (2 train steps and 2 eval
    batches; 1 eval batch) and returned."""
    t0 = time.time()
    workdir = os.path.join(REPO, "tmp", "chip_smoke_cli")
    cfg_path, _ = cli_config(workdir, 2)
    want = {"train": {k: 2 * DEFAULT_PER_STEP.get(k, 0) + 2 * CLI_PER_FORWARD.get(k, 0)
                      for k in DEFAULT_PER_STEP},
            "-e": CLI_PER_FORWARD}
    totals = dict.fromkeys(KERNELS, 0)
    for name, extra in (("train", []), ("-e", ["-e"])):
        for k, v in run_cli(f"cli {name}", cfg_path, workdir, extra, want[name]).items():
            totals[k] += v
    log(f"phase 12 (CLI) in {time.time() - t0:.1f} s")
    return {k: v for k, v in totals.items() if v}


CLAMP_STEPS, CLAMP_BATCH, CLAMP_MAX_REL = 10, 2, 0.1


def phase_clamp():
    """Phase 13: tools/validate_clamp_torch.py, short: fused at G=6 against
    gather, 10 bf16 steps at batch 2, 384x1280, from identical parameters
    and dropout draws; both loss trajectories finite and their largest
    step-wise relative difference within CLAMP_MAX_REL.  Returns the launch
    counts (gather: kernels 2-4; fused: 1-4)."""
    sys.path.insert(1, os.path.join(REPO, "tools"))
    from validate_clamp_torch import run

    t0 = time.time()
    reset_launches()
    r = run(steps=CLAMP_STEPS, batch=CLAMP_BATCH, impl="fused", window=6, device="cuda",
            decode=False)
    torch.cuda.synchronize()
    gather_step = {k: v for k, v in DEFAULT_PER_STEP.items() if not k.startswith("msda_enc")}
    counts = {k: v for k, v in read_launches().items() if v}
    fused, gather = (train_launches(per, CLAMP_STEPS) for per in (DEFAULT_PER_STEP, gather_step))
    want = {k: fused[k] + gather.get(k, 0) for k in DEFAULT_PER_STEP}
    finite = np.isfinite(r["traj_gather"] + r["traj_fused"]).all()
    ok = finite and r["max_rel_diff"] <= CLAMP_MAX_REL and counts == want
    log(f"clamp: validate_clamp_torch fused G=6 vs gather, {CLAMP_STEPS} bf16 steps batch "
        f"{CLAMP_BATCH} 384x1280: loss_detr gather "
        + " ".join(f"{v:.3f}" for v in r["traj_gather"])
        + "; fused " + " ".join(f"{v:.3f}" for v in r["traj_fused"])
        + f"; max rel diff {r['max_rel_diff']:.4f} (<= {CLAMP_MAX_REL}), final "
        f"{r['final_rel_diff']:.4f}; launches {counts} (want {want}); {time.time() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("clamp: trajectories not finite, apart, or launches wrong")
    torch.cuda.empty_cache()
    return counts


MATCH_CASES = 6  # seeds, each with compute_fp off and on


def match_case(rng, n_gt, n_dt):
    """A random matching problem (tests/test_kitti_eval.py:random_case)."""
    overlaps = rng.rand(n_dt, n_gt)
    gt = np.concatenate([rng.rand(n_gt, 4) * 100, rng.uniform(-np.pi, np.pi, (n_gt, 1))], 1)
    dt = np.concatenate([rng.rand(n_dt, 4) * 100, rng.uniform(-np.pi, np.pi, (n_dt, 1)),
                         rng.rand(n_dt, 1)], 1)
    ignored_gt = rng.choice([-1, 0, 1], n_gt, p=[0.2, 0.6, 0.2])
    ignored_det = rng.choice([-1, 0, 1], n_dt, p=[0.2, 0.6, 0.2])
    return overlaps, gt, dt, ignored_gt, ignored_det, rng.rand(2, 4) * 100


def phase_host_kernels():
    """Phase 14: the host kernels of the loader and the evaluator
    (csrc/kitti_native.cpp, built in phase 2) on this host's CPU against
    their plain versions, at the tolerances of tests/test_native.py and
    tests/test_native_match.py: the warp of each of phase 11's 32 synthetic
    KITTI images (1242x375 -> 1280x384) against PIL's (the interior within
    1.5 uint8 steps at most and half a step on average), the rotated IoU
    against the numpy clip (1e-4), 12 matching problems against the numpy
    matcher (equal counts, similarity and scores to rtol 1e-9), and the
    whole official evaluation of noisy copies of the split's labels, native
    against plain (rtol 1e-9).  Then the loader's cost per image on this
    host, one thread, host clock (smoke readings, medians over the 32):
    PNG decode, the warp (native and plain), the target encoding, and the
    whole KITTIDataset.__getitem__ with the shipped augmentation."""
    from monodetr_torch import native
    from monodetr_torch.config import load_config
    from monodetr_torch.data.kitti_dataset import KITTIDataset, warp_plain
    from monodetr_torch.data.kitti_utils import get_affine_transform
    from monodetr_torch.eval.kitti_eval import eval as ev, kitti_common
    from monodetr_torch.eval.kitti_eval.rotated_iou import rotate_iou_eval_plain

    t0 = time.time()
    root = synthetic_kitti(os.path.join(REPO, "tmp", "chip_smoke_kitti"), HANDOFF_IMAGES)
    cfg = load_config(os.path.join(REPO, "configs", "monodetr.yaml"))
    ds = KITTIDataset("train", dict(cfg["dataset"], root_dir=root))
    width, height = (int(v) for v in ds.resolution)
    tol = (1.0 / 255.0) / ds.std.min() + 1e-4
    ms = {k: [] for k in ("decode", "warp", "warp plain", "targets", "item")}
    warp_max = warp_mean = 0.0

    def clock(stage, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        ms[stage].append(1e3 * (time.perf_counter() - t))
        return out

    for i, name in enumerate(ds.idx_list):
        idx = int(name)
        img = ds.get_image(idx)
        arr = clock("decode", lambda: np.asarray(img, np.uint8))
        img_size = np.array(img.size)
        trans, trans_inv = get_affine_transform(img_size / 2, img_size, 0, ds.resolution, inv=1)
        got = clock("warp", native.warp_affine_normalize, arr, trans_inv, width, height,
                    ds.mean, ds.std)
        want = clock("warp plain", warp_plain, img, trans_inv, ds.resolution, ds.mean, ds.std)
        diff = np.abs(got - want)[4:-4, 4:-4]
        warp_max, warp_mean = max(warp_max, float(diff.max())), max(warp_mean, float(diff.mean()))
        clock("targets", lambda: ds._encode_targets(ds.get_label(idx), ds.get_calib(idx), trans,
                                                    img_size, False, 1))
        np.random.seed(i)
        clock("item", ds.__getitem__, i)
    ok_warp = warp_max < 1.5 * tol and warp_mean < 0.5 * tol

    rng = np.random.RandomState(2)
    boxes = np.stack([rng.uniform(-10, 10, 40), rng.uniform(0, 60, 40), rng.uniform(1, 5, 40),
                      rng.uniform(1, 3, 40), rng.uniform(-np.pi, np.pi, 40)], -1)
    qboxes = boxes[:25] + rng.randn(25, 5) * 0.3
    iou_err = max(float(np.abs(native.rotated_iou(boxes, qboxes, c)
                               - rotate_iou_eval_plain(boxes, qboxes, c)).max())
                  for c in (-1, 0, 1, 2))
    ok_match = True
    for seed in range(MATCH_CASES):
        for compute_fp in (False, True):
            overlaps, gt, dt, ig, idt, dc = match_case(np.random.RandomState(seed), 14, 18)
            threshs = [0.0, 0.25, 0.5, 0.75] if compute_fp else [0.0]
            a = native.match_image(overlaps, dt[:, -1], dt[:, 4], gt[:, 4], dt[:, :4], ig, idt,
                                   dc, 0, 0.5, np.asarray(threshs), compute_fp, True)
            b = ev._match_image_np(overlaps, gt, dt, ig, idt, dc, 0, 0.5, threshs, compute_fp,
                                   True)
            ok_match &= all(np.array_equal(a[j], b[j]) for j in ((0, 2, 1) if compute_fp
                                                                  else (0, 2)))
            ok_match &= not compute_fp or np.allclose(a[3], b[3], rtol=1e-9, atol=0)
            ok_match &= all(np.allclose(sorted(x), sorted(y), rtol=1e-9, atol=0)
                            for x, y in zip(a[4], b[4]))

    gt_annos = kitti_common.get_label_annos(ds.label_dir, [int(i) for i in ds.idx_list])
    dt_annos = []
    for anno in gt_annos:
        dt = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in anno.items()}
        dt["location"] = dt["location"] + rng.randn(*dt["location"].shape) * 0.4
        dt["score"] = rng.uniform(0.5, 1.0, len(dt["location"]))
        dt_annos.append(dt)
    _, ret_native, ap_native = ev.get_official_eval_result(gt_annos, dt_annos, 0)
    kernels = (ev.rotate_iou_eval, ev._match_image)
    ev.rotate_iou_eval, ev._match_image = rotate_iou_eval_plain, ev._match_image_np
    try:
        _, ret_plain, ap_plain = ev.get_official_eval_result(gt_annos, dt_annos, 0)
    finally:
        ev.rotate_iou_eval, ev._match_image = kernels
    ok_eval = ret_native.keys() == ret_plain.keys() and np.allclose(
        ap_native, ap_plain, rtol=1e-9, atol=0) and all(
        np.allclose(ret_native[k], ret_plain[k], rtol=1e-9, atol=0) for k in ret_plain)
    ok = ok_warp and iou_err <= 1e-4 and ok_match and ok_eval
    log(f"host kernels: warp vs PIL on {len(ds)} synthetic KITTI images, interior max "
        f"{warp_max:.4f} / mean {warp_mean:.4f} (< {1.5 * tol:.4f} / {0.5 * tol:.4f}); "
        f"rotated IoU vs numpy max {iou_err:.2e} (<= 1e-4); match_image vs numpy on "
        f"{2 * MATCH_CASES} problems equal: {ok_match}; official eval native vs plain equal: "
        f"{ok_eval} (Car 3d R40 moderate {float(np.ravel(ap_native)[0]):.4f}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("host kernels: a host kernel disagrees with its plain version")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"host kernels: loader cost per image on this host ({os.cpu_count()} cores, one thread, "
        f"host clock, median of {len(ds)}; smoke readings): PNG decode {med['decode']:.2f} ms, "
        f"warp native {med['warp']:.2f} ms (plain {med['warp plain']:.2f} ms), target encoding "
        f"{med['targets']:.2f} ms; the whole KITTIDataset.__getitem__ with the shipped "
        f"augmentation {med['item']:.2f} ms; phase 14 in {time.time() - t0:.1f} s")
    return med


def torchvision_resnet50(body, gen):
    """A seeded random state dict in torchvision's ResNet-50 layout: the
    port backbone's names without `backbone.0.body.`, BN with running
    statistics and num_batches_tracked, and the fc head."""
    from monodetr_torch.models.backbone import FrozenBatchNorm2d

    bns = {n for n, m in body.named_modules() if isinstance(m, FrozenBatchNorm2d)}
    sd = {}
    for name, t in body.state_dict().items():
        module, kind = name.rsplit(".", 1)
        if module in bns:
            sd[name] = {"weight": torch.rand(t.shape, generator=gen) + 0.5,
                        "bias": torch.randn(t.shape, generator=gen) * 0.01,
                        "running_mean": torch.randn(t.shape, generator=gen) * 0.01,
                        "running_var": torch.rand(t.shape, generator=gen) + 0.5}[kind]
            if kind == "running_var":
                sd[module + ".num_batches_tracked"] = torch.tensor(1000)
        else:
            sd[name] = torch.randn(t.shape, generator=gen) / np.sqrt(t[0].numel())
    sd["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd, bns


def folded(state, prefix):
    """A FrozenBN's (scale, bias) in f64 from its four tensors."""
    w, b, rm, rv = (state[f"{prefix}.{k}"].double().cpu()
                    for k in ("weight", "bias", "running_mean", "running_var"))
    scale = w / (rv + 1e-5).sqrt()
    return scale, b - rm * scale


def convert_checkpoint(args, label):
    """tools/convert_checkpoint_torch.py args, in a process of its own."""
    tool = os.path.join(REPO, "tools", "convert_checkpoint_torch.py")
    proc = subprocess.run([sys.executable, tool] + args, capture_output=True, text=True,
                          timeout=300)
    log(f"{label}: tools/convert_checkpoint_torch.py exit {proc.returncode}: "
        f"{proc.stdout.strip()[-300:]}")
    if proc.returncode != 0 or "converted" not in proc.stdout:
        raise RuntimeError(f"{label}: {(proc.stdout + proc.stderr)[-2000:]}")


def phase_pretrained_start():
    """Phase 15: the pretrained start through the port alone.  (1) A seeded
    random state dict in torchvision's ResNet-50 layout (torch.save),
    converted by tools/convert_checkpoint_torch.py --torchvision-backbone
    resnet50; the Trainer that the CLI builds, given it as
    trainer.pretrain_model, holds before its first step every backbone
    conv weight bit-equal to the source's and each FrozenBN's folded affine
    within 1e-6 of the source's; then the CLI trains 1 epoch on phase 12's
    8 images from it and evaluates (exit 0, the tester's rows, 1 step and 2
    eval batches of launches).  (2) A reference-layout .pth (a seeded port
    model's state_dict, FrozenBN statistics drawn as a trained checkpoint's,
    plus the reference's dead sa_v_proj and label_enc) converted by the
    same tool and evaluated by the CLI with -e (exit 0, the rows, 1 eval
    batch of launches); loaded by Tester.load, its detections on one batch
    of 2 equal those of the model it came from, f32 with TF32 off, within
    phase 5's tolerance (max |a - b| / (1 + |b|) <= 1e-3), and so do the raw
    forward outputs.  Returns the two CLI runs' launch counts."""
    import logging

    import yaml

    from monodetr_torch.eval.tester import Tester
    from monodetr_torch.models.backbone import FrozenBatchNorm2d
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train.trainer import Trainer

    t0 = time.time()
    logger = logging.getLogger("chip_smoke")
    workdir = os.path.join(REPO, "tmp", "chip_smoke_pretrained")
    pretrain = os.path.join(workdir, "resnet50_imagenet_converted")
    cfg_path, cfg = cli_config(workdir, 1, trainer={"pretrain_model": pretrain + ".pth"})
    mcfg = cfg["model"]

    # (1) the ImageNet backbone into trainer.pretrain_model
    model = build_monodetr(mcfg, seed=cfg["random_seed"])
    body = model.backbone[0].body
    src, bns = torchvision_resnet50(body, torch.Generator().manual_seed(15))
    torch.save(src, os.path.join(workdir, "resnet50_imagenet.pth"))
    convert_checkpoint([os.path.join(workdir, "resnet50_imagenet.pth"), pretrain,
             "--torchvision-backbone", "resnet50"], "pretrained backbone")
    model = model.cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    Trainer(cfg["trainer"], model, SetCriterion(mcfg), None, cfg["lr_scheduler"],
            cfg["optimizer"], logger, "chip_smoke_pretrained", device="cuda",
            compute_dtype=compute_dtype(mcfg), seed=cfg["random_seed"])
    state = model.state_dict()
    prefix = "backbone.0.body."
    convs = [k for k in src if not k.startswith("fc.") and k.rsplit(".", 1)[0] not in bns]
    conv_equal = all(torch.equal(state[prefix + k].cpu(), src[k]) for k in convs)
    bn_err = max(float((a - b).abs().max()) for bn in bns
                 for a, b in zip(folded(state, prefix + bn), folded(src, bn)))
    rest_unchanged = all(torch.equal(v, init[k]) for k, v in state.items()
                         if not k.startswith(prefix))
    ok = conv_equal and bn_err <= 1e-6 and rest_unchanged and len(convs) == len(bns) == 53
    log(f"pretrained backbone: before the first step, {len(convs)} conv weights bit-equal to "
        f"the torchvision state dict: {conv_equal}; {len(bns)} FrozenBN folded affines max "
        f"|diff| {bn_err:.2e} (<= 1e-6); every other entry as initialised: {rest_unchanged} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("pretrained backbone: the merged backbone differs from its source")
    del model, init, state
    totals = dict.fromkeys(KERNELS, 0)
    want = {k: DEFAULT_PER_STEP.get(k, 0) + 2 * CLI_PER_FORWARD.get(k, 0)
            for k in DEFAULT_PER_STEP}
    for k, v in run_cli("pretrained cli train", cfg_path, workdir, [], want).items():
        totals[k] += v

    # (2) a reference-layout MonoDETR .pth, converted, evaluated with -e
    gen = torch.Generator().manual_seed(16)
    source = build_monodetr(mcfg, seed=777)
    sd = source.state_dict()
    for bn in (n for n, m in source.named_modules() if isinstance(m, FrozenBatchNorm2d)):
        for kind, draw in (("weight", lambda t: torch.rand(t.shape, generator=gen) + 0.5),
                           ("bias", lambda t: torch.randn(t.shape, generator=gen) * 0.1),
                           ("running_mean", lambda t: torch.randn(t.shape, generator=gen) * 0.1),
                           ("running_var", lambda t: torch.rand(t.shape, generator=gen) + 0.5)):
            sd[f"{bn}.{kind}"] = draw(sd[f"{bn}.{kind}"])
    source.load_state_dict(sd)
    reference = dict(sd)
    hidden = mcfg["hidden_dim"]
    for i in range(mcfg["dec_layers"]):  # dead in the reference, skipped by the converter
        d = f"depthaware_transformer.decoder.layers.{i}.sa_v_proj"
        reference[d + ".weight"] = torch.randn(hidden, hidden, generator=gen) * 0.05
        reference[d + ".bias"] = torch.zeros(hidden)
    reference["label_enc.weight"] = torch.randn(mcfg["num_classes"] + 1, hidden - 1,
                                                generator=gen)
    ref_path = os.path.join(workdir, "monodetr_reference.pth")
    torch.save({"model_state": reference, "epoch": 195, "best_result": 0.0, "best_epoch": 0},
               ref_path)
    converted = os.path.join(workdir, "monodetr_reference_converted")
    convert_checkpoint([ref_path, converted], "reference checkpoint")
    cfg["tester"]["checkpoint_path"] = converted + ".pth"
    eval_path = os.path.join(workdir, "eval.yaml")
    with open(eval_path, "w") as f:
        yaml.safe_dump(cfg, f)
    for k, v in run_cli("reference cli -e", eval_path, workdir, ["-e"], CLI_PER_FORWARD).items():
        totals[k] += v

    tol = 1e-3
    batch, _ = next(iter(SyntheticLoader(1, 2, 1)))
    args = [batch[k] for k in ("images", "calibs", "img_sizes")]
    testers = {}
    for name, m in (("converted", build_monodetr(mcfg, seed=1)), ("source", source)):
        testers[name] = Tester(cfg["tester"], m.cuda().float(), None, logger, cfg["trainer"],
                               "chip_smoke_pretrained", device="cuda")
    testers["converted"].load(converted + ".pth")
    dets = {name: t.predict(*args) for name, t in testers.items()}
    with torch.no_grad():
        inputs = [torch.from_numpy(a).cuda() for a in args]
        raw = {name: t.model(*inputs) for name, t in testers.items()}
    torch.cuda.synchronize()
    errs = {"detections": float((np.abs(dets["converted"] - dets["source"])
                                 / (1 + np.abs(dets["source"]))).max())}
    for k in ("pred_logits", "pred_boxes", "pred_depth", "pred_3d_dim", "pred_angle"):
        a, b = raw["converted"][k], raw["source"][k]
        errs[k] = ((a - b).abs() / (1 + b.abs())).max().item()
    ok = dets["converted"].shape == (2, 50, 37) and np.isfinite(dets["converted"]).all() and all(
        e <= tol for e in errs.values())
    log("reference checkpoint: Tester.load of the converted .pth against the model it came "
        "from, f32 B=2 384x1280: " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("reference checkpoint: the converted model's detections differ")
    del testers, source, raw
    torch.cuda.empty_cache()
    log(f"phase 15 (pretrained start) in {time.time() - t0:.1f} s")
    return {k: v for k, v in totals.items() if v}


BENCH_TOOL = os.path.join(REPO, "bench_torch.py")
# each run's environment; the stress configuration as bench.py:61-62 spells it
BENCH_RUNS = (("default", {}), ("stress", {"BENCH_BACKBONE": "resnet101", "BENCH_H": "768",
                                           "BENCH_W": "2560", "BENCH_BS": "2",
                                           "BENCH_REMAT": "1"}))


def phase_bench():
    """Phase 16: `python bench_torch.py` in a process of its own for each
    of BENCH_RUNS: exit 0, bench.py's JSON line as the last stdout line
    (its keys in its order, 3 positive runs, flops_per_img > 0, 0 < mfu <
    1), and the default path's launches over the bench's warm-up and
    timed steps (train_launches: with remat every step's, else the eager
    and the capture step's and the LAP of every step), plus the LAP of the
    FLOP count's step (its other kernels run their plain versions).
    Prints each JSON line on a line of its own; returns the launch
    counts."""
    from monodetr_torch import bench

    t0 = time.time()
    steps = bench.WARMUP_STEPS + bench.WINDOWS * bench.WINDOW_STEPS
    totals = dict.fromkeys(KERNELS, 0)
    for label, env in BENCH_RUNS:
        graphed = env.get("BENCH_REMAT", "0") == "0"
        want = {k: v + (k == "lap")
                for k, v in train_launches(DEFAULT_PER_STEP, steps, graphed=graphed).items()}
        t1 = time.time()
        rc, counts, tail, lines = run_counted(BENCH_TOOL, [], REPO, 600,
                                              env=dict(os.environ, **env))
        try:
            line = json.loads(lines[-1])
        except (IndexError, ValueError):
            line = {}
        runs = line.get("runs", [])
        ok = (rc == 0 and list(line) == list(bench.KEYS) and len(runs) == bench.WINDOWS
              and all(r > 0 for r in runs) and line["flops_per_img"] > 0
              and 0 < line["mfu"] < 1 and counts == want)
        log(f"bench {label} {env or '(default environment)'}: bench_torch.py exit {rc}, "
            f"launches {counts} (want {want}), {time.time() - t1:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"bench {label}: {tail}")
        log(next((t for t in tail.splitlines() if t.startswith("bench_torch: ")),
                 "bench_torch: (its stderr line is not in the output's tail)"))
        log(lines[-1])
        for k, v in counts.items():
            totals[k] += v
    log(f"phase 16 (bench) in {time.time() - t0:.1f} s")
    return {k: v for k, v in totals.items() if v}


def phase_learning_loop(add):
    """Phases 11-15; `add` takes the launch counts of each main-path run."""
    t0 = time.time()
    add(phase_handoff())
    add(phase_cli())
    add(phase_clamp())
    phase_host_kernels()
    add(phase_pretrained_start())
    log(f"phases 11-15 (handoff, CLI, clamp, host kernels, pretrained start) in "
        f"{time.time() - t0:.1f} s")


def main(argv):
    if argv not in ([], ["--decoder-msda-only"], ["--encoder-msda-only"], ["--lap-only"],
                    ["--learning-loop-only"], ["--bench-only"], ["--backbone-only"]):
        sys.exit("usage: python3 chip_smoke.py [--decoder-msda-only | --encoder-msda-only | "
                 f"--lap-only | --learning-loop-only | --bench-only | --backbone-only], "
                 f"not {argv}")
    phase_environment()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--lap-only"]:
        phase_lap()
        return
    if argv == ["--learning-loop-only"]:
        phase_learning_loop(lambda counts: None)
        return
    if argv == ["--bench-only"]:
        phase_bench()
        return
    if argv == ["--backbone-only"]:
        phase_backbone_epilogues()
        return
    if argv == ["--encoder-msda-only"]:
        phase_forward_kernels([n for n in FORWARD_KERNELS if n in ENC_KERNELS])
        phase_backward_kernels([n for n in BACKWARD_KERNELS if n in ENC_KERNELS])
        phase_enc_clustered()
        return
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
    backbone = phase_backbone_epilogues()
    report.update(phase_lap())
    phase_dtype_policy()
    totals = dict.fromkeys([*KERNELS, BACKBONE], 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    add(phase_eval_slice())
    phase_train_vs_plain()
    counts, default_ms, _ = phase_train_slice()
    add(counts)
    a_step = {"msda_pallas": 3, "msda_pallas_bwd": 3, "msda_dense_fused": 3,
              "msda_dense_fused_bwd": 3, "attention_fwd": 4, "attention_bwd": 4, "lap": 1}
    b_step = {"msda_sepwin": 3, "msda_sepwin_bwd": 3, "msda_sep": 3, "msda_sep_bwd": 3,
              "attention_fwd": 4, "attention_bwd": 4, "lap": 1}
    counts, a_ms, _ = phase_train_slice("config A train", CONFIG_A, a_step, n_steps=4)
    add(counts)
    add(phase_eval_slice("config A eval", CONFIG_A, 1, {"msda_pallas": 3, "msda_dense_fused": 3,
                                                        "attention_fwd": 1}, check_plain=False))
    phase_train_vs_plain("config A train vs plain", CONFIG_A)
    counts, b_ms, _ = phase_train_slice("config B train", CONFIG_B, b_step, n_steps=4)
    add(counts)
    phase_train_vs_plain("config B train vs plain", CONFIG_B)
    log(f"train ms/step, bf16 batch 16, steps 3 on: default (fused + sep) {default_ms:.1f}, "
        f"A (pallas + dense_fused) {a_ms:.1f}, B (sepwin + sep) {b_ms:.1f}")
    counts, stress_ms, stress_peak = phase_train_slice(
        "stress train", STRESS, DEFAULT_PER_STEP, n_steps=3, batch=STRESS_BATCH, size=STRESS_SIZE)
    add(counts)
    _, flat_ms, flat_peak = phase_train_slice(
        "stress train, remat off", dict(STRESS, remat=False), DEFAULT_PER_STEP, n_steps=2,
        batch=STRESS_BATCH, size=STRESS_SIZE)
    log(f"stress: resnet101 768x2560 batch 2 bf16, peak memory remat True {stress_peak:.2f} GiB, "
        f"remat off {flat_peak:.2f} GiB; ms/step (smoke readings) {stress_ms:.1f} and "
        f"{flat_ms:.1f}")
    add(phase_eval_slice("stress eval", STRESS, 1, batch=STRESS_BATCH, size=STRESS_SIZE))
    phase_train_vs_plain("stress train vs plain", STRESS, batch=1, size=STRESS_SIZE)
    phase_stress_remat()
    t0 = time.time()
    variant_ms = phase_variants(add)
    log(f"phase 9 (query variants) in {time.time() - t0:.1f} s")
    log(f"train ms/step, bf16 batch 16 (smoke readings): default (fused + sep, steps 3-6) "
        f"{default_ms:.1f}; step 2: " + ", ".join(f"{k} {v:.1f}" for k, v in variant_ms.items()))
    t0 = time.time()
    add(phase_dp_nccl())
    add(phase_dp_gloo())
    log(f"phase 10 (data parallel) in {time.time() - t0:.1f} s")
    phase_learning_loop(add)
    add(phase_bench())
    idle = [k for k, v in totals.items() if v == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the main path: {idle}")
    log(json.dumps(windowed_backward))
    log(json.dumps({"kernels": [
        dict(name=name, route=spec["route"], source=spec["source"],
             replaces=spec["replaces"], launches=totals[name], **report[name])
        for name, spec in KERNELS.items()]
        + [dict(name=BACKBONE, route="cuda", source="monodetr_torch/csrc/backbone.cu",
                replaces="monodetr_tpu/models/backbone.py:157",
                launches=totals[BACKBONE], kernels=backbone)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
