"""Reduces a torch.profiler run over a few steps to the record that the
per-layer readers take: every device operation's interval, name, group and
component, and the host operation whose launch ended each idle gap.

Groups (kernel-name substrings, first match wins) and the attribution of a
kernel to a component are copies of monodetr_torch/profile_train.py's
GROUPS and event_components: a kernel goes to the innermost profiler range
named `component::<name>` around the operator that launched it, and a
kernel of the backward to the range of the forward operator that made its
autograd node (the node's sequence number and forward thread).  The
program opens those ranges only while a profiler records.
"""

from collections import defaultdict

import torch

COMPONENT_PREFIX = "component::"
GROUPS = (
    ("msda_enc_fused_bwd", "encoder MSDA bwd (kernel 1)"),
    ("msda_enc_fused", "encoder MSDA fwd (kernel 1)"),
    ("msda_pallas_bwd", "encoder MSDA bwd (kernel 5)"),
    ("msda_pallas", "encoder MSDA fwd (kernel 5)"),
    ("msda_sepwin_bwd", "encoder MSDA bwd (kernel 6)"),
    ("msda_sepwin", "encoder MSDA fwd (kernel 6)"),
    ("msda_dense_fused_bwd_bin", "decoder MSDA bwd, binning (kernel 7)"),
    ("msda_dense_fused_bwd_value", "decoder MSDA bwd, value side (kernel 7)"),
    ("msda_dense_fused", "decoder MSDA fwd (kernel 7)"),
    ("msda_sep_bwd", "decoder MSDA bwd (kernel 2)"),
    ("msda_sep", "decoder MSDA fwd (kernel 2)"),
    ("attention_bwd", "attention bwd (kernel 3)"),
    ("attention_fwd", "attention fwd (kernel 3)"),
    ("lap_kernel", "LAP (kernel 4)"),
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
    ("memcpy", "copies between host and card"),
    ("memset", "fills"),
    ("copy", "copies and casts"),
    ("elementwise", "elementwise"),
)
BACKWARD_FUNCTION = 1  # at::RecordScope of an autograd node's backward
ENGINE_NODE = "autograd::engine::evaluate_function: "


def group_of(name):
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other"


def event_components(events):
    """[(component, operator event)] of every host operator event: the
    innermost component range around it; inside an autograd node's
    backward, the component of the forward operator that made the node;
    else "other"."""
    def walk(e):
        while e is not None:
            if e.name.startswith(COMPONENT_PREFIX):
                return e.name[len(COMPONENT_PREFIX):], None
            if e.sequence_nr >= 0 and (e.scope == BACKWARD_FUNCTION
                                       or e.name.startswith(ENGINE_NODE)):
                return None, e
            e = e.cpu_parent
        return None, None

    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and not e.name.startswith(COMPONENT_PREFIX)]
    forward = {}
    for e in sorted(ops, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and e.scope != BACKWARD_FUNCTION \
                and not e.name.startswith(ENGINE_NODE):
            comp, _ = walk(e)
            if comp is not None:
                forward[(e.thread, e.sequence_nr)] = comp
    out = []
    for e in ops:
        comp, node = walk(e)
        if comp is None and node is not None:
            comp = forward.get((node.fwd_thread, node.sequence_nr))
        out.append((comp or "other", e))
    return out


def reduce_profile(events, steps):
    """The traced window's record: `ops` [(start_us, end_us, name, group)]
    of every device operation, sorted; `components` {component: device ms
    in all}; `gaps` [(host operator, seconds)], the longest idle gaps
    between device operations, each named by the innermost host operator
    running at its start and that operator's component; and `steps`."""
    ops = sorted((e.time_range.start, e.time_range.end, e.name, group_of(e.name))
                 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(COMPONENT_PREFIX))
    components = defaultdict(float)
    host = []
    for comp, e in event_components(events):
        for k in e.kernels:
            components[comp] += k.duration / 1e3
        host.append((e.time_range.start, e.time_range.end, e.name, comp))
    ivs = busy_intervals(ops)
    gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in zip(ivs, ivs[1:])), reverse=True)
    named = []
    for length, t in gaps[:10]:
        inner = [h for h in host if h[0] <= t <= h[1]]
        h = min(inner, key=lambda h: h[1] - h[0]) if inner else (0, 0, "host idle", "other")
        named.append((f"{h[2]} ({h[3]})", length * 1e-6))
    return {"ops": ops, "components": dict(components), "gaps": named, "steps": steps}


def busy_intervals(ops):
    """The union of the operations' intervals, [[start, end]] sorted."""
    out = []
    for s, e, *_ in ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(ops):
    return sum(e - s for s, e in busy_intervals(ops))


def by_group(ops):
    """Device milliseconds in all by kernel group."""
    out = defaultdict(float)
    for s, e, _, group in ops:
        out[group] += (e - s) / 1e3
    return dict(out)
