"""MSDeformAttn: learned sampling offsets and attention weights around the
deformable-attention ops (monodetr_tpu/models/msda_module.py, reference
ops/modules/ms_deform_attn.py:69-162).

`impl` selects the op, as in the JAX module; every one of its eight impls:
  - "fused": the encoder's windowed attention over grid queries, with the
    softmax, clamp and centres inside the kernel (ops/msda_enc.py).  The
    projection applies offset_feature_perm() to the weight rows, as
    _PermutedOutDense does (msda_module.py:43-64);
  - "pallas": the same windowed function over lane-packed operands
    (ops/msda_pallas.py): the projection applies offset_lane_perm() to the
    weight rows (the JAX module permutes its output, the same numbers), the
    offsets are clamped per lane around the static centres, and handed to
    the packed kernel;
  - "sepwin": the same windowed function from normalised locations, the
    clamp in the kernel (ops/msda_sepwin.py);
  - "windowed": the same windowed function in plain PyTorch
    (ops/msda_windowed.py) on every device: the JAX package has no kernel
    for it either;
  - "sep" and "dense_fused": exact semantics from normalised locations
    through a kernel (ops/msda_sep.py, ops/msda_dense.py);
  - "dense": exact semantics in plain PyTorch on every device (the JAX
    package's XLA path, ops/msda_dense.py:ms_deform_attn_dense);
  - "gather": exact semantics in plain PyTorch with f32 projections, the
    parity path.
The windowed impls ("fused", "pallas", "sepwin", "windowed") need grid
queries (the encoder) and start with the offset ring inside the window.
The parameters keep the reference layout under every impl, so one
state_dict loads into all of them.  `plain_ops` makes every kernel impl
call its plain PyTorch version for a CUDA tensor too, for comparing
kernels with them.
"""

import math

import numpy as np
import torch
from torch import nn

from ..ops.msda import level_sizes, ms_deform_attn
from ..ops.msda_dense import ms_deform_attn_dense_fused
from ..ops.msda_enc import (ms_deform_attn_enc_fused, ms_deform_attn_enc_fused_plain,
                            offset_feature_perm, window_limit)
from ..ops.msda_pallas import (center_lane_tables, ms_deform_attn_pallas_packed,
                               ms_deform_attn_pallas_packed_plain, offset_lane_perm, to_lanes)
from ..ops.msda_sep import ms_deform_attn_sep
from ..ops.msda_sepwin import ms_deform_attn_sepwin
from ..ops.msda_windowed import ms_deform_attn_windowed
from ..ops.utils import device_constant

IMPLS = ("gather", "fused", "pallas", "dense", "dense_fused", "sep", "sepwin", "windowed")
WINDOWED_IMPLS = ("pallas", "fused", "sepwin", "windowed")


def offset_bias_init(n_heads, n_levels, n_points, max_radius=None):
    """Ring of unit directions scaled by point index (ms_deform_attn.py:107-114);
    max_radius puts the outermost point at that radius in pixels, so that a
    windowed impl does not clamp any point from the start."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    if max_radius is not None:
        grid *= max_radius / n_points
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4,
                 impl="gather", window=8):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"MSDeformAttn impl {impl!r} is not one of {IMPLS}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.impl, self.window = impl, window
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        if impl in ("fused", "pallas"):
            perm = (offset_feature_perm if impl == "fused" else offset_lane_perm)(
                n_heads, n_levels, n_points)
            self.register_buffer("offset_perm", torch.from_numpy(perm), persistent=False)
        self.plain_ops = False

    def init_offset_bias(self):
        """The reference ring; the windowed impls shrink it to 0.75 of the
        window's reach (msda_module.py:119-124)."""
        max_r = 0.75 * (self.window / 2 - 1) if self.impl in WINDOWED_IMPLS else None
        bias = offset_bias_init(self.n_heads, self.n_levels, self.n_points, max_r)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(bias))

    def forward(self, query, reference_points, value_tokens, spatial_shapes):
        """query [B, Q, C]; reference_points [B, Q, L, 2] (normalised
        centres) or [B, Q, L, 6] (cxcylrtb boxes); value_tokens [B, S, C];
        spatial_shapes ((h, w), ...).  Returns [B, Q, C]."""
        op, args = self.sampling(query, reference_points, value_tokens, spatial_shapes)
        return self.output_proj(op(*args).to(query.dtype))

    def sampling(self, query, reference_points, value_tokens, spatial_shapes):
        """(op, args): the impl's sampling op and its inputs, made from the
        projections; op(*args) is the sampled output [B, Q, H * D] that
        output_proj reads (the JAX module's "msda_sampled", which its
        encoder rematerialisation keeps)."""
        B, Q, C = query.shape
        S = value_tokens.shape[1]
        H, L, P = self.n_heads, self.n_levels, self.n_points
        shapes = tuple(spatial_shapes)
        value = self.value_proj(value_tokens).view(B, S, H, C // H)
        if self.impl in WINDOWED_IMPLS and (reference_points.shape[-1] != 2 or Q != S):
            # the windowed impls take their centres from spatial_shapes alone:
            # the encoder's reference points are the per-level pixel grid
            raise ValueError(f"{self.impl} MSDA needs grid queries (encoder self-attention)")

        if self.impl == "fused":
            w = self.sampling_offsets.weight[self.offset_perm]
            b = self.sampling_offsets.bias[self.offset_perm]
            off = nn.functional.linear(query, w, b)
            logits = self.attention_weights(query)
            op = ms_deform_attn_enc_fused_plain if self.plain_ops else ms_deform_attn_enc_fused
            return op, (value, shapes, off, logits, self.window)

        if self.impl == "gather":  # exact-parity path: f32 projections
            offsets = nn.functional.linear(query.float(), self.sampling_offsets.weight.float(),
                                           self.sampling_offsets.bias.float())
            logits = nn.functional.linear(query.float(), self.attention_weights.weight.float(),
                                          self.attention_weights.bias.float())
        elif self.impl == "pallas":  # offset features in lane order, as "fused" permutes
            offsets = nn.functional.linear(query, self.sampling_offsets.weight[self.offset_perm],
                                           self.sampling_offsets.bias[self.offset_perm]).float()
            logits = self.attention_weights(query).float()
        else:  # the compute dtype, promoted to f32 for the positional math
            offsets = self.sampling_offsets(query).float()
            logits = self.attention_weights(query).float()
        attn = torch.softmax(logits.view(B, Q, H, L * P), -1).view(B, Q, H, L, P)

        if self.impl == "pallas":
            # for grid queries loc * (w, h) - 0.5 == centre + offset, so the
            # window clamp is per-lane arithmetic on [B, S, 128]
            lim = window_limit(self.window)
            cx, cy = device_constant(center_lane_tables, (shapes,), query.device)
            fx = torch.clamp(cx + offsets[..., :128], cx - lim, cx + lim)
            fy = torch.clamp(cy + offsets[..., 128:], cy - lim, cy + lim)
            op = (ms_deform_attn_pallas_packed_plain if self.plain_ops
                  else ms_deform_attn_pallas_packed)
            return op, (value, shapes, fx, fy, to_lanes(attn), self.window)

        offsets = offsets.view(B, Q, H, L, P, 2)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            norm = device_constant(level_sizes, (shapes,), query.device)
            loc = ref[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        elif ref.shape[-1] == 6:
            # cxcylrtb boxes: offsets scaled by half the box extent
            # (ms_deform_attn.py:153-155)
            wh = (ref[:, :, None, :, None, 2::2] + ref[:, :, None, :, None, 3::2]) * 0.5
            loc = ref[:, :, None, :, None, :2] + offsets / P * wh
        else:
            raise ValueError("reference_points last dim must be 2 or 6")

        if self.impl in ("sepwin", "windowed"):
            op = (ms_deform_attn_windowed if self.plain_ops or self.impl == "windowed"
                  else ms_deform_attn_sepwin)
            return op, (value, shapes, loc, attn, self.window)
        if self.impl in ("sep", "dense_fused") and not self.plain_ops:
            op = ms_deform_attn_sep if self.impl == "sep" else ms_deform_attn_dense_fused
            return op, (value, shapes, loc, attn)
        # "gather", "dense" (ms_deform_attn_dense), or a kernel impl's plain version
        return ms_deform_attn, (value, shapes, loc, attn)
