"""MSDeformAttn: learned sampling offsets and attention weights around the
deformable-attention ops (monodetr_tpu/models/msda_module.py, reference
ops/modules/ms_deform_attn.py:69-162).

`impl` selects the op:
  - "fused": the encoder's windowed attention over grid queries, with the
    softmax, clamp and centres inside the kernel (ops/msda_enc.py).  The
    sampling_offsets parameters keep the reference feature order; the
    projection applies offset_feature_perm() to the weight rows, as
    _PermutedOutDense does (msda_module.py:43-64);
  - "sep": exact semantics from normalised locations, the decoder's kernel
    (ops/msda_sep.py);
  - "gather": exact reference semantics in plain PyTorch with f32
    projections, the parity path.
`plain_ops` makes "fused" and "sep" call their plain PyTorch versions for
a CUDA tensor too, for comparing kernels with them.
"""

import math

import numpy as np
import torch
from torch import nn

from ..ops.msda import level_sizes, ms_deform_attn
from ..ops.msda_enc import (ms_deform_attn_enc_fused,
                            ms_deform_attn_enc_fused_plain, offset_feature_perm)
from ..ops.msda_sep import ms_deform_attn_sep
from ..ops.utils import device_constant

IMPLS = ("fused", "sep", "gather")


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
            raise NotImplementedError(
                f"MSDeformAttn impl {impl!r} is not ported; ported: {IMPLS} "
                "(ROADMAP.md section A)")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.impl, self.window = impl, window
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        if impl == "fused":
            self.register_buffer(
                "offset_perm", torch.from_numpy(offset_feature_perm(n_heads, n_levels, n_points)),
                persistent=False)
        self.plain_ops = False

    def init_offset_bias(self):
        """The reference ring; windowed impls shrink it to 0.75 of the
        window (msda_module.py:119-124)."""
        max_r = 0.75 * (self.window / 2 - 1) if self.impl == "fused" else None
        bias = offset_bias_init(self.n_heads, self.n_levels, self.n_points, max_r)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(bias))

    def forward(self, query, reference_points, value_tokens, spatial_shapes):
        """query [B, Q, C]; reference_points [B, Q, L, 2] (normalised
        centres) or [B, Q, L, 6] (cxcylrtb boxes); value_tokens [B, S, C];
        spatial_shapes ((h, w), ...).  Returns [B, Q, C]."""
        B, Q, C = query.shape
        S = value_tokens.shape[1]
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_tokens).view(B, S, H, C // H)

        if self.impl == "fused":
            # grid queries: the centres come from spatial_shapes alone, as
            # the encoder's reference points are the per-level pixel grid
            if reference_points.shape[-1] != 2 or Q != S:
                raise ValueError("fused MSDA needs grid queries (encoder self-attention)")
            w = self.sampling_offsets.weight[self.offset_perm]
            b = self.sampling_offsets.bias[self.offset_perm]
            off = nn.functional.linear(query, w, b)
            logits = self.attention_weights(query)
            op = ms_deform_attn_enc_fused_plain if self.plain_ops else ms_deform_attn_enc_fused
            out = op(value, tuple(spatial_shapes), off, logits, self.window)
            return self.output_proj(out.to(query.dtype))

        if self.impl == "gather":  # exact-parity path: f32 projections
            offsets = nn.functional.linear(query.float(), self.sampling_offsets.weight.float(),
                                           self.sampling_offsets.bias.float())
            logits = nn.functional.linear(query.float(), self.attention_weights.weight.float(),
                                          self.attention_weights.bias.float())
        else:
            offsets = self.sampling_offsets(query).float()
            logits = self.attention_weights(query).float()
        offsets = offsets.view(B, Q, H, L, P, 2)
        attn = torch.softmax(logits.view(B, Q, H, L * P), -1).view(B, Q, H, L, P)

        ref = reference_points.float()
        if ref.shape[-1] == 2:
            norm = device_constant(level_sizes, (tuple(spatial_shapes),), query.device)
            loc = ref[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        elif ref.shape[-1] == 6:
            # cxcylrtb boxes: offsets scaled by half the box extent
            # (ms_deform_attn.py:153-155)
            wh = (ref[:, :, None, :, None, 2::2] + ref[:, :, None, :, None, 3::2]) * 0.5
            loc = ref[:, :, None, :, None, :2] + offsets / P * wh
        else:
            raise ValueError("reference_points last dim must be 2 or 6")

        if self.impl == "sep" and not self.plain_ops:
            out = ms_deform_attn_sep(value, tuple(spatial_shapes), loc, attn)
        else:
            out = ms_deform_attn(value, tuple(spatial_shapes), loc, attn)
        return self.output_proj(out.to(query.dtype))
