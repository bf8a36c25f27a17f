"""Encoder deformable attention over grid queries, with the attention
prologue (per-head softmax, window clamp, static centres) inside the kernel.

Counterpart of monodetr_tpu/ops/msda_enc_pallas.py:ms_deform_attn_enc_fused,
same signature and offset feature order.  The CUDA kernel is
csrc/msda.cu:msda_enc_fused_kernel; its backward is the windowed tile sums
of kernels 5 and 6 on kernel 1's operands, csrc/msda_win.cu:
msda_enc_fused_bwd_tiles_kernel, between a pass that softmaxes the logits
and one that takes the softmax's backward (an autograd.Function joins
them).  `ms_deform_attn_enc_fused_plain` is their plain PyTorch version
(softmax -> clip to +-lim -> exact MSDA at centre + offset, the
composition of tests/test_msda_enc_fused.py:oracle), whose gradients come
from autograd.  The backward's tiling (ops/msda_windowed.py:window_tiles)
takes 8 heads of 32 channels, 4 points and at most 4 levels; the forward
refuses what it cannot take, so a shape is refused before anything runs,
never switched to another kernel.
"""

import numpy as np
import torch

from .. import _build
from ..utils.trace import count
from .msda import ms_deform_attn_px
from .utils import device_constant


def window_limit(window):
    """Largest sampling offset, in sampled-level pixels, of the G-window."""
    return window / 2 - 1 - 1e-2


def offset_feature_perm(n_heads=8, n_levels=4, n_points=4):
    """Permutation taking the sampling_offsets projection's reference
    feature order (h, lv, p, xy) to [x-block | y-block], each block in
    (h, lv, p) order (msda_enc_pallas.py:55)."""
    flat = np.arange(n_heads * n_levels * n_points * 2).reshape(-1, 2)
    return np.concatenate([flat[:, 0], flat[:, 1]])


def grid_centers(spatial_shapes):
    """[S, L, 2] (x, y): where grid query q's centre falls in each level's
    pixel coordinates, (g + 0.5) * size_l / size_lq - 0.5."""
    per_level = []
    for hq, wq in spatial_shapes:
        ys, xs = np.meshgrid(np.arange(hq) + 0.5, np.arange(wq) + 0.5,
                             indexing="ij")
        per_level.append(np.stack(
            [np.stack([xs * wv / wq - 0.5, ys * hv / hq - 0.5], -1).reshape(-1, 2)
             for hv, wv in spatial_shapes], 1))
    return np.concatenate(per_level, 0).astype(np.float32)


def _split(value, spatial_shapes, off, logits):
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    LP = logits.shape[-1] // H
    if (logits.shape != (B, S, H * LP) or off.shape != (B, S, 2 * H * LP)
            or LP % L or S != sum(h * w for h, w in spatial_shapes)):
        raise ValueError(
            f"ms_deform_attn_enc_fused: value {tuple(value.shape)}, off "
            f"{tuple(off.shape)}, logits {tuple(logits.shape)} do not agree "
            f"with levels {spatial_shapes}")
    return B, S, H, D, L, LP // L


def enc_samples(value, spatial_shapes, off, logits, window=8):
    """(fx, fy, att), each [B, S, H, L, P] f32: the pixel positions and
    weights that kernel 1 samples with, centre + clip(offset, +-lim) and
    each head's softmax over its L*P logits."""
    B, S, H, D, L, P = _split(value, spatial_shapes, off, logits)
    att = torch.softmax(logits.float().view(B, S, H, L * P), -1)
    lim = window_limit(window)
    offc = off.float().clamp(-lim, lim)
    ox = offc[..., :H * L * P].reshape(B, S, H, L, P)
    oy = offc[..., H * L * P:].reshape(B, S, H, L, P)
    c = device_constant(grid_centers, (tuple(spatial_shapes),), value.device)
    fx = c[None, :, None, :, None, 0] + ox
    fy = c[None, :, None, :, None, 1] + oy
    return fx, fy, att.view(B, S, H, L, P)


def ms_deform_attn_enc_fused_plain(value, spatial_shapes, off, logits,
                                   window=8):
    return ms_deform_attn_px(value, spatial_shapes,
                             *enc_samples(value, spatial_shapes, off, logits, window))


def _check(name, value, spatial_shapes, off, logits, window):
    """The shapes both directions take, or ValueError: the backward's
    (heads, channels, points) = (8, 32, 4) and a tiling of the pyramid and
    window whose block fits shared memory (at most 4 levels)."""
    from .msda_windowed import window_tiles

    _build.require_cuda(name, value, off, logits)
    if not value.dtype == off.dtype == logits.dtype:
        raise TypeError(f"{name}: value, off and logits must share a dtype")
    B, S, H, D, L, P = _split(value, spatial_shapes, off, logits)
    if (H, D, P) != (8, 32, 4):
        raise ValueError(f"{name}: the kernels take 8 heads of 32 channels and 4 points "
                         f"per level, got {H} heads of {D} and {P} points; use msda_impl "
                         f"'gather'")
    window_tiles(spatial_shapes, window)  # ValueError where the backward cannot tile
    return B, S, H, D, L, P


def _launch_fwd(value, spatial_shapes, off, logits, window):
    name = "ms_deform_attn_enc_fused"
    B, S, H, D, L, P = _check(name, value, spatial_shapes, off, logits, window)
    out = torch.empty(B, S, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_enc_fused", value.data_ptr(), off.data_ptr(),
        logits.data_ptr(), out.data_ptr(), _build.dtype_code(value.dtype),
        B, S, H, D, L, P, _build.levels_arg(spatial_shapes),
        window_limit(window), _build.stream_of(value))
    count("msda_enc_fused")
    return out


def ms_deform_attn_enc_fused_bwd(value, spatial_shapes, off, logits, gout,
                                 window=8):
    """The backward kernels (csrc/msda_win.cu: msda_enc_fused_bwd_weights_,
    _tiles_ and _softmax_kernel) on CUDA tensors: (dvalue, doff, dlogits)
    in the inputs' dtype for the output gradient `gout` [B, S, H*D].  The
    first pass writes the softmaxed weights to an f32 [B, S, H*L*P] scratch
    and zeroes an f32 dvalue; the tile pass reads the weights, sums dvalue
    per tile of queries in shared memory (ops/msda_windowed.py:
    window_tiles), then row by row by vector atomics, writes doff (0 where
    the offset was clamped) and the weights' gradients over the weights;
    the last makes dlogits and rounds dvalue to bf16 where that is the
    dtype.  No other launch."""
    from .msda_windowed import window_plan_args

    name = "ms_deform_attn_enc_fused_bwd"
    B, S, H, D, L, P = _check(name, value, spatial_shapes, off, logits, window)
    plan, tiles = window_plan_args(spatial_shapes, window, value.device)
    gout = gout.contiguous()
    if gout.shape != (B, S, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    gvalue = torch.empty(B, S, H, D, dtype=torch.float32, device=value.device)
    dvalue = gvalue if value.dtype == torch.float32 else torch.empty_like(value)
    w = torch.empty(logits.shape, dtype=torch.float32, device=value.device)
    goff = torch.empty_like(off)
    glogits = torch.empty_like(logits)
    _build.launch(
        "mdt_msda_enc_fused_bwd_tiles", value.data_ptr(), off.data_ptr(),
        logits.data_ptr(), gout.data_ptr(), gvalue.data_ptr(),
        None if dvalue is gvalue else dvalue.data_ptr(), w.data_ptr(),
        goff.data_ptr(), glogits.data_ptr(), _build.dtype_code(value.dtype),
        B, S, H, D, L, P, _build.levels_arg(spatial_shapes), plan, tiles,
        window_limit(window), _build.stream_of(value))
    count("msda_enc_fused_bwd")
    return dvalue, goff, glogits


class _EncFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, off, logits, spatial_shapes, window):
        ctx.save_for_backward(value, off, logits)
        ctx.geometry = (spatial_shapes, window)
        return _launch_fwd(value, spatial_shapes, off, logits, window)

    @staticmethod
    def backward(ctx, gout):
        value, off, logits = ctx.saved_tensors
        spatial_shapes, window = ctx.geometry
        grads = ms_deform_attn_enc_fused_bwd(value, spatial_shapes, off, logits,
                                             gout, window)
        return (*grads, None, None)


def ms_deform_attn_enc_fused(value, spatial_shapes, off, logits, window=8):
    """Windowed MSDA for grid queries (Q == S, level-major).

    value:  [B, S, H, D] projected value tokens
    off:    [B, S, 2*H*L*P] raw sampling-offset projection, feature order
            [x(h, lv, p) | y(h, lv, p)], in sampled-level pixels
    logits: [B, S, H*L*P] raw attention logits, order (h, lv*P + p)
    Returns [B, S, H*D] in value.dtype: per head, softmax over the L*P
    logits, then bilinear samples (zero padding) at centre +
    clip(offset, +-(G/2 - 1 - 0.01)) in every level.  Differentiable in
    value, off and logits: on CUDA the backward is the kernels of
    `ms_deform_attn_enc_fused_bwd`, on the CPU autograd through the plain
    version.  On CUDA, ValueError for a shape the backward cannot take
    (see _check), with or without a gradient.
    """
    if value.device.type == "cpu":
        return ms_deform_attn_enc_fused_plain(value, spatial_shapes, off,
                                              logits, window)
    return _EncFused.apply(value, off, logits, tuple(spatial_shapes), window)
