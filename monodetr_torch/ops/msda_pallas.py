"""Windowed deformable attention over lane-packed operands: the encoder's
`msda_impl: pallas` path.

Counterpart of monodetr_tpu/ops/msda_pallas.py, same entry points and lane
order.  fx, fy and att are [B, S, 128] f32 with lane = lv*32 + h*4 + p
(H = 8, L = 4, P = 4); fx, fy are pixel positions in the sampled level,
already clamped to each query's window by the caller (`pack`, or the
module's per-lane clamp), so the op itself is plain bilinear MSDA with
zero padding.  The CUDA kernel is csrc/msda_win.cu:msda_pallas_kernel,
its backward msda_pallas_bwd_kernel (an autograd.Function joins them);
`ms_deform_attn_pallas_packed_plain` is their plain PyTorch version
(unpack the lanes, then ops/msda.py:ms_deform_attn_px), whose gradients
come from autograd.
"""

import numpy as np
import torch

from .. import _build
from ..utils.trace import count
from .msda import ms_deform_attn_px
from .msda_enc import grid_centers, window_limit
from .msda_windowed import (check_grid_contract, clamp_to_window, window_plan_args,
                            window_tiles)

LANES = 128  # H * L * P of the lane-packing contract


def check_contract(name, value, spatial_shapes, n_queries, n_points, window):
    """The lane packing is fixed at (H, L, P) = (8, 4, 4), and the window
    needs grid queries at power-of-two level ratios (msda_pallas.py:449)."""
    H, L = value.shape[2], len(spatial_shapes)
    if (H, L, n_points) != (8, 4, 4):
        raise ValueError(f"{name}: the lane packing lane = lv*32 + h*4 + p needs "
                         f"(H, L, P) = (8, 4, 4); got ({H}, {L}, {n_points}); use "
                         f"msda_impl 'windowed' or 'gather'")
    check_grid_contract(name, value, spatial_shapes, n_queries, window)


def center_lane_tables(spatial_shapes):
    """CX, CY [S, 128] f32: each grid query's centre in every sampled
    level's pixel coordinates, repeated over the (head, point) lanes."""
    c = grid_centers(spatial_shapes)
    return np.repeat(c[:, :, 0], 32, axis=1), np.repeat(c[:, :, 1], 32, axis=1)


def offset_lane_perm(n_heads=8, n_levels=4, n_points=4):
    """Permutation taking the sampling_offsets projection's features, in
    the reference order (h, lv, p, xy), to [x-lanes | y-lanes], each in
    kernel lane order (lv, h, p)."""
    idx = np.arange(n_heads * n_levels * n_points * 2).reshape(
        n_heads, n_levels, n_points, 2)
    lanes = np.transpose(idx, (1, 0, 2, 3)).reshape(-1, 2)
    return np.concatenate([lanes[:, 0], lanes[:, 1]])


def to_lanes(x):
    """[B, S, H, L, P] -> [B, S, L*H*P] in lane order (lv, h, p)."""
    B, S = x.shape[:2]
    return x.transpose(2, 3).reshape(B, S, -1)


def from_lanes(x, n_heads, n_levels):
    """Inverse of to_lanes."""
    B, S = x.shape[:2]
    return x.reshape(B, S, n_levels, n_heads, -1).transpose(2, 3)


def pack(spatial_shapes, sampling_locations, attention_weights, window):
    """Normalised locations [B, S, H, L, P, 2] and weights -> (fx, fy, att)
    [B, S, 128] f32: pixel positions clamped to each query's window, in
    lane order (msda_pallas.py:_pack)."""
    f = clamp_to_window(sampling_locations, spatial_shapes, window)
    return to_lanes(f[..., 0]), to_lanes(f[..., 1]), to_lanes(attention_weights.float())


def _split(name, value, spatial_shapes, fx, fy, att):
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    if (fx.shape != (B, S, LANES) or fy.shape != fx.shape or att.shape != fx.shape
            or (H, L) != (8, 4) or S != sum(h * w for h, w in spatial_shapes)):
        raise ValueError(
            f"{name}: value {tuple(value.shape)}, fx {tuple(fx.shape)}, fy "
            f"{tuple(fy.shape)}, att {tuple(att.shape)} do not agree with levels "
            f"{spatial_shapes} and lanes (lv, h, p) of (8, 4, 4)")
    return B, S, H, D, L, LANES // (H * L)


def ms_deform_attn_pallas_packed_plain(value, spatial_shapes, fx, fy, att, window=8):
    """The plain version: bilinear MSDA at the unpacked positions.  `window`
    is unused (the positions are clamped already), as in the kernel."""
    _, _, H, _, L, _ = _split("ms_deform_attn_pallas_packed", value, spatial_shapes,
                              fx, fy, att)
    return ms_deform_attn_px(value, spatial_shapes, from_lanes(fx.float(), H, L),
                             from_lanes(fy.float(), H, L), from_lanes(att.float(), H, L))


def _check(name, value, spatial_shapes, fx, fy, att):
    _build.require_cuda(name, value, fx, fy, att)
    if not fx.dtype == fy.dtype == att.dtype == torch.float32:
        raise TypeError(f"{name}: fx, fy and att must be float32")
    return _split(name, value, spatial_shapes, fx, fy, att)


def _launch_fwd(value, spatial_shapes, fx, fy, att, window):
    B, S, H, D, L, P = _check("ms_deform_attn_pallas_packed", value, spatial_shapes,
                              fx, fy, att)
    window_tiles(spatial_shapes, window)  # what the backward cannot tile is refused here
    out = torch.empty(B, S, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_pallas", value.data_ptr(), fx.data_ptr(), fy.data_ptr(), att.data_ptr(),
        out.data_ptr(), _build.dtype_code(value.dtype), B, S, H, D, L, P,
        _build.levels_arg(spatial_shapes), _build.stream_of(value))
    count("msda_pallas")
    return out


def ms_deform_attn_pallas_packed_bwd(value, spatial_shapes, fx, fy, att, gout, window=8):
    """The backward kernel (csrc/msda_win.cu:msda_pallas_bwd_kernel) on CUDA
    tensors: (dvalue in value's dtype, dfx, dfy, datt f32) for the output
    gradient `gout` [B, S, H*D].  dvalue is summed in f32: per tile of
    queries in shared memory (ops/msda_windowed.py:window_tiles, which
    raises ValueError for a pyramid and window that do not fit there), then
    row by row by vector atomics; `window` only says where the positions
    are expected, the gradients are exact at any position."""
    name = "ms_deform_attn_pallas_packed_bwd"
    B, S, H, D, L, P = _check(name, value, spatial_shapes, fx, fy, att)
    plan, tiles = window_plan_args(spatial_shapes, window, value.device)
    gout = gout.contiguous()
    if gout.shape != (B, S, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    gvalue = torch.zeros(B, S, H, D, dtype=torch.float32, device=value.device)
    gfx, gfy, gatt = (torch.empty_like(fx) for _ in range(3))
    _build.launch(
        "mdt_msda_pallas_bwd", value.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        att.data_ptr(), gout.data_ptr(), gvalue.data_ptr(), gfx.data_ptr(), gfy.data_ptr(),
        gatt.data_ptr(), _build.dtype_code(value.dtype), B, S, H, D, L, P,
        _build.levels_arg(spatial_shapes), plan, tiles, window_limit(window),
        _build.stream_of(value))
    count("msda_pallas_bwd")
    return gvalue.to(value.dtype), gfx, gfy, gatt


class _Packed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, fx, fy, att, spatial_shapes, window):
        ctx.save_for_backward(value, fx, fy, att)
        ctx.geometry = (spatial_shapes, window)
        return _launch_fwd(value, spatial_shapes, fx, fy, att, window)

    @staticmethod
    def backward(ctx, gout):
        value, fx, fy, att = ctx.saved_tensors
        spatial_shapes, window = ctx.geometry
        return (*ms_deform_attn_pallas_packed_bwd(value, spatial_shapes, fx, fy, att, gout,
                                                  window), None, None)


def ms_deform_attn_pallas_packed(value, spatial_shapes, fx, fy, att, window=8):
    """value [B, S, H, D]; fx, fy, att [B, S, 128] f32 in lane order
    (lv, h, p), fx, fy already clamped to +-lim of the centres
    (center_lane_tables) for the window G = `window`, which the CUDA
    backward tiles by (ops/msda_windowed.py:window_tiles; positions beyond
    it stay exact).  Returns [B, S, H*D] in value.dtype.
    Differentiable in value, fx, fy and att: on CUDA the backward is the
    kernel `ms_deform_attn_pallas_packed_bwd`, on the CPU autograd through
    the plain version."""
    if value.device.type == "cpu":
        return ms_deform_attn_pallas_packed_plain(value, spatial_shapes, fx, fy, att, window)
    return _Packed.apply(value, fx, fy, att, tuple(spatial_shapes), window)


def ms_deform_attn_pallas(value, spatial_shapes, sampling_locations, attention_weights,
                          window=8):
    """Windowed MSDA for grid queries from normalised locations: `pack`,
    then the packed op (msda_pallas.py:638).  Same function as
    ops/msda_windowed.py:ms_deform_attn_windowed."""
    check_contract("ms_deform_attn_pallas", value, spatial_shapes,
                   sampling_locations.shape[1], sampling_locations.shape[4], window)
    fx, fy, att = pack(spatial_shapes, sampling_locations, attention_weights, window)
    return ms_deform_attn_pallas_packed(value, spatial_shapes, fx, fy, att, window)
