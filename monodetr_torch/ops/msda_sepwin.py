"""Windowed deformable attention for encoder grid queries from normalised
locations: the encoder's `msda_impl: sepwin` path.

Counterpart of monodetr_tpu/ops/msda_sepwin_pallas.py:ms_deform_attn_sepwin,
the same function as ops/msda_windowed.py:ms_deform_attn_windowed, which
is its plain version.  The CUDA kernel is csrc/msda_win.cu:
msda_sepwin_kernel, its backward msda_sepwin_bwd_kernel (an
autograd.Function joins them): the clamp to each query's window runs in
the kernels' prologue, and the backward passes the location gradient only
where the position was not clamped.
"""

import torch

from .. import _build
from ..utils.trace import count
from .msda_enc import window_limit
from .msda_pallas import check_contract
from .msda_sep import check_loc_args
from .msda_windowed import ms_deform_attn_windowed, window_plan_args, window_tiles


def _check(name, value, spatial_shapes, sampling_locations, attention_weights, window):
    B, S, Q, H, D, L, P = check_loc_args(name, value, spatial_shapes, sampling_locations,
                                         attention_weights)
    check_contract(name, value, spatial_shapes, Q, P, window)
    return B, S, H, D, L, P


def _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights, window):
    B, S, H, D, L, P = _check("ms_deform_attn_sepwin", value, spatial_shapes,
                              sampling_locations, attention_weights, window)
    window_tiles(spatial_shapes, window)  # what the backward cannot tile is refused here
    out = torch.empty(B, S, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_sepwin", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), _build.dtype_code(value.dtype),
        B, S, H, D, L, P, _build.levels_arg(spatial_shapes), window_limit(window),
        _build.stream_of(value))
    count("msda_sepwin")
    return out


def ms_deform_attn_sepwin_bwd(value, spatial_shapes, sampling_locations, attention_weights,
                              gout, window=8):
    """The backward kernel (csrc/msda_win.cu:msda_sepwin_bwd_kernel) on
    CUDA tensors: (dvalue in value's dtype, dloc f32, dattn f32) for the
    output gradient `gout` [B, S, H*D].  dvalue is summed in f32: per tile
    of queries in shared memory (ops/msda_windowed.py:window_tiles, which
    raises ValueError for a pyramid and window that do not fit there), then
    row by row by vector atomics; dloc is 0 where the position was
    clamped."""
    name = "ms_deform_attn_sepwin_bwd"
    B, S, H, D, L, P = _check(name, value, spatial_shapes, sampling_locations,
                              attention_weights, window)
    plan, tiles = window_plan_args(spatial_shapes, window, value.device)
    gout = gout.contiguous()
    if gout.shape != (B, S, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    gvalue = torch.zeros(B, S, H, D, dtype=torch.float32, device=value.device)
    gloc = torch.empty_like(sampling_locations)
    gattn = torch.empty_like(attention_weights)
    _build.launch(
        "mdt_msda_sepwin_bwd", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), gout.data_ptr(), gvalue.data_ptr(), gloc.data_ptr(),
        gattn.data_ptr(), _build.dtype_code(value.dtype), B, S, H, D, L, P,
        _build.levels_arg(spatial_shapes), plan, tiles, window_limit(window),
        _build.stream_of(value))
    count("msda_sepwin_bwd")
    return gvalue.to(value.dtype), gloc, gattn


class _Sepwin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes, window):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.geometry = (spatial_shapes, window)
        return _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights,
                           window)

    @staticmethod
    def backward(ctx, gout):
        value, loc, attn = ctx.saved_tensors
        spatial_shapes, window = ctx.geometry
        grads = ms_deform_attn_sepwin_bwd(value, spatial_shapes, loc, attn, gout, window)
        return (*grads, None, None)


def ms_deform_attn_sepwin(value, spatial_shapes, sampling_locations, attention_weights,
                          window=8):
    """value [B, S, H, D]; sampling_locations [B, S, H, L, P, 2] normalised
    and attention_weights [B, S, H, L, P], f32, for grid queries (Q == S).
    Returns [B, S, H*D] in value.dtype: bilinear samples (zero padding) at
    loc * (w, h) - 0.5 clamped to +-(G/2 - 1 - 0.01) px of each query's
    centre.  Differentiable in all three inputs."""
    check_contract("ms_deform_attn_sepwin", value, spatial_shapes,
                   sampling_locations.shape[1], sampling_locations.shape[4], window)
    if value.device.type == "cpu":
        return ms_deform_attn_windowed(value, spatial_shapes, sampling_locations,
                                       attention_weights, window)
    return _Sepwin.apply(value, sampling_locations, attention_weights,
                         tuple(spatial_shapes), window)
