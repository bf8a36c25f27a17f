"""Exact deformable attention from normalised sampling locations: the
decoder's cross-attention into the encoder memory.

Counterpart of monodetr_tpu/ops/msda_sep_pallas.py:ms_deform_attn_sep.
The CUDA kernels are csrc/msda_loc.cu:msda_sep_kernel and its backward
msda_sep_bwd_kernel (an autograd.Function joins them); their plain PyTorch
version is ops/msda.py:ms_deform_attn, whose gradients come from autograd.

Shapes the kernels take: D = 32, at most MAX_SAMPLES = 32 samples per head
(L * P), at most 8 levels, any B, Q and pyramid whose batch item of S * H *
64 elements stays within INT32_MAX (`check_loc_shape`; ValueError
otherwise, as kernels 1, 5 and 6 raise).  Four threads work on one (batch,
query, head) with 32-bit offsets into a batch item's tokens; L * P > 16
takes a second round of 16 samples in the same kernel.
"""

import torch

from .. import _build
from ..utils.trace import count
from .msda import ms_deform_attn

MAX_SAMPLES = 32  # csrc/msda_loc.cu:kMaxSamples
INT32_MAX = 2 ** 31 - 1


def fits_int32(S, H):
    """csrc/common.cuh:fits_int32: whether the kernels' 32-bit offsets
    reach every element of one batch item's [S, H, 32] tokens, with the
    rows they address before and past a level."""
    return S * H * 64 <= INT32_MAX


def check_loc_shape(name, S, H, L, P):
    """ValueError unless kernels 2 and 7 take L levels of P points over S
    tokens of H heads: 1 to MAX_SAMPLES samples per head, and a batch item
    that 32-bit offsets reach.  Decided here, not in the CUDA code."""
    if L < 1 or P < 1 or L * P > MAX_SAMPLES:
        raise ValueError(f"{name}: the kernels take 1 to {MAX_SAMPLES} samples per head, not "
                         f"L * P = {L} * {P}")
    if not fits_int32(S, H):
        raise ValueError(f"{name}: a batch item of {S} tokens x {H} heads is beyond the "
                         f"kernels' 32-bit offsets (S * H * 64 <= {INT32_MAX})")


def check_loc_args(name, value, spatial_shapes, sampling_locations, attention_weights):
    _build.require_cuda(name, value, sampling_locations, attention_weights)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.dtype != torch.float32
            or attention_weights.dtype != torch.float32):
        raise TypeError(f"{name}: locations and weights must be float32")
    if (attention_weights.shape != (B, Q, H, L, P)
            or sampling_locations.shape[0] != B or sampling_locations.shape[2] != H
            or L != len(spatial_shapes)
            or S != sum(h * w for h, w in spatial_shapes)):
        raise ValueError(
            f"{name}: value {tuple(value.shape)}, locations "
            f"{tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)} do not agree with levels "
            f"{spatial_shapes}")
    if D != 32:
        raise ValueError(f"{name}: the kernels take 32 channels per head, not {D}")
    check_loc_shape(name, S, H, L, P)
    return B, S, Q, H, D, L, P


def _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights):
    B, S, Q, H, D, L, P = check_loc_args("ms_deform_attn_sep", value, spatial_shapes,
                                         sampling_locations, attention_weights)
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_sep", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        _build.dtype_code(value.dtype), B, S, Q, H, D, L, P,
        _build.levels_arg(spatial_shapes), _build.stream_of(value))
    count("msda_sep")
    return out


def ms_deform_attn_sep_bwd(value, spatial_shapes, sampling_locations,
                           attention_weights, gout):
    """The backward kernel (csrc/msda_loc.cu:msda_sep_bwd_kernel) on CUDA
    tensors: (dvalue in value's dtype, dloc f32, dattn f32) for the output
    gradient `gout` [B, Q, H*D].  dvalue is summed in f32 by atomics."""
    name = "ms_deform_attn_sep_bwd"
    B, S, Q, H, D, L, P = check_loc_args(name, value, spatial_shapes,
                                         sampling_locations, attention_weights)
    gout = gout.contiguous()
    if gout.shape != (B, Q, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    gvalue = torch.zeros(B, S, H, D, dtype=torch.float32, device=value.device)
    gloc = torch.empty_like(sampling_locations)
    gattn = torch.empty_like(attention_weights)
    _build.launch(
        "mdt_msda_sep_bwd", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), gout.data_ptr(), gvalue.data_ptr(),
        gloc.data_ptr(), gattn.data_ptr(), _build.dtype_code(value.dtype),
        B, S, Q, H, D, L, P, _build.levels_arg(spatial_shapes), _build.stream_of(value))
    count("msda_sep_bwd")
    return gvalue.to(value.dtype), gloc, gattn


class _Sep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return _launch_fwd(value, spatial_shapes, sampling_locations,
                           attention_weights)

    @staticmethod
    def backward(ctx, gout):
        value, loc, attn = ctx.saved_tensors
        grads = ms_deform_attn_sep_bwd(value, ctx.spatial_shapes, loc, attn, gout)
        return (*grads, None)


def ms_deform_attn_sep(value, spatial_shapes, sampling_locations,
                       attention_weights):
    """value [B, S, H, D]; sampling_locations [B, Q, H, L, P, 2] and
    attention_weights [B, Q, H, L, P] in f32.  Returns [B, Q, H*D] in
    value.dtype: bilinear samples at loc * (w, h) - 0.5, zero padding.
    Differentiable in all three inputs."""
    if value.device.type == "cpu":
        return ms_deform_attn(value, spatial_shapes, sampling_locations,
                              attention_weights)
    return _Sep.apply(value, sampling_locations, attention_weights,
                      tuple(spatial_shapes))
