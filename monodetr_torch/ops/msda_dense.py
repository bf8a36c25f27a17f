"""Exact deformable attention for decoder-sized query counts: the decoder's
`dec_msda_impl: dense` and `dense_fused` paths.

`ms_deform_attn_dense` is monodetr_tpu/ops/msda.py:ms_deform_attn_dense
under its JAX name: the exact function (bilinear, zero padding,
align_corners=False) in plain PyTorch, ops/msda.py:ms_deform_attn.  The
JAX package computes it with dense hat-function matmuls, a TPU device for
avoiding gathers; the numbers are the same.  It is `dense` on every device
and the plain version of kernel 7.

`ms_deform_attn_dense_fused` (monodetr_tpu/ops/msda_dense_pallas.py) is
the same function through CUDA kernels (csrc/msda.cu): the forward
msda_dense_fused_kernel, and a backward that scatters nothing, as the TPU
kernel's does not: msda_sep_bwd_kernel without its value gradient gives
dloc and dattn per query, and msda_dense_fused_bwd_value_kernel writes
each dvalue row once from the samples that touch it, so dvalue is the same
bits from run to run.
"""

import torch

from .. import _build
from .msda import ms_deform_attn
from .msda_sep import check_loc_args

ms_deform_attn_dense = ms_deform_attn


def _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights):
    B, S, Q, H, D, L, P = check_loc_args("ms_deform_attn_dense_fused", value, spatial_shapes,
                                         sampling_locations, attention_weights)
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_dense_fused", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), _build.dtype_code(value.dtype),
        B, S, Q, H, D, L, P, _build.levels_arg(spatial_shapes), _build.stream_of(value))
    ms_deform_attn_dense_fused.launches += 1
    return out


def ms_deform_attn_dense_fused_bwd(value, spatial_shapes, sampling_locations,
                                   attention_weights, gout):
    """The two backward kernels on CUDA tensors, counted as one launch:
    (dvalue in value's dtype, dloc f32, dattn f32) for the output gradient
    `gout` [B, Q, H*D].  No atomics: dvalue is deterministic."""
    name = "ms_deform_attn_dense_fused_bwd"
    B, S, Q, H, D, L, P = check_loc_args(name, value, spatial_shapes, sampling_locations,
                                         attention_weights)
    gout = gout.contiguous()
    if gout.shape != (B, Q, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    gvalue = torch.empty_like(value)
    gloc = torch.empty_like(sampling_locations)
    gattn = torch.empty_like(attention_weights)
    _build.launch(
        "mdt_msda_dense_fused_bwd", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), gout.data_ptr(), gvalue.data_ptr(), gloc.data_ptr(),
        gattn.data_ptr(), _build.dtype_code(value.dtype), B, S, Q, H, D, L, P,
        _build.levels_arg(spatial_shapes), _build.stream_of(value))
    ms_deform_attn_dense_fused_bwd.launches += 1
    return gvalue, gloc, gattn


class _DenseFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, gout):
        value, loc, attn = ctx.saved_tensors
        grads = ms_deform_attn_dense_fused_bwd(value, ctx.spatial_shapes, loc, attn, gout)
        return (*grads, None)


def ms_deform_attn_dense_fused(value, spatial_shapes, sampling_locations,
                               attention_weights):
    """value [B, S, H, D]; sampling_locations [B, Q, H, L, P, 2] and
    attention_weights [B, Q, H, L, P] in f32.  Returns [B, Q, H*D] in
    value.dtype: bilinear samples at loc * (w, h) - 0.5, zero padding.
    Differentiable in all three inputs."""
    if value.device.type == "cpu":
        return ms_deform_attn_dense(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return _DenseFused.apply(value, sampling_locations, attention_weights,
                             tuple(spatial_shapes))


ms_deform_attn_dense_fused.launches = 0
ms_deform_attn_dense_fused_bwd.launches = 0
