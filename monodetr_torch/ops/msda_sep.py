"""Exact deformable attention from normalised sampling locations: the
decoder's cross-attention into the encoder memory.

Counterpart of monodetr_tpu/ops/msda_sep_pallas.py:ms_deform_attn_sep.
The CUDA kernel is csrc/msda.cu:msda_sep_kernel; its plain PyTorch version
is ops/msda.py:ms_deform_attn.
"""

import torch

from .. import _build
from .msda import ms_deform_attn


def ms_deform_attn_sep(value, spatial_shapes, sampling_locations,
                       attention_weights):
    """value [B, S, H, D]; sampling_locations [B, Q, H, L, P, 2] and
    attention_weights [B, Q, H, L, P] in f32.  Returns [B, Q, H*D] in
    value.dtype: bilinear samples at loc * (w, h) - 0.5, zero padding."""
    if value.device.type == "cpu":
        return ms_deform_attn(value, spatial_shapes, sampling_locations,
                              attention_weights)
    name = "ms_deform_attn_sep"
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
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_sep", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        _build.dtype_code(value.dtype), B, S, Q, H, D, L, P,
        _build.levels_arg(spatial_shapes), _build.stream_of(value))
    ms_deform_attn_sep.launches += 1
    return out


ms_deform_attn_sep.launches = 0
