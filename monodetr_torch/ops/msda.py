"""Plain multi-scale deformable attention with exact reference semantics.

Counterpart of monodetr_tpu/ops/msda.py:ms_deform_attn_reference, and the
plain PyTorch version that the two MSDA kernels (ops/msda_enc.py,
ops/msda_sep.py) are held against: per level, bilinear sampling with zero
padding and align_corners=False (`F.grid_sample`, as the reference's
ms_deform_attn_core_pytorch does), weighted by the attention weights and
summed over levels and points.  Arithmetic runs in f32; the result is
returned in the value's dtype.

Shapes:
  value:              [B, S, H, D]   S = sum_l h_l * w_l
  spatial_shapes:     ((h0, w0), ...) python ints
  sampling_locations: [B, Q, H, L, P, 2] normalised (x, y)
  attention_weights:  [B, Q, H, L, P]
  returns             [B, Q, H * D]
"""

import numpy as np
import torch
import torch.nn.functional as F

from .utils import device_constant


def level_sizes(spatial_shapes):
    """[L, 2] f32 (w, h) of each level."""
    return np.array([[w, h] for h, w in spatial_shapes], np.float32)


def level_start_indices(spatial_shapes):
    sizes = [h * w for h, w in spatial_shapes]
    return tuple(np.cumsum([0] + sizes[:-1]).tolist())


def ms_deform_attn_px(value, spatial_shapes, fx, fy, attention_weights):
    """Sample at pixel positions (fx, fy) [B, Q, H, L, P] of each level's
    grid (pixel centres at integers, so x = loc_x * w - 0.5)."""
    B, S, H, D = value.shape
    Q, L, P = fx.shape[1], fx.shape[3], fx.shape[4]
    starts = level_start_indices(spatial_shapes)
    v = value.float()
    att = attention_weights.float()
    out = torch.zeros(B * H, D, Q, device=value.device, dtype=torch.float32)
    for lid, (h, w) in enumerate(spatial_shapes):
        v_l = v[:, starts[lid]:starts[lid] + h * w]  # [B, h*w, H, D]
        v_l = v_l.permute(0, 2, 3, 1).reshape(B * H, D, h, w)
        gx = (fx[:, :, :, lid].float() + 0.5) * (2.0 / w) - 1.0  # [B, Q, H, P]
        gy = (fy[:, :, :, lid].float() + 0.5) * (2.0 / h) - 1.0
        grid = torch.stack([gx, gy], -1).transpose(1, 2).reshape(B * H, Q, P, 2)
        s = F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # [B*H, D, Q, P]
        a = att[:, :, :, lid].transpose(1, 2).reshape(B * H, 1, Q, P)
        out = out + (s * a).sum(-1)
    out = out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
    return out.to(value.dtype)


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Exact MSDA from normalised sampling locations."""
    wh = device_constant(level_sizes, (tuple(spatial_shapes),), value.device)
    f = sampling_locations.float() * wh[:, None, :] - 0.5  # [B, Q, H, L, P, 2]
    return ms_deform_attn_px(value, spatial_shapes, f[..., 0], f[..., 1],
                             attention_weights)
