"""Windowed multi-scale deformable attention for encoder grid queries, in
plain PyTorch.

Counterpart of monodetr_tpu/ops/msda_windowed.py, same function: each grid
query q (Q == S, level-major) samples every level at its pixel position
f = loc * (w, h) - 0.5, clamped to +-lim = +-(G/2 - 1 - 0.01) px around
q's static centre in that level, then exact bilinear MSDA (zero padding).
The JAX module writes it as static shifts of padded maps, a TPU device for
avoiding gathers; here it is the clamp followed by ops/msda.py's sampling,
which gives the same numbers.  It is `msda_impl: windowed` on every device,
and the plain version of the two windowed kernels (ops/msda_pallas.py,
ops/msda_sepwin.py).  Gradients come from autograd: the clamp passes the
location gradient inside the window and none outside.
"""

import torch

from .msda import level_sizes, ms_deform_attn_px
from .msda_enc import grid_centers, window_limit
from .utils import device_constant


def _is_pow2(x):
    return x > 0 and (x & (x - 1)) == 0


def check_grid_contract(name, value, spatial_shapes, n_queries, window):
    """Raise ValueError where the windowed semantics are undefined: queries
    that are not the level grid (Q != S), level sizes whose ratios are not
    powers of two on each axis, or an odd or too small window."""
    S = value.shape[1]
    if n_queries != S or S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"{name} needs grid queries (encoder self-attention): "
                         f"Q={n_queries}, S={S}, levels {spatial_shapes}")
    if window % 2 or window < 4:
        raise ValueError(f"{name}: window {window} must be even and >= 4")
    for ha, wa in spatial_shapes:
        for hb, wb in spatial_shapes:
            for a, b in ((ha, hb), (wa, wb)):
                r = max(a, b) // min(a, b)
                if min(a, b) * r != max(a, b) or not _is_pow2(r):
                    raise ValueError(f"{name} needs power-of-two level ratios per "
                                     f"axis; got sizes {a} vs {b}")


def clamp_offsets_to_window(offsets_px, window=8):
    """Pixel offsets clamped to the window's +-lim (msda_windowed.py:192)."""
    lim = window_limit(window)
    return offsets_px.clamp(-lim, lim)


def window_bounds(spatial_shapes, window):
    """(lo, hi) [S, L, 2] f32: each grid query's clamp range per level,
    centre -+ lim, in pixel coordinates."""
    c = grid_centers(spatial_shapes)
    lim = window_limit(window)
    return c - lim, c + lim


def clamp_to_window(sampling_locations, spatial_shapes, window):
    """Pixel positions [B, S, H, L, P, 2] f32 of normalised locations,
    clamped to each query's window."""
    dev = sampling_locations.device
    wh = device_constant(level_sizes, (tuple(spatial_shapes),), dev)
    lo, hi = (x[None, :, None, :, None, :] for x in
              device_constant(window_bounds, (tuple(spatial_shapes), window), dev))
    f = sampling_locations.float() * wh[:, None, :] - 0.5
    return torch.clamp(f, lo, hi)


def ms_deform_attn_windowed(value, spatial_shapes, sampling_locations,
                            attention_weights, window=8):
    """value [B, S, H, D]; sampling_locations [B, S, H, L, P, 2] normalised
    (x, y); attention_weights [B, S, H, L, P].  Returns [B, S, H*D] in
    value.dtype."""
    check_grid_contract("ms_deform_attn_windowed", value, spatial_shapes,
                        sampling_locations.shape[1], window)
    f = clamp_to_window(sampling_locations, spatial_shapes, window)
    return ms_deform_attn_px(value, spatial_shapes, f[..., 0], f[..., 1],
                             attention_weights)
