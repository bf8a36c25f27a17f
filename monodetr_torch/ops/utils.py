"""Small numeric primitives: inverse sigmoid, bilinear grid readout, LID
depth bins and depth binning, the sine position table, 1-D embedding lerp
and heading-bin decode.  Counterpart of monodetr_tpu/ops/utils.py (same math, torch
tensors; the numpy helpers are copied so that nothing here imports jax)."""

import functools
import math

import numpy as np
import torch

NUM_HEADING_BIN = 12  # lib/datasets/utils.py:6


@functools.lru_cache(maxsize=64)
def device_constant(fn, args, device):
    """The numpy array fn(*args) as a tensor on `device`, made once per
    (fn, args, device).  A copy from pageable host memory waits for the
    device's stream, so the forward must not make its constant tables
    anew; callers never write to the shared tensor."""
    return torch.from_numpy(np.asarray(fn(*args))).to(device)


def inverse_sigmoid(x, eps=1e-5):
    """utils/misc.py:473-477."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def grid_sample_bilinear(img, coords, align_corners=False):
    """Bilinear sampling of `img` [B, H, W, C] at normalised coords
    [B, ..., 2] in [-1, 1] (x, y): grid_sample semantics with zero padding.
    Returns [B, ..., C]."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    if align_corners:
        fx = (x + 1.0) * 0.5 * (W - 1)
        fy = (y + 1.0) * 0.5 * (H - 1)
    else:
        fx = (x + 1.0) * 0.5 * W - 0.5
        fy = (y + 1.0) * 0.5 * H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = img.reshape(B, H * W, C)
    lead = coords.shape[1:-1]

    def fetch(xi, yi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return v.reshape(B, *lead, C) * valid[..., None]

    return (fetch(x0, y0) * (1 - wx) * (1 - wy)
            + fetch(x0 + 1, y0) * wx * (1 - wy)
            + fetch(x0, y0 + 1) * (1 - wx) * wy
            + fetch(x0 + 1, y0 + 1) * wx * wy)


def lid_bin_values(num_bins, depth_min, depth_max):
    """LID bin centres plus the overflow value depth_max, [num_bins + 1]
    (depth_predictor.py:21-24)."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = np.arange(num_bins, dtype=np.float64)
    vals = (idx + 0.5) ** 2 * bin_size / 2 - bin_size / 8 + depth_min
    return np.concatenate([vals, [depth_max]]).astype(np.float32)


def bin_depths(depth_map, mode="LID", depth_min=1e-3, depth_max=60.0,
               num_bins=80):
    """Depth map -> int64 bin indices; out-of-range or non-finite depths go
    to num_bins (ddn_loss.py:66-102 with target=True): UD uniform bins, LID
    linearly increasing widths, SID log-spaced."""
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        indices = (depth_map - depth_min) / bin_size
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(1 + 8 * (depth_map - depth_min) / bin_size)
    elif mode == "SID":
        indices = (num_bins * (torch.log(1 + depth_map) - math.log(1 + depth_min))
                   / (math.log(1 + depth_max) - math.log(1 + depth_min)))
    else:
        raise NotImplementedError(f"bin_depths mode {mode!r}")
    invalid = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
    indices = torch.where(invalid, torch.full_like(indices, num_bins), indices)
    return indices.long()


def sine_position_encoding(h, w, num_pos_feats=128, temperature=10000.0,
                           scale=2 * math.pi):
    """Normalised sine position table [h, w, 2*num_pos_feats] for an
    all-valid mask (position_encoding.py:36-56)."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2)


def interpolate_1d_embed(coord, table):
    """Linear interpolation into a 1-D table [n, C] at coord [...] in
    [0, n-1] (depth_predictor.py:99-104: floor/ceil lerp, ceil clamped).
    The rows are read with index_select, whose backward adds into the
    table by atomics; `table[f]` would take PyTorch's sort-based indexing
    backward, 31 ms per training step at batch 16 on the H100 (30,720
    indices into 61 rows)."""
    floor_c = torch.floor(coord)
    delta = (coord - floor_c)[..., None]
    f = floor_c.long().reshape(-1)
    c = (f + 1).clamp(max=table.shape[0] - 1)
    rows = coord.shape + table.shape[1:]
    return (table.index_select(0, f).reshape(rows) * (1 - delta)
            + table.index_select(0, c).reshape(rows) * delta)


def class2angle_np(cls, residual, to_label_format=False):
    """Heading bin + residual -> angle (lib/datasets/utils.py:19-26)."""
    angle_per_class = 2 * np.pi / float(NUM_HEADING_BIN)
    angle = cls * angle_per_class + residual
    if to_label_format and angle > np.pi:
        angle = angle - 2 * np.pi
    return angle
