"""Small numeric primitives: inverse sigmoid, bilinear grid readout, LID
depth bins and depth binning, the sine position table, 1-D embedding lerp,
heading-bin encode and decode, and the reference's heatmap and drawing
helpers (gaussian radius, gaussian patches, a projected 3-D box).
Counterpart of monodetr_tpu/ops/utils.py (same math, torch tensors; the
numpy helpers are copied so that nothing here imports jax)."""

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


def bin_depths_lid(depth_map, depth_min=1e-3, depth_max=60.0, num_bins=80):
    """Depth map -> LID bin indices (ddn_loss.py mode='LID', target=True)."""
    return bin_depths(depth_map, "LID", depth_min, depth_max, num_bins)


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


def angle2class_np(angle):
    """Continuous heading angle -> (bin id, residual) (lib/datasets/utils.py:8-16)."""
    angle = angle % (2 * np.pi)
    angle_per_class = 2 * np.pi / float(NUM_HEADING_BIN)
    shifted_angle = (angle + angle_per_class / 2) % (2 * np.pi)
    class_id = int(shifted_angle / angle_per_class)
    residual_angle = shifted_angle - (class_id * angle_per_class + angle_per_class / 2)
    return class_id, residual_angle


def gaussian_radius(bbox_size, min_overlap=0.7):
    """Minimum gaussian radius keeping IoU >= min_overlap for an (h, w) box:
    the three quadratic cases of CornerNet (lib/datasets/utils.py:29-50).
    All three roots take the published "(b + sqrt) / 2" form, without the
    1 / 2a factor, as every published implementation does."""
    height, width = bbox_size

    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    b1 = height + width
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian2d(shape, sigma=1.0):
    """Unnormalised 2-D gaussian patch (lib/datasets/utils.py:52-58)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_heatmap_gaussian(heatmap, center, radius, k=1):
    """Max-composite a gaussian peak into the numpy `heatmap` in place
    (umich style, lib/datasets/utils.py:61-74); heatmap targets are built
    on the host, in the data pipeline."""
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if right + left <= 0 or bottom + top <= 0:
        return heatmap
    region = heatmap[y - top:y + bottom, x - left:x + right]
    patch = gaussian[radius - top:radius + bottom, radius - left:radius + right]
    np.maximum(region, patch * k, out=region)
    return heatmap


def draw_msra_gaussian(heatmap, center, sigma):
    """Max-composite an msra-style (sigma-parameterised) gaussian
    (lib/datasets/utils.py:77-98), with the reference's (w, h) naming swap
    (it takes shape[0] as w), harmless on square maps and kept for bit
    parity."""
    tmp_size = sigma * 3
    mu_x = int(center[0] + 0.5)
    mu_y = int(center[1] + 0.5)
    w, h = heatmap.shape[0], heatmap.shape[1]
    ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
    br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
    if ul[0] >= h or ul[1] >= w or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(0, size, 1, np.float32)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    g_x = max(0, -ul[0]), min(br[0], h) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], w) - ul[1]
    img_x = max(0, ul[0]), min(br[0], h)
    img_y = max(0, ul[1]), min(br[1], w)
    heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
        heatmap[img_y[0]:img_y[1], img_x[0]:img_x[1]],
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]])
    return heatmap


def draw_projected_box3d(image, corners2d, color=(255, 255, 255), thickness=1):
    """Draw the 12 edges of a projected 3-D box into a numpy image
    (lib/datasets/utils.py:101-124; vertices 0-3 the top ring, 4-7 the
    bottom ring)."""
    import cv2

    corners2d = corners2d.astype(np.int32)
    for k in range(0, 4):
        for i, j in ((k, (k + 1) % 4), (k + 4, (k + 1) % 4 + 4), (k, k + 4)):
            cv2.line(image, (int(corners2d[i, 0]), int(corners2d[i, 1])),
                     (int(corners2d[j, 0]), int(corners2d[j, 1])), color, thickness,
                     lineType=cv2.LINE_AA)
    return image
