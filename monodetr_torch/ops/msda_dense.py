"""Exact deformable attention for decoder-sized query counts: the decoder's
`dec_msda_impl: dense` and `dense_fused` paths.

`ms_deform_attn_dense` is monodetr_tpu/ops/msda.py:ms_deform_attn_dense
under its JAX name: the exact function (bilinear, zero padding,
align_corners=False) in plain PyTorch, ops/msda.py:ms_deform_attn.  The
JAX package computes it with dense hat-function matmuls, a TPU device for
avoiding gathers; the numbers are the same.  It is `dense` on every device
and the plain version of kernel 7.

`ms_deform_attn_dense_fused` (monodetr_tpu/ops/msda_dense_pallas.py) is
the same function through CUDA kernels (csrc/msda_loc.cu): the forward
msda_dense_fused_kernel, and a backward that scatters nothing, as the TPU
kernel's does not, in three launches: msda_sep_bwd_kernel without its value
gradient gives dloc and dattn per query; msda_dense_fused_bwd_bin_kernel
sorts the samples by the tiles of pixels they touch; and
msda_dense_fused_bwd_value_kernel writes each tile's dvalue rows once from
its own list of samples, every sum in a fixed order, so dvalue is the same
bits from run to run.  The tiles are `value_bins`' plan, made here and held
to brute force by the CPU tests; the kernels compute none of it.  Accepted
shapes are kernel 2's (ops/msda_sep.py), forward and backward.
"""

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..utils.trace import count
from .msda import ms_deform_attn
from .msda_sep import check_loc_args

ms_deform_attn_dense = ms_deform_attn

MAX_LEVELS = 8    # csrc/common.cuh:kMaxLevels
# tiles of (tw, th) pixels, powers of two.  A tile's list of samples for one
# head is walked by one warp, in order, and a sample makes one entry per tile
# it touches: small tiles make short lists but more entries.  8 x 8, and 4 x
# 4 for a level of at most SMALL_LEVEL pixels, whose few tiles would
# otherwise gather the longest lists (the 6 x 20 level of a 384 x 1280 image)
TILE, SMALL_TILE, SMALL_LEVEL = (8, 8), (4, 4), 128


@dataclasses.dataclass(frozen=True)
class ValueBins:
    """The tiles of kernel 7's value side for one pyramid.
    Level l is cut into `grid[l]` = (ntx, nty) tiles of `tile[l]` = (tw, th)
    pixels, numbered row-major from `first[l]` on; `bins` tiles in all, the
    largest of `rows` pixels (the value-side block keeps 8 heads x `rows`
    rows of 32 f32 channels in shared memory)."""
    spatial_shapes: tuple
    tile: tuple
    grid: tuple
    first: tuple
    bins: int
    rows: int

    def packed(self):
        """The int32 table the kernels take by value (csrc/msda_loc.cu:
        BinPlan)."""
        per_level = np.zeros((5, MAX_LEVELS), np.int32)
        for l in range(len(self.spatial_shapes)):
            per_level[:, l] = (*self.tile[l], *self.grid[l], self.first[l])
        return np.concatenate([np.array([self.bins, self.rows], np.int32), per_level.ravel()])

    def entries(self, l, x, y):
        """The entries csrc/msda_loc.cu:bin_entry makes of a sample of
        weight 1 at pixel position (x, y) of level l, f32 as there: a list
        of (tile index in the level, tile-local row of corner (x0, y0), the
        four corner weights that fall in the tile, 0 for the others), in
        slot order.  Corner k = 0 (x0, y0), 1 (x0 + 1, y0), 2 (x0, y0 + 1),
        3 lies (k & 1) + (k >> 1) * tw rows after corner 0's."""
        h, w = self.spatial_shapes[l]
        (tw, th), (ntx, _) = self.tile[l], self.grid[l]
        x, y = np.float32(x), np.float32(y)
        with np.errstate(invalid="ignore"):
            x0f, y0f = np.floor(x), np.floor(y)
            x0 = int(np.fmin(np.fmax(x0f, np.float32(-2)), np.float32(w)))
            y0 = int(np.fmin(np.fmax(y0f, np.float32(-2)), np.float32(h)))
            lx, ly = x - x0f, y - y0f
        txc = [(x0 + d) // tw if 0 <= x0 + d < w else -1 for d in (0, 1)]
        tyc = [(y0 + d) // th if 0 <= y0 + d < h else -1 for d in (0, 1)]
        weight = [(lx if k & 1 else np.float32(1) - lx) * (ly if k >> 1 else np.float32(1) - ly)
                  for k in range(4)]
        out = []
        for slot in range(4):
            sx, sy = slot & 1, slot >> 1
            if (sx and txc[1] == txc[0]) or (sy and tyc[1] == tyc[0]):
                continue
            tx, ty = txc[sx], tyc[sy]
            if tx < 0 or ty < 0:
                continue
            wk = [weight[k] if txc[k & 1] == tx and tyc[k >> 1] == ty else np.float32(0)
                  for k in range(4)]
            if all(v == 0 for v in wk):
                continue
            out.append((ty * ntx + tx, (y0 - ty * th) * tw + (x0 - tx * tw), wk))
        return out


@functools.lru_cache(maxsize=None)
def _value_bins(spatial_shapes):
    if not 1 <= len(spatial_shapes) <= MAX_LEVELS:
        raise ValueError(f"value_bins: 1 to {MAX_LEVELS} levels, got {len(spatial_shapes)}")
    tile = tuple(SMALL_TILE if h * w <= SMALL_LEVEL else TILE for h, w in spatial_shapes)
    grid = tuple((-(-w // tw), -(-h // th)) for (h, w), (tw, th) in zip(spatial_shapes, tile))
    counts = [a * b for a, b in grid]
    first = tuple(int(x) for x in np.cumsum([0] + counts[:-1]))
    return ValueBins(spatial_shapes, tile, grid, first, sum(counts),
                     max(tw * th for tw, th in tile))


def value_bins(spatial_shapes):
    """The tiling of kernel 7's value side for a pyramid, a function of the
    pyramid alone: TILE pixels a tile, SMALL_TILE for a level of at most
    SMALL_LEVEL pixels; a level of any size (the binning kernel sorts 1,024
    tiles at a time)."""
    return _value_bins(tuple((int(h), int(w)) for h, w in spatial_shapes))


@functools.lru_cache(maxsize=None)
def _bins_arg(bins):
    return _build.ints_arg(bins.packed())


def _launch_fwd(value, spatial_shapes, sampling_locations, attention_weights):
    B, S, Q, H, D, L, P = check_loc_args("ms_deform_attn_dense_fused", value, spatial_shapes,
                                         sampling_locations, attention_weights)
    out = torch.empty(B, Q, H * D, dtype=value.dtype, device=value.device)
    _build.launch(
        "mdt_msda_dense_fused", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), _build.dtype_code(value.dtype),
        B, S, Q, H, D, L, P, _build.levels_arg(spatial_shapes), _build.stream_of(value))
    count("msda_dense_fused")
    return out


def ms_deform_attn_dense_fused_bwd(value, spatial_shapes, sampling_locations,
                                   attention_weights, gout):
    """The three backward kernels on CUDA tensors, counted as one launch:
    (dvalue in value's dtype, dloc f32, dattn f32) for the output gradient
    `gout` [B, Q, H*D].  No atomics on device memory: dvalue is the same
    bits from run to run.  Scratch: room for 4 entries of 32 bytes per
    sample (a sample touches at most 2 x 2 tiles), and per (batch item,
    head, tile) its list's (first entry, entries)."""
    name = "ms_deform_attn_dense_fused_bwd"
    B, S, Q, H, D, L, P = check_loc_args(name, value, spatial_shapes, sampling_locations,
                                         attention_weights)
    gout = gout.contiguous()
    if gout.shape != (B, Q, H * D) or gout.dtype != value.dtype:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, value, gout)
    bins = value_bins(spatial_shapes)
    gvalue = torch.empty_like(value)
    gloc = torch.empty_like(sampling_locations)
    gattn = torch.empty_like(attention_weights)
    entries = torch.empty(4 * B * H * L * Q * P * 8, dtype=torch.float32, device=value.device)
    table = torch.empty(B, H, bins.bins, 2, dtype=torch.int32, device=value.device)
    _build.launch(
        "mdt_msda_dense_fused_bwd", value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), gout.data_ptr(), gvalue.data_ptr(), gloc.data_ptr(),
        gattn.data_ptr(), entries.data_ptr(), table.data_ptr(), _build.dtype_code(value.dtype),
        B, S, Q, H, D, L, P, _build.levels_arg(spatial_shapes),
        _bins_arg(bins), _build.stream_of(value))
    count("msda_dense_fused_bwd")
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
