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

`window_tiles` is the geometry of the two windowed kernels' backward
(csrc/msda_win.cu): how the grid queries are cut into tiles, and which
rectangle of every sampled level a tile's value gradient is summed in, in
shared memory, before it is added to device memory.
"""

import dataclasses
import functools

import numpy as np
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
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    wh = device_constant(level_sizes, (shapes,), dev)
    lo, hi = (x[None, :, None, :, None, :] for x in
              device_constant(window_bounds, (shapes, window), dev))
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


# The backward of the windowed kernels: a block is WIN_HEADS heads of one
# tile (csrc/common.cuh:kWinBlockHeads), and holds, per head and sampled
# level, the f32 rows its in-window samples can touch.  Two blocks share an
# SM's 228 KB of shared memory (1 KB of each block's share is the system's);
# no block may ask for more than SMEM_MAX.
WIN_HEADS = 2
SMEM_MAX = 232_448
SMEM_PER_SM = 233_472
SMEM_BUDGET = SMEM_PER_SM // 2 - 1024
ROW_BYTES = 32 * 4  # one head's 32 channels of one token, f32
MAX_LEVELS = 4  # csrc/common.cuh:kWinLevels
# rows a warp has beside its rectangle: one for the corners that touch
# nothing, 8 for its 8 queries' output gradients, one for the tile's query
# ranges (common.cuh:kWinWarpRows)
WARP_ROWS = 10
TILE_SIDES = (1, 2, 4, 8, 16, 32)
TILE_QUERIES = (8, 64)  # of the largest level; a warp works on 8 queries at a time


def _centre(g, size_l, size_lq):
    """common.cuh:grid_centre: (g + 0.5) * size_l / size_lq - 0.5, rounded
    once to f32."""
    return np.float32((g + 0.5) * size_l / size_lq - 0.5)


def _rect_1d(g0, g1, size_l, size_lq, lim):
    """[lo, hi]: the pixels of a `size_l`-wide level that bilinear corners
    of samples within +-lim of the centres of queries g0 .. g1 of a
    `size_lq`-wide level can touch, clipped to the level.  f32 as in the
    kernels: the clamp bounds are f32(centre) -+ f32(lim)."""
    lim = np.float32(lim)
    lo = int(np.floor(_centre(g0, size_l, size_lq) - lim))
    hi = int(np.floor(_centre(g1, size_l, size_lq) + lim)) + 1
    return max(lo, 0), min(hi, size_l - 1)


def _first_query(t, side, size_m, size_lq):
    """The first query of a `size_lq`-wide level whose centre lies at or
    past pixel t * side of the `size_m`-wide largest level: the least g with
    (g + 0.5) * size_m / size_lq >= t * side."""
    return min((2 * t * side * size_lq + size_m - 1) // (2 * size_m), size_lq)


def _axis_tiles(n, side, main, sizes, lim):
    """One axis of the tiling, `n` tiles of `side` pixels of the level
    `main` wide (`sizes`: every level's width): per tile t and level,
    (first query, number of queries, first and last staged pixel).  The
    staged span of level l is the union of _rect_1d over the query levels
    that have a query in the tile."""
    first, count, lo, hi = (np.zeros((n, len(sizes)), np.int64) for _ in range(4))
    for t in range(n):
        for lq, size in enumerate(sizes):
            first[t, lq] = _first_query(t, side, sizes[main], size)
            count[t, lq] = _first_query(t + 1, side, sizes[main], size) - first[t, lq]
        for l, size_l in enumerate(sizes):
            spans = [_rect_1d(first[t, lq], first[t, lq] + count[t, lq] - 1, size_l, size, lim)
                     for lq, size in enumerate(sizes) if count[t, lq] > 0]
            lo[t, l] = min(a for a, _ in spans)
            hi[t, l] = max(b for _, b in spans)
    return first, count, lo, hi


@dataclasses.dataclass(frozen=True)
class WindowTiles:
    """The tiling of one pyramid and window.  A tile is `side` = (tw, th)
    pixels of level `main`, the level with the most queries, and takes the
    queries of every level whose centres lie in it; `grid` = (tiles per
    row, rows of tiles).  `tile[lq]` = the most queries (across, down) of
    level lq in any tile, `first[lq]` the index of level lq's first slot
    among a tile's `queries` slots (level-major, row-major within the
    level).  Per sampled level l: `rect[l]` = (rw, rh), the rows a tile
    stages, and `offset[l]`, the rectangle's first row in a head's window
    of `rows` rows.  `columns[tx]` and `bands[ty]` say, per level, which
    queries a tile holds and where its rectangle starts: three rows of L
    ints each, (first query, number of queries, rectangle's first pixel)
    along x and along y; `query_range` and `origin` read them.  `smem_bytes`
    is what a block asks for: WIN_HEADS windows and WARP_ROWS rows per
    warp."""
    spatial_shapes: tuple
    window: int
    main: int
    side: tuple
    grid: tuple
    tile: tuple
    first: tuple
    queries: int
    rect: tuple
    offset: tuple
    rows: int
    columns: tuple
    bands: tuple
    smem_bytes: int

    @property
    def n_tiles(self):
        return self.grid[0] * self.grid[1]

    def query_range(self, lq, tx, ty):
        """(gx0, gy0, nx, ny): the pixels of level lq in tile (tx, ty)."""
        (gx0, nx, _), (gy0, ny, _) = self.columns[tx], self.bands[ty]
        return gx0[lq], gy0[lq], nx[lq], ny[lq]

    def origin(self, l, tx, ty):
        """(x0, y0) of the staged rectangle of level l for tile (tx, ty):
        the smallest, over the query levels with a query in the tile, of
        floor(centre of its first query there - lim), clipped to the level."""
        return self.columns[tx][2][l], self.bands[ty][2][l]

    def packed(self):
        """The int32 table the kernels take by value (common.cuh:
        make_win_plan): what is the same for every tile."""
        head = np.array([*self.grid, self.rows, self.queries], np.int32)
        per_level = np.zeros((6, MAX_LEVELS), np.int32)
        for l in range(len(self.spatial_shapes)):
            per_level[:, l] = (*self.tile[l], self.first[l], *self.rect[l], self.offset[l])
        return np.concatenate([head, per_level.ravel()])

    def tile_table(self):
        """The int32 table [nx + ny, 3, L] the kernels read from device
        memory (common.cuh:win_warp): `columns`, then `bands`.  The kernels
        compute no tile geometry of their own."""
        return np.array(self.columns + self.bands, np.int32)


@functools.lru_cache(maxsize=None)
def _window_tiles(spatial_shapes, window):
    L = len(spatial_shapes)
    if L > MAX_LEVELS:
        raise ValueError(f"window_tiles: at most {MAX_LEVELS} levels, got {L}")
    lim = window_limit(window)
    hs, ws = zip(*spatial_shapes)
    n_queries = sum(h * w for h, w in spatial_shapes)
    main = max(range(L), key=lambda lq: hs[lq] * ws[lq])
    hm, wm = spatial_shapes[main]
    best = None
    for tw in TILE_SIDES:
        for th in TILE_SIDES:
            if not TILE_QUERIES[0] <= min(tw, wm) * min(th, hm) <= TILE_QUERIES[1]:
                continue
            xs = _axis_tiles(-(-wm // tw), tw, main, ws, lim)
            ys = _axis_tiles(-(-hm // th), th, main, hs, lim)
            rect = tuple((int((xs[3][:, l] - xs[2][:, l]).max()) + 1,
                          int((ys[3][:, l] - ys[2][:, l]).max()) + 1) for l in range(L))
            rows = sum(rw * rh for rw, rh in rect)
            smem = (WIN_HEADS * rows + WIN_HEADS * L * WARP_ROWS) * ROW_BYTES
            if smem > SMEM_BUDGET:
                continue
            n_tiles = len(xs[0]) * len(ys[0])
            reuse = n_queries / n_tiles * L * 4 * 4 / rows  # 4 points, 4 corners
            if best is None or reuse > best[0]:
                best = (reuse, (tw, th), xs, ys, rect, rows, smem)
    if best is None:
        raise ValueError(
            f"window_tiles: no tile of {spatial_shapes} with window {window} fits "
            f"{SMEM_BUDGET} bytes of shared memory for {WIN_HEADS} heads; use msda_impl "
            f"'windowed' or 'gather'")
    _, side, xs, ys, rect, rows, smem = best
    tile = tuple((int(xs[1][:, lq].max()), int(ys[1][:, lq].max())) for lq in range(L))
    counts = [a * b for a, b in tile]
    first = tuple(int(x) for x in np.cumsum([0] + counts[:-1]))
    offset = tuple(int(x) for x in np.cumsum([0] + [rw * rh for rw, rh in rect][:-1]))
    columns, bands = (
        tuple(tuple(tuple(int(v) for v in part[t]) for part in axis[:3])
              for t in range(len(axis[0]))) for axis in (xs, ys))
    return WindowTiles(spatial_shapes, window, main, side, (len(columns), len(bands)), tile,
                       first, sum(counts), rect, offset, rows, columns, bands, smem)


def window_tiles(spatial_shapes, window):
    """The tiling for a pyramid and window.  The image is cut into tiles of
    tw x th pixels of the level with the most queries (power-of-two sides, 8
    to 64 of its queries); a tile takes the queries of every level whose
    centres lie in it, and their windows overlap.  Among the tiles whose
    block of WIN_HEADS heads fits SMEM_BUDGET bytes of shared memory, the
    one with the most corner adds per staged row is taken; if none fits,
    ValueError."""
    return _window_tiles(tuple((int(h), int(w)) for h, w in spatial_shapes), int(window))


def _tile_table(spatial_shapes, window):
    return window_tiles(spatial_shapes, window).tile_table()


@functools.lru_cache(maxsize=None)
def _plan_arg(spatial_shapes, window):
    from .. import _build

    return _build.ints_arg(window_tiles(spatial_shapes, window).packed())


def window_plan_args(spatial_shapes, window, device):
    """The tiling as the backward kernels' `plan` (a host int array) and
    `tiles` (the address of the per-tile table on `device`) arguments."""
    t = window_tiles(spatial_shapes, window)
    key = (t.spatial_shapes, t.window)
    return _plan_arg(*key), device_constant(_tile_table, key, device).data_ptr()


def backward_occupancy(kernel, dtype, spatial_shapes, window):
    """(blocks an SM holds, shared bytes a block asks for) of the backward
    of kernel 5 or 6 at this tiling, as the CUDA runtime reports them."""
    import ctypes

    from .. import _build

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    t = window_tiles(spatial_shapes, window)
    _build.launch("mdt_msda_win_bwd_occupancy", kernel, _build.dtype_code(dtype),
                  len(spatial_shapes), _plan_arg(t.spatial_shapes, t.window),
                  ctypes.addressof(blocks), ctypes.addressof(smem))
    return blocks.value, smem.value
