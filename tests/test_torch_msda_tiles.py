"""The geometry of the windowed kernels' backward
(monodetr_torch/ops/msda_windowed.py:window_tiles) against brute force in
numpy: the tiles partition the grid queries of every level, every corner an
in-window sample can touch lies in its tile's staged rectangle, and the shared
memory asked for is what the table says and fits the card.  Runs on the
CPU.  The kernels compute no tile geometry of their own: which queries a
tile holds and where its rectangles start they read from
WindowTiles.tile_table, the numbers held to brute force here.  What they do
with them (the order of a tile's query slots, kernel 6's clamp centre, the
sums) is tested on the card, in test_torch_cuda.py.
"""

import numpy as np
import pytest

from monodetr_torch.ops.msda_enc import grid_centers, window_limit
from monodetr_torch.ops.msda_windowed import (MAX_LEVELS, ROW_BYTES, SMEM_BUDGET, SMEM_MAX,
                                              SMEM_PER_SM, WARP_ROWS, WIN_HEADS, window_tiles)

FULL = ((48, 160), (24, 80), (12, 40), (6, 20))  # 384x1280 / 8 .. 64
SMALL = ((8, 16), (4, 8), (2, 4), (1, 2))
RAGGED = ((12, 20), (6, 10), (3, 5), (3, 5))  # tiles past the border, two equal levels
MIXED = ((4, 64), (32, 16), (4, 8), (4, 8))  # the largest level is not the first, nor the widest
CASES = [(FULL, 6), (FULL, 8), (FULL, 4), (SMALL, 6), (SMALL, 8), (RAGGED, 6), (RAGGED, 4),
         (MIXED, 6)]
SEED = 0


def tiles_of(t, lq):
    """[(tx, ty, [(gx, gy), ...]), ...]: every tile with its queries of
    level lq."""
    out = []
    for ty in range(t.grid[1]):
        for tx in range(t.grid[0]):
            gx0, gy0, nx, ny = t.query_range(lq, tx, ty)
            out.append((tx, ty, [(gx, gy) for gy in range(gy0, gy0 + ny)
                                 for gx in range(gx0, gx0 + nx)]))
    return out


@pytest.mark.parametrize("shapes,window", CASES)
def test_tiles_partition_the_grid_queries(shapes, window):
    """Every query of every level lies in exactly one tile, the one that
    holds its centre, and a tile's queries fit its slots."""
    t = window_tiles(shapes, window)
    hm, wm = shapes[t.main]
    assert hm * wm == max(h * w for h, w in shapes)
    assert t.grid == (-(-wm // t.side[0]), -(-hm // t.side[1]))
    first = 0
    for lq, (hq, wq) in enumerate(shapes):
        assert t.first[lq] == first
        first += t.tile[lq][0] * t.tile[lq][1]
        seen = []
        for tx, ty, qs in tiles_of(t, lq):
            _, _, nx, ny = t.query_range(lq, tx, ty)
            assert 0 <= nx <= t.tile[lq][0] and 0 <= ny <= t.tile[lq][1]
            for gx, gy in qs:  # the centre, in pixels of the largest level, is in the tile
                assert tx * t.side[0] <= (gx + 0.5) * wm / wq < (tx + 1) * t.side[0]
                assert ty * t.side[1] <= (gy + 0.5) * hm / hq < (ty + 1) * t.side[1]
            seen += qs
        assert len(seen) == len(set(seen)) == hq * wq
        assert set(seen) == {(gx, gy) for gy in range(hq) for gx in range(wq)}
    assert t.queries == first


@pytest.mark.parametrize("shapes,window", CASES)
def test_in_window_corners_lie_in_the_tile_rectangle(shapes, window):
    """For every query and sampled level: the corners of the window's four
    extreme positions, its centre and 16 seeded positions in centre +- lim
    that lie inside the level lie inside the query's tile's rectangle."""
    t = window_tiles(shapes, window)
    rng = np.random.default_rng(SEED)
    centres = grid_centers(shapes)  # [S, L, 2] f32, the plain version's table
    lim = np.float32(window_limit(window))
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    checked = 0
    for lq, (hq, wq) in enumerate(shapes):
        for tx, ty, qs in tiles_of(t, lq):
            if not qs:
                continue
            q = np.array([starts[lq] + gy * wq + gx for gx, gy in qs])
            for l, (hl, wl) in enumerate(shapes):
                x0, y0 = t.origin(l, tx, ty)
                rw, rh = t.rect[l]
                c = centres[q, l]  # [n, 2]
                u = np.concatenate([np.array([[-1, -1], [-1, 1], [1, -1], [1, 1], [0, 0]], np.float32),
                                    rng.uniform(-1, 1, (16, 2)).astype(np.float32)])
                # f32 as the kernels: clamp(c + u * lim, c - lim, c + lim)
                pos = np.clip(c[:, None] + u[None] * lim, c[:, None] - lim, c[:, None] + lim)
                base = np.floor(pos).astype(np.int64)  # [n, 21, 2]
                for ox in (0, 1):
                    for oy in (0, 1):
                        cx, cy = base[..., 0] + ox, base[..., 1] + oy
                        inside = (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
                        ok = (cx >= x0) & (cx < x0 + rw) & (cy >= y0) & (cy < y0 + rh)
                        assert (ok | ~inside).all(), (lq, l, tx, ty)
                        checked += int(inside.sum())
    assert checked > 0


@pytest.mark.parametrize("shapes,window", CASES)
def test_shared_memory_is_what_the_table_says_and_fits(shapes, window):
    t = window_tiles(shapes, window)
    L = len(shapes)
    assert t.rows == sum(rw * rh for rw, rh in t.rect)
    assert t.smem_bytes == (WIN_HEADS * t.rows + WIN_HEADS * L * WARP_ROWS) * ROW_BYTES
    assert t.smem_bytes <= SMEM_BUDGET <= SMEM_MAX == 232_448
    assert SMEM_BUDGET == SMEM_PER_SM // 2 - 1024  # two blocks an SM, 1 KB each the system's
    assert 8 <= min(t.side[0], shapes[t.main][1]) * min(t.side[1], shapes[t.main][0]) <= 64
    end = 0
    for l in range(L):  # the rectangles tile the head's window without overlap
        assert t.offset[l] == end
        end += t.rect[l][0] * t.rect[l][1]
    # the int table the kernels take by value: (nx, ny, rows, queries), then
    # per level the slots across and down, the first slot, and the
    # rectangle's width, height and first row
    table = t.packed()
    assert table.dtype == np.int32 and table.shape == (4 + 6 * MAX_LEVELS,)
    assert tuple(table[:4]) == (*t.grid, t.rows, t.queries)
    per_level = table[4:].reshape(6, MAX_LEVELS)
    for l in range(L):
        assert tuple(per_level[:, l]) == (*t.tile[l], t.first[l], *t.rect[l], t.offset[l])
    assert not per_level[:, L:].any()


def test_production_tiling():
    """The shipped model's pyramid at G = 6: a tile is 8 x 8 pixels of the
    finest level with the 4 x 4, 2 x 2 and 1 of the coarser ones, 85
    queries on 350 rows; two blocks of 2 heads share an SM."""
    t = window_tiles(FULL, 6)
    assert t.side == (8, 8) and t.tile == ((8, 8), (4, 4), (2, 2), (1, 1)) and t.queries == 85
    assert t.rect == ((12, 12), (10, 10), (8, 8), (7, 6)) and t.rows == 350
    assert t.grid == (20, 6) and t.n_tiles == 120
    assert WIN_HEADS == 2 and t.smem_bytes == 99_840 and 2 * (t.smem_bytes + 1024) <= 233_472


def test_a_coarse_pixel_wider_than_the_tile():
    """At G = 8 the tile is 4 x 8 pixels, half a pixel of the coarsest
    level across: every other tile holds one of its queries."""
    t = window_tiles(FULL, 8)
    assert t.side == (4, 8) and t.tile[3] == (1, 1)
    assert [t.query_range(3, tx, 0)[2] for tx in range(4)] == [0, 1, 0, 1]


@pytest.mark.parametrize("shapes,window", CASES)
def test_the_per_tile_table_is_what_the_brute_force_checked(shapes, window):
    """WindowTiles.tile_table, which the kernels read from device memory:
    int32 [nx + ny, 3, L], per column and then per band of tiles the first
    query, the number of queries and the rectangle's first pixel of every
    level: the very numbers query_range and origin return."""
    t = window_tiles(shapes, window)
    L, (nx, ny) = len(shapes), t.grid
    table = t.tile_table()
    assert table.dtype == np.int32 and table.shape == (nx + ny, 3, L)
    assert (table >= 0).all()
    for ty in range(ny):
        for tx in range(nx):
            for l in range(L):
                gx0, gy0, n_x, n_y = t.query_range(l, tx, ty)
                assert tuple(table[tx, :2, l]) == (gx0, n_x)
                assert tuple(table[nx + ty, :2, l]) == (gy0, n_y)
                assert (table[tx, 2, l], table[nx + ty, 2, l]) == t.origin(l, tx, ty)
                # the rectangle from its origin stays inside the head's window
                assert 0 <= t.origin(l, tx, ty)[0] < shapes[l][1]
                assert 0 <= t.origin(l, tx, ty)[1] < shapes[l][0]


@pytest.mark.parametrize("shapes,window", [
    (FULL, 64),  # a +-31 px window: no tile fits
    (FULL, 32),
    (((64, 64),) * 4, 32),
    (((48, 160), (24, 80), (12, 40), (6, 20), (3, 10)), 6),  # more levels than a block has warps for
])
def test_a_pyramid_that_does_not_fit_raises(shapes, window):
    with pytest.raises(ValueError, match="shared memory|at most 4 levels"):
        window_tiles(shapes, window)


def test_shapes_given_as_lists_are_the_same_tiling():
    """Lists of lists (what a config file holds) and numpy ints name the
    same cached tiling as tuples of ints."""
    t = window_tiles(FULL, 6)
    assert window_tiles([list(hw) for hw in FULL], 6) is t
    assert window_tiles(np.array(FULL), np.int64(6)) is t
