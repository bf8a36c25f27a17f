"""The host-side decisions of kernels 2 and 7 (CPU, no JAX, no card): which
shapes the kernels take (`check_loc_shape`), and the tiles of kernel 7's
value side (`value_bins`) with the entries its binning kernel makes of a
sample (`ValueBins.entries`, the kernel's arithmetic op for op) against
brute force over every tile's rectangle.  The CUDA code reads these tables
and computes no geometry of its own."""

import numpy as np
import pytest

from monodetr_torch.ops.msda_dense import (MAX_LEVELS, SMALL_LEVEL, SMALL_TILE, TILE, ValueBins,
                                           value_bins)
from monodetr_torch.ops.msda_sep import INT32_MAX, MAX_SAMPLES, check_loc_shape, fits_int32

FULL = ((48, 160), (24, 80), (12, 40), (6, 20))
SMALL = ((8, 16), (4, 8), (2, 4), (1, 2))
ODD = ((7, 13), (5, 3), (1, 1))
LARGE = ((300, 260), (16, 9))  # 33 x 38 = 1,254 tiles: two slabs of the binning kernel
PYRAMIDS = [FULL, SMALL, ODD, LARGE, ((96, 320), (48, 160), (24, 80), (12, 40)), ((8, 16),),
            ((16, 8), (8, 17))]


@pytest.mark.parametrize("S,H,L,P,fits", [
    (10200, 8, 4, 4, True), (10200, 8, 4, 8, True), (10200, 8, 1, 1, True),
    (10200, 8, 8, 4, True), (4194303, 8, 4, 4, True), (4194304, 8, 4, 4, False),
    (4194304, 8, 4, 8, False), (33554431, 1, 4, 4, True), (33554432, 1, 2, 2, False)])
def test_loc_shapes_by_samples_and_offsets(S, H, L, P, fits):
    """Any accepted number of samples wherever 32-bit offsets reach a batch
    item's tokens; a ValueError that says so beyond."""
    assert fits_int32(S, H) == (S * H * 64 <= INT32_MAX) == fits
    if fits:
        check_loc_shape("kernel", S, H, L, P)
    else:
        with pytest.raises(ValueError, match="32-bit offsets"):
            check_loc_shape("kernel", S, H, L, P)


@pytest.mark.parametrize("L,P", [(4, 9), (8, 5), (1, 33), (0, 4), (4, 0)])
def test_loc_shapes_refuse_more_samples_than_the_kernels_take(L, P):
    assert L * P > MAX_SAMPLES or L * P == 0
    with pytest.raises(ValueError, match="samples per head"):
        check_loc_shape("kernel", 10200, 8, L, P)


def tile_rect(bins, l, t):
    """Pixels [x0, x1) x [y0, y1) of tile t of level l, clipped to the level."""
    h, w = bins.spatial_shapes[l]
    (tw, th), (ntx, _) = bins.tile[l], bins.grid[l]
    ty, tx = divmod(t, ntx)
    return tx * tw, min((tx + 1) * tw, w), ty * th, min((ty + 1) * th, h)


@pytest.mark.parametrize("shapes", PYRAMIDS)
def test_value_bins_partition_every_level(shapes):
    """Every pixel lies in exactly one tile; the tiles are numbered level by
    level, row-major; none is larger than `rows`; powers of two."""
    bins = value_bins(shapes)
    assert isinstance(bins, ValueBins) and bins.spatial_shapes == shapes
    first = 0
    for l, (h, w) in enumerate(shapes):
        tw, th = bins.tile[l]
        ntx, nty = bins.grid[l]
        assert tw & (tw - 1) == 0 and th & (th - 1) == 0
        assert bins.first[l] == first
        cover = np.zeros((h, w), int)
        for t in range(ntx * nty):
            x0, x1, y0, y1 = tile_rect(bins, l, t)
            assert x0 < x1 and y0 < y1  # no tile lies outside the level
            cover[y0:y1, x0:x1] += 1
        assert (cover == 1).all()
        assert tw * th <= bins.rows
        first += ntx * nty
    assert bins.bins == first and bins.rows == max(tw * th for tw, th in bins.tile)


@pytest.mark.parametrize("shapes", PYRAMIDS)
def test_value_bins_tile_by_level_size(shapes):
    """8 x 8 pixels a tile, 4 x 4 for a level of at most 128 pixels: the
    plan is a function of the pyramid alone."""
    bins = value_bins(shapes)
    assert (TILE, SMALL_TILE, SMALL_LEVEL) == ((8, 8), (4, 4), 128)
    for l, (h, w) in enumerate(shapes):
        assert bins.tile[l] == ((4, 4) if h * w <= 128 else (8, 8))


def test_value_bins_packed_is_the_kernels_table():
    """csrc/msda_loc.cu:BinPlan: bins, rows, then tw, th, ntx, nty, first
    for MAX_LEVELS levels each."""
    bins = value_bins(FULL)
    table = bins.packed()
    assert table.dtype == np.int32 and table.shape == (2 + 5 * MAX_LEVELS,)
    assert tuple(table[:2]) == (bins.bins, bins.rows)
    per_level = table[2:].reshape(5, MAX_LEVELS)
    for l in range(4):
        assert tuple(per_level[:, l]) == (*bins.tile[l], *bins.grid[l], bins.first[l])
    assert (per_level[:, 4:] == 0).all()


def test_value_bins_refusals_and_cache():
    with pytest.raises(ValueError, match="levels"):
        value_bins(((2, 2),) * (MAX_LEVELS + 1))
    with pytest.raises(ValueError, match="levels"):
        value_bins(())
    as_lists = value_bins([[48, 160], [24, 80], [12, 40], [np.int64(6), 20]])
    assert as_lists is value_bins(FULL)


def test_value_bins_take_a_level_of_any_size():
    """A level of more tiles than the binning kernel sorts at a time (1,024)
    is tiled like any other."""
    assert value_bins(((257, 256),)).grid == ((32, 33),)
    big = value_bins(((4100, 2048), (6, 20)))
    assert big.grid == ((256, 513), (5, 2)) and big.first == (0, 256 * 513)
    assert big.bins == 256 * 513 + 10 and big.rows == 64


def brute_force_entries(bins, l, x, y):
    """{tile: {corner k: (weight, tile-local row)}} for the corners of the
    sample at (x, y) that lie in the level and carry weight: each corner's
    tile found by searching every tile's rectangle."""
    h, w = bins.spatial_shapes[l]
    tw = bins.tile[l][0]
    x, y = np.float32(x), np.float32(y)
    x0f, y0f = np.floor(x), np.floor(y)
    lx, ly = x - x0f, y - y0f
    out = {}
    for k in range(4):
        px, py = x0f + (k & 1), y0f + (k >> 1)
        if not (0 <= px < w and 0 <= py < h):
            continue
        weight = (lx if k & 1 else np.float32(1) - lx) * (ly if k >> 1 else np.float32(1) - ly)
        if weight == 0:
            continue
        px, py = int(px), int(py)
        hits = [t for t in range(bins.grid[l][0] * bins.grid[l][1])
                if tile_rect(bins, l, t)[0] <= px < tile_rect(bins, l, t)[1]
                and tile_rect(bins, l, t)[2] <= py < tile_rect(bins, l, t)[3]]
        assert len(hits) == 1
        x0, _, y0, _ = tile_rect(bins, l, hits[0])
        out.setdefault(hits[0], {})[k] = (weight, (py - y0) * tw + (px - x0))
    return out


def check_position(bins, l, x, y):
    tw = bins.tile[l][0]
    got = {}
    for t, r00, wk in bins.entries(l, x, y):
        assert t not in got  # one entry per tile
        got[t] = {k: (wk[k], r00 + (k & 1) + (k >> 1) * tw) for k in range(4) if wk[k] != 0}
        assert got[t]  # no entry without weight
    assert got == brute_force_entries(bins, l, x, y), (l, x, y)
    assert len(got) <= 4


@pytest.mark.parametrize("shapes", [FULL, SMALL, ODD, ((16, 8), (8, 17))])
def test_entries_match_brute_force(shapes):
    """Random positions in and around every level, positions on every tile
    edge (integer positions: two of the corners carry no weight), on the
    level's border and outside it."""
    bins = value_bins(shapes)
    rng = np.random.RandomState(0)
    for l, (h, w) in enumerate(shapes):
        tw, th = bins.tile[l]
        for x, y in zip(rng.uniform(-2.5, w + 1.5, 300), rng.uniform(-2.5, h + 1.5, 300)):
            check_position(bins, l, x, y)
        edges_x = sorted({float(v) for t in range(0, w + tw, tw) for v in (t - 1, t - 0.5, t)})
        edges_y = sorted({float(v) for t in range(0, h + th, th) for v in (t - 1, t - 0.25, t)})
        for x in edges_x:
            for y in edges_y:
                check_position(bins, l, x, y)
        for x, y in ((-1.0, -1.0), (-0.5, 0.5), (w - 1.0, h - 1.0), (w - 0.5, h - 0.5),
                     (float(w), 1.5), (1.5, float(h)), (-1.5, 2.0), (w + 3.0, h + 3.0)):
            check_position(bins, l, x, y)


@pytest.mark.parametrize("x,y", [(np.nan, 1.0), (1.0, np.nan), (3e9, 1.5), (-3e9, 1.5),
                                 (1.5, 1e12), (1.5, -1e12), (np.inf, 1.0), (-np.inf, -np.inf)])
def test_entries_of_positions_no_int32_holds_are_none(x, y):
    """floor(x, y) is clamped to [-2, w] x [-2, h] before it becomes an
    integer: NaN, infinite and far positions touch no tile."""
    bins = value_bins(FULL)
    for l in range(4):
        assert bins.entries(l, x, y) == []


def test_a_level_wider_than_a_tile_and_a_level_smaller_than_one():
    """wl > tile width: a sample on a tile's edge makes two (or four)
    entries whose weights sum to the sample's; a level smaller than one
    tile has a single tile that takes every corner."""
    bins = value_bins(FULL)
    assert bins.tile[0] == (8, 8) and bins.spatial_shapes[0][1] > 8
    entries = bins.entries(0, 7.25, 7.5)  # corners in 4 tiles
    assert sorted(t for t, _, _ in entries) == [0, 1, 20, 21]
    assert np.isclose(sum(float(sum(wk)) for _, _, wk in entries), 1.0)
    entries = bins.entries(0, 7.25, 3.5)  # corners in 2 tiles
    assert sorted(t for t, _, _ in entries) == [0, 1]
    tiny = value_bins(((1, 2),))
    assert tiny.grid == ((1, 1),)
    assert [t for t, _, _ in tiny.entries(0, 0.5, -0.5)] == [0]
