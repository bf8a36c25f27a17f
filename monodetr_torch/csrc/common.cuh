// Shared device helpers for the monodetr_torch kernels.
//
// Element types: every kernel is instantiated for float (dtype code 0) and
// __nv_bfloat16 (dtype code 1); arithmetic is always f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace mdt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxLevels = 8;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, s));
  return x;
}

// Whether every pointer is 16-byte aligned (for 16-byte loads and copies).
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15u) return false;
  return true;
}

// Kernels 1, 2, 5, 6 and 7 run a quad of 4 threads per (batch, query, head)
// with 16-byte corner loads (Row8, corners, quad_sample_sum below).

// Multi-scale value pyramid: level l holds h[l] x w[l] tokens starting at
// token start[l] of the flattened [S] axis.
struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

inline Levels make_levels(int L, const int* hw) {
  Levels lv{};
  lv.n = L;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = s;
    s += lv.h[l] * lv.w[l];
  }
  return lv;
}

// Grid query q of the level-major flattening sits at pixel (gx, gy) of
// level lq (the encoder's queries are the pixel grid of every level).
struct GridPos {
  int lq, gx, gy;
};

__device__ __forceinline__ GridPos grid_pos(int q, const Levels& lv) {
  int lq = 0;
  while (lq + 1 < lv.n && q >= lv.start[lq + 1]) ++lq;
  const int r = q - lv.start[lq];
  const int gy = r / lv.w[lq];
  return GridPos{lq, r - gy * lv.w[lq], gy};
}

// Where that query's centre falls in level l's pixel coordinates,
// (g + 0.5) * size_l / size_lq - 0.5, rounded once to f32 as the host's
// tables (ops/msda_enc.py:grid_centers) are.
__device__ __forceinline__ float2 grid_centre(const GridPos& g, const Levels& lv, int l) {
  return make_float2((float)(((double)g.gx + 0.5) * lv.w[l] / lv.w[g.lq] - 0.5),
                     (float)(((double)g.gy + 0.5) * lv.h[l] / lv.h[g.lq] - 0.5));
}

// ---- the quad core of kernels 1, 5 and 6 --------------------------------
//
// A quad of 4 threads works on one (batch, query, head); thread s owns
// channels 8s .. 8s + 7 of the head's 32, so one corner of one sample is one
// 16-byte load per thread (bf16; two in f32), where a warp per (b, q, h)
// issues 32 loads of 2 bytes.

// 8 channels of one token row, as loaded.
template <typename T>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
};

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// Elements 0 .. n - 1 of p (4 when `vec`: one 8- or 16-byte load), zeros after.
__device__ __forceinline__ void load4(const float* p, float (&x)[4], int n, bool vec) {
  if (vec && n == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = u < n ? p[u] : 0.f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4], int n, bool vec) {
  if (vec && n == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = u < n ? to_f32(p[u]) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&x)[4], int n) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < n) p[u] = from_f32<T>(x[u]);
}

// Kernel 1's per-head softmax over its L*P <= 16 logits, as a quad takes
// it: thread s holds logits 4s .. 4s + 3 (n of them; zeros past n), and the
// head's own maximum (ROADMAP.md C2) and the sum take 2 quad shuffles each.
// Returns the weights in x.
__device__ __forceinline__ void quad_softmax(float (&x)[4], int n, unsigned qmask) {
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < 4; ++u) m = u < n ? fmaxf(m, x[u]) : m;
  m = fmaxf(m, __shfl_xor_sync(qmask, m, 1));
  m = fmaxf(m, __shfl_xor_sync(qmask, m, 2));
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = u < n ? expf(x[u] - m) : 0.f;
    sum += x[u];
  }
  sum += __shfl_xor_sync(qmask, sum, 1);
  sum += __shfl_xor_sync(qmask, sum, 2);
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] /= sum;
}

// Whether every thread's 4 logits and offsets of kernel 1 are one aligned
// vector load (load4's `vec`).
inline bool enc_vec(int dtype, int LP, const void* off, const void* logits) {
  const uintptr_t bytes = 4u * (dtype == kBF16 ? 2u : 4u);
  return LP % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(off) | reinterpret_cast<uintptr_t>(logits)) % bytes) == 0;
}

// The four corners k = 0 (x0, y0), 1 (x0 + 1, y0), 2 (x0, y0 + 1), 3 of a
// sample at pixel (x, y) of a w-wide, h-high level: flat token index in the
// level, bilinear weight, and in bit k of `ok` whether the corner lies in
// the level (zero padding outside).  (x0, y0) is floor(x, y) clamped to
// [-2, w] x [-2, h]: the same `ok` bits and weights at every position, and
// integers that stay small however far outside the level the sample lies
// (a NaN position gives x0 = -2: no corner, NaN weights).
struct Corners {
  int x0, y0, w;
  float lx, ly;
  unsigned ok;
  __device__ __forceinline__ int index(int k) const {
    return y0 * w + x0 + (k & 1) + (k >> 1) * w;
  }
  __device__ __forceinline__ float weight(int k) const {
    return ((k & 1) ? lx : 1.f - lx) * ((k >> 1) ? ly : 1.f - ly);
  }
};

__device__ __forceinline__ Corners corners(float x, float y, int hl, int wl) {
  Corners c;
  const float x0f = floorf(x), y0f = floorf(y);
  c.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)wl);
  c.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)hl);
  c.lx = x - x0f;
  c.ly = y - y0f;
  c.w = wl;
  const bool vx0 = c.x0 >= 0 && c.x0 < wl, vx1 = c.x0 + 1 >= 0 && c.x0 + 1 < wl;
  const bool vy0 = c.y0 >= 0 && c.y0 < hl, vy1 = c.y0 + 1 >= 0 && c.y0 + 1 < hl;
  c.ok = (unsigned)(vy0 && vx0) | (unsigned)(vy0 && vx1) << 1 | (unsigned)(vy1 && vx0) << 2 |
         (unsigned)(vy1 && vx1) << 3;
  return c;
}

// The 8 channels at `p + index(k) * row` of each corner that lies in the
// level, zeros for the others: all four loads issued before any is used.
// The element offsets are 32-bit (the callers' hosts check that a batch
// item's tokens fit), one multiply per sample: the other corners are `row`
// and `w * row` elements further, immediates where `row` is a constant.
template <typename T>
__device__ __forceinline__ void load_corners(const T* p, int row, const Corners& c,
                                             Row8<T> (&v)[4]) {
  const T* p0 = p + (c.y0 * c.w + c.x0) * row;
  const T* p1 = p0 + c.w * row;
  const T* at[4] = {p0, p0 + row, p1, p1 + row};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((c.ok >> k) & 1u)
      v[k].load(at[k]);
    else
      v[k].zero();
  }
}

// Whether the elements of one batch item's [S, H, 32] tokens can be
// indexed with 32 bits, as load_corners does: its offsets, formed before
// the `ok` bits are tested, reach from -2 rows and 2 tokens before a level
// to one row and one token past it.
inline bool fits_int32(int S, int H) { return (int64_t)S * H * 64 <= INT32_MAX; }

// The forward of one (b, q, h): thread s of the quad holds the weight and
// pixel position of samples j0 + 4s .. j0 + 4s + 3 (sample j = l * P + p; a
// call takes at most 16, kernels 2 and 7 call again with j0 = 16);
// the quad shares them by __shfl_sync, one at a time, and each thread adds
// its 8 channels of the four corners into acc.  `vb` points at this
// thread's 8 channels of the head in token 0 of the batch item.  A thread
// loads a sample's 4 corners before it uses any of them.  More samples in
// flight cost registers and so resident warps: at B = 16 kernel 1's bf16
// forward took 1.66 ms with 4 samples in flight (168 registers, 8 warps per
// SM), 1.06 ms with 2 (106, 16 warps) and 0.90 ms with 1 (72, 24 warps) on
// an H100 SXM at 700 W.
template <typename T>
__device__ __forceinline__ void quad_sample_sum(const T* __restrict__ vb, int row,
                                                const Levels& lv, int P, const float (&att)[4],
                                                const float (&fx)[4], const float (&fy)[4],
                                                int lane, unsigned qmask, float (&acc)[8],
                                                int j0 = 0) {
  const int LP = lv.n * P;
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // sample j0 + j is held by thread j / 4 of the quad
    if (j0 + j >= LP) break;
    const int src = (lane & ~3) | (j >> 2);
    const float a = __shfl_sync(qmask, att[j & 3], src);
    const float x = __shfl_sync(qmask, fx[j & 3], src);
    const float y = __shfl_sync(qmask, fy[j & 3], src);
    const int l = (j0 + j) / P;
    const Corners c = corners(x, y, lv.h[l], lv.w[l]);
    Row8<T> v[4];
    load_corners(vb + lv.start[l] * row, row, c, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float xv[8];
      v[k].get(xv);
      const float w = a * c.weight(k);
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] = fmaf(w, xv[d], acc[d]);
    }
  }
}

// The backward's dots of one sample: with g the output gradient, pa = <g,
// sample>, px = <g, d sample / dx>, py = <g, d sample / dy>.  All three are
// linear in the four dots of g with the corner rows, so a thread takes
// those over its 8 channels (4 multiply-adds a channel), the quad sums them
// by 2 shuffles each, and the rest is scalar.  The position derivative is
// the one-sided bilinear one at x0 = floor(x) (the convention of
// F.grid_sample's backward): at an integer position it is v[x0 + 1] -
// v[x0].  Corners outside the level count as zero.
template <typename T>
__device__ __forceinline__ void quad_sample_dots(const Row8<T> (&v)[4], const float (&g)[8],
                                                 float lx, float ly, unsigned qmask, float& pa,
                                                 float& px, float& py) {
  float dot[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x[8];
    v[k].get(x);
    dot[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) dot[k] = fmaf(g[d], x[d], dot[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dot[k] += __shfl_xor_sync(qmask, dot[k], 1);
    dot[k] += __shfl_xor_sync(qmask, dot[k], 2);
  }
  const float top = dot[0] + lx * (dot[1] - dot[0]), bottom = dot[2] + lx * (dot[3] - dot[2]);
  pa = top + ly * (bottom - top);
  py = bottom - top;
  px = (dot[1] - dot[0]) + ly * ((dot[3] - dot[2]) - (dot[1] - dot[0]));
}

// ---- the staged value gradient of a windowed backward ---------------------
//
// Grid queries sample every level within +-lim px of a static centre, so
// the queries of one region of the image touch few value rows: the 8 x 8
// pixels of the finest of the levels (48, 160) .. (6, 20), with the 4 x 4,
// 2 x 2 and 1 pixels of the coarser levels over them (85 queries), reach
// 350 rows per head at lim = 1.99 with 5440 corner adds.  A block therefore
// sums its tile's value gradient in shared memory and adds each row to
// device memory once.
//
// The tiling comes from the host (ops/msda_windowed.py:window_tiles, which
// a CPU test holds to brute force), and the kernels compute none of it: the
// image is cut into nx x ny tiles; a tile takes the queries of every level
// whose centres lie in it, at most qw x qh of level lq, which fill the
// tile's `queries` slots from slot first[lq] on.  Per sampled level l a tile
// stages a rectangle of rw x rh rows at row `off` of a head's window of
// `rows` rows.  Which queries a tile holds and where its rectangles start
// is the per-tile table in device memory (WinTiles).  A block is
// kWinBlockHeads heads of one tile; warp (head, l) owns the rectangle of
// level l in that head's window and works only on that level's samples, so
// no two warps ever touch one row, and the sums need no atomics in shared
// memory (win_add).
constexpr int kWinLevels = 4;      // ops/msda_windowed.py:MAX_LEVELS
constexpr int kWinBlockHeads = 2;  // ops/msda_windowed.py:WIN_HEADS

struct WinPlan {
  int nx, ny, rows, queries;
  int qw[kWinLevels], qh[kWinLevels], first[kWinLevels];
  int rw[kWinLevels], rh[kWinLevels], off[kWinLevels];
};

// From the host's int table, in the struct's order (WindowTiles.packed).
inline WinPlan make_win_plan(const int* table) {
  WinPlan plan;
  memcpy(&plan, table, sizeof(WinPlan));
  return plan;
}

// The per-tile table (WindowTiles.tile_table), int [nx + ny, 3, L] in
// device memory: for column tx of tiles, row tx holds per level the first
// query's x, the number of queries across, and the staged rectangle's
// first x; row nx + ty the same along y for band ty of tiles.
struct WinTiles {
  const int* table;
  __device__ __forceinline__ int at(int tile_row, int what, int l, int L) const {
    return __ldg(table + (tile_row * 3 + what) * L + l);
  }
};

// Rows of shared memory a warp has to itself beside its rectangle: one
// spare row, 8 for the output gradients of its 8 queries, and one for the
// tile's query ranges (WinRange).
constexpr int kWinWarpRows = 10;

// Shared memory a block of the plan asks for: the heads' windows and each
// warp's own rows, 32 f32 channels a row.
inline size_t win_smem_bytes(const WinPlan& plan, int L) {
  return ((size_t)kWinBlockHeads * plan.rows + (size_t)kWinBlockHeads * L * kWinWarpRows) * 32 *
         sizeof(float);
}

// Whether the table is one the kernels can index safely for L levels and H
// heads: every rectangle inside the window.
inline bool win_plan_ok(const WinPlan& plan, int L, int H) {
  if (L > kWinLevels || plan.nx < 1 || plan.ny < 1 || H % kWinBlockHeads || plan.rows < 0 ||
      plan.queries < 1)
    return false;
  for (int l = 0; l < L; ++l) {
    const int rw = plan.rw[l], rh = plan.rh[l], off = plan.off[l];
    if (plan.qw[l] < 1 || plan.qh[l] < 1 || plan.first[l] < 0 ||
        plan.first[l] + plan.qw[l] * plan.qh[l] > plan.queries || rw < 0 || rh < 0 || off < 0 ||
        (int64_t)off + (int64_t)rw * rh > plan.rows)
      return false;
  }
  return true;
}

// The queries of one level in the warp's tile, n_x x n_y from pixel
// (gx0, gy0), and the level's pixel size in units of the sampled level's,
// (sx, sy) = (w_l / w_lq, h_l / h_lq); 8 words of the warp's range row.
struct WinRange {
  int gx0, gy0, n_x, n_y;
  float sx, sy;
  int pad[2];
};

// What one warp of a backward block works on: batch item b, head h, the
// samples in level l of its tile's queries; the rectangle of level l it
// stages, rw x rh rows from pixel (rx0, ry0), at float `win` of the block's
// shared memory; its spare row at float `spare`, its 8 gradient rows and
// its range row after it.
struct WinWarp {
  int b, h, l, rx0, ry0, rw, rh, win, spare;
};

// blockIdx.x = (tile * B + b) * (H / kWinBlockHeads) + head group.  Lane
// j < L copies level j's queries in the tile from the per-tile table to
// the warp's range row.
__device__ __forceinline__ WinWarp win_warp(float* smem, const Levels& lv, const WinPlan& plan,
                                            const WinTiles& tiles, int B, int H) {
  WinWarp t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = warp / lv.n;
  t.l = warp - hl * lv.n;
  const int groups = H / kWinBlockHeads;
  int bid = blockIdx.x;
  t.h = (bid % groups) * kWinBlockHeads + hl;
  bid /= groups;
  t.b = bid % B;
  const int tile = bid / B;
  const int ty = tile / plan.nx, tx = tile - ty * plan.nx;
  t.rw = plan.rw[t.l];
  t.rh = plan.rh[t.l];
  t.win = (hl * plan.rows + plan.off[t.l]) * 32;
  t.spare = (kWinBlockHeads * plan.rows + warp * kWinWarpRows) * 32;
  t.rx0 = tiles.at(tx, 2, t.l, lv.n);
  t.ry0 = tiles.at(plan.nx + ty, 2, t.l, lv.n);
  if (lane < lv.n) {
    WinRange r;
    r.gx0 = tiles.at(tx, 0, lane, lv.n);
    r.n_x = tiles.at(tx, 1, lane, lv.n);
    r.gy0 = tiles.at(plan.nx + ty, 0, lane, lv.n);
    r.n_y = tiles.at(plan.nx + ty, 1, lane, lv.n);
    r.sx = (float)lv.w[t.l] / (float)lv.w[lane];
    r.sy = (float)lv.h[t.l] / (float)lv.h[lane];
    r.pad[0] = r.pad[1] = 0;
    reinterpret_cast<WinRange*>(smem + t.spare + 9 * 32)[lane] = r;
  }
  return t;
}

// The query of slot i of the tile: its level and pixel, and whether the
// slot holds a query at all (the tile's ranges can be smaller than the
// slots, at the border and where a coarse pixel is wider than the tile).
__device__ __forceinline__ bool win_query(const float* smem, const WinWarp& t, const Levels& lv,
                                          const WinPlan& plan, int i, GridPos& gp, float& sx,
                                          float& sy) {
  int lq = 0;
  while (lq + 1 < lv.n && i >= plan.first[lq + 1]) ++lq;
  const int j = i - plan.first[lq];
  const int qy = j / plan.qw[lq], qx = j - qy * plan.qw[lq];
  const WinRange r = reinterpret_cast<const WinRange*>(smem + t.spare + 9 * 32)[lq];
  gp = GridPos{lq, r.gx0 + qx, r.gy0 + qy};
  sx = r.sx;
  sy = r.sy;
  return i < plan.queries && qx < r.n_x && qy < r.n_y;
}

__device__ __forceinline__ void win_zero(float* smem, const WinWarp& t, int lane) {
  float4* w = reinterpret_cast<float4*>(smem + t.win);
  for (int i = lane; i < t.rw * t.rh * 8; i += 32) w[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  smem[t.spare + lane] = 0.f;
  __syncwarp();
}

// Shared-memory access by byte address, in program order (win_add's steps
// read what earlier steps wrote).
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// Keeps the 8 channels `g` of this thread's output gradient where win_add
// reads them: channel j of lane n at float j * 32 + n of the warp's gradient
// rows (a lane reads only what it wrote: no bank conflicts, no barrier).
__device__ __forceinline__ void win_keep_gradient(float* smem, const WinWarp& t,
                                                  const float (&g)[8], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) smem[t.spare + (1 + j) * 32 + lane] = g[j];
}

// Adds one sample's value gradient, a * (corner weight) * g, for the 8
// quads of the warp at once.  Thread s of quad i owns channels 8s .. 8s + 7
// of its corners' rows and walks them in 8 steps, channel 8s + ((d + i) & 7)
// in step d, whose output gradient it reads back from the warp's gradient
// rows (a register array indexed by the quad would live in local memory):
// in one step the 32 threads touch 32 different channels, so two quads that
// add to one row never meet in a step (no atomics) and every access is free
// of bank conflicts; __syncwarp orders the steps.  A corner outside the
// level, or of a sample with `on` false (no query, or a == 0), adds to the
// spare row.  A corner inside the level but outside the staged rectangle (a
// position beyond the window, or a level that is not staged) goes to device
// memory by 2 vector atomics: thread s adds channels 4s .. 4s + 3 and
// 16 + 4s .. 16 + 4s + 3 of the output gradient row `gq`, so each atomic
// instruction of the quad covers 64 contiguous bytes; `gv` points at
// channel 0 of this head in the level's token 0.
template <typename T>
__device__ __forceinline__ void win_add(float* smem, const WinWarp& t, const Corners& c, float a,
                                        bool on, const T* gq, float* gv, int row, int lane) {
  const int quad = lane >> 2, sub = lane & 3;
  unsigned r[4];  // shared-memory byte address of this thread's 8 channels of corner k's row
  float wk[4];
  unsigned far = 0u;
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  const int dx = c.x0 - t.rx0, dy = c.y0 - t.ry0;
  const bool inx[2] = {(unsigned)dx < (unsigned)t.rw, (unsigned)(dx + 1) < (unsigned)t.rw};
  const bool iny[2] = {(unsigned)dy < (unsigned)t.rh, (unsigned)(dy + 1) < (unsigned)t.rh};
  const unsigned r00 = base + 4u * (unsigned)(t.win + (dy * t.rw + dx) * 32 + 8 * sub);
  const unsigned none = base + 4u * (unsigned)(t.spare + 8 * sub);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool valid = on && ((c.ok >> k) & 1u);
    const bool in = valid && inx[k & 1] && iny[k >> 1];
    r[k] = in ? r00 + 128u * (unsigned)((k & 1) + (k >> 1) * t.rw) : none;
    wk[k] = valid ? a * c.weight(k) : 0.f;
    far |= (unsigned)(valid && !in) << k;
  }
  const unsigned grad = base + 4u * (unsigned)(t.spare + 32 + lane);
  unsigned ch = 4u * (unsigned)quad;  // byte offset of the step's channel among the thread's 8
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float gd = lds(grad + ch * 32u);
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = lds(r[k] + ch);
#pragma unroll
    for (int k = 0; k < 4; ++k) sts(r[k] + ch, fmaf(wk[k], gd, s[k]));
    __syncwarp();
    ch = (ch + 4u) & 28u;
  }
  if (far) {  // the same in the whole quad
    float lo[4], hi[4];
    load4(gq + sub * 4, lo, 4, true);
    load4(gq + 16 + sub * 4, hi, 4, true);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!((far >> k) & 1u)) continue;
      float* p = gv + c.index(k) * row + sub * 4;
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(wk[k] * lo[0], wk[k] * lo[1], wk[k] * lo[2], wk[k] * lo[3]));
      atomicAdd(reinterpret_cast<float4*>(p + 16),
                make_float4(wk[k] * hi[0], wk[k] * hi[1], wk[k] * hi[2], wk[k] * hi[3]));
    }
  }
}

// Adds the warp's staged rows to the f32 gradient in device memory, each
// row once, as 8 vector atomics (neighbouring tiles' rectangles overlap);
// rows that stayed zero are skipped.  `gl` points at channel 0 of this head
// in token 0 of level t.l of the batch item.
__device__ __forceinline__ void win_flush(const float* smem, const WinWarp& t, const Levels& lv,
                                          float* gl, int row, int lane) {
  __syncwarp();
  const int hl = lv.h[t.l], wl = lv.w[t.l];
  const int part = lane & 7;
  for (int r = lane >> 3; r < t.rw * t.rh; r += 4) {
    const int dy = r / t.rw;
    const int x = t.rx0 + r - dy * t.rw, y = t.ry0 + dy;
    if (x >= wl || y >= hl) continue;
    const float4 v = reinterpret_cast<const float4*>(smem + t.win + r * 32)[part];
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(gl + (y * wl + x) * row) + part, v);
  }
}

}  // namespace mdt
