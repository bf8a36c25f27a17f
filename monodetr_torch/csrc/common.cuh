// Shared device helpers for the monodetr_torch kernels.
//
// Element types: every kernel is instantiated for float (dtype code 0) and
// __nv_bfloat16 (dtype code 1); arithmetic is always f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFullMask, x, s);
  return x;
}

// Whether every pointer is 16-byte aligned (for 16-byte loads and copies).
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15u) return false;
  return true;
}

// MSDA kernels 2, 5, 6 and 7 run one warp per (batch, query, head) in
// blocks of 8 warps: with H = 8 a block is the 8 heads of one query.
constexpr int kWarpsPerBlock = 8;

inline unsigned blocks_for_warps(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

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

// Weighted sum of L*P bilinear samples of one head, computed by one warp.
//
// Lane j < L*P holds sample j's attention weight `att` and pixel position
// (fx, fy) in the level-(j / P) grid (align_corners=False pixel centres);
// the other lanes' values are ignored.  Each sample is broadcast to the
// warp, and lane d reads channel d of the four corner tokens: one 32-channel
// coalesced load per corner.  Corners outside the level contribute zero
// (grid_sample padding_mode='zeros').  `v` points at channel 0 of this
// head in token 0 of this batch item; `row` is the stride between tokens.
// Returns lane d's f32 sum.
template <typename T>
__device__ __forceinline__ float sample_heads_sum(const T* __restrict__ v, int64_t row,
                                                  const Levels& lv, int P, float att,
                                                  float fx, float fy, int lane) {
  const int LP = lv.n * P;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < LP; ++j) {
    const float a = __shfl_sync(kFullMask, att, j);
    const float x = __shfl_sync(kFullMask, fx, j);
    const float y = __shfl_sync(kFullMask, fy, j);
    const int l = j / P;
    const int hl = lv.h[l], wl = lv.w[l];
    const T* base = v + (int64_t)lv.start[l] * row + lane;
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float lx = x - x0f, ly = y - y0f;
    const bool vx0 = x0 >= 0 && x0 < wl, vx1 = x0 + 1 >= 0 && x0 + 1 < wl;
    const bool vy0 = y0 >= 0 && y0 < hl, vy1 = y0 + 1 >= 0 && y0 + 1 < hl;
    float s = 0.f;
    if (vy0 && vx0) s += (1.f - lx) * (1.f - ly) * to_f32(base[((int64_t)y0 * wl + x0) * row]);
    if (vy0 && vx1) s += lx * (1.f - ly) * to_f32(base[((int64_t)y0 * wl + x0 + 1) * row]);
    if (vy1 && vx0) s += (1.f - lx) * ly * to_f32(base[((int64_t)(y0 + 1) * wl + x0) * row]);
    if (vy1 && vx1) s += lx * ly * to_f32(base[((int64_t)(y0 + 1) * wl + x0 + 1) * row]);
    acc += a * s;
  }
  return acc;
}

// Backward of sample_heads_sum, by the same warp layout.  `g` is lane d's
// channel of the output gradient.  For each sample j, adds
// att_j * (corner weight) * g_d to the f32 value gradient `gv` (laid out as
// `v`) by atomics, unless `gv` is null, and leaves in lane j:
//   gatt = sum_d g_d * sample_j[d],
//   gx, gy = att_j * sum_d g_d * d sample_j[d] / d(x, y).
// The derivative is the one-sided bilinear one at x0 = floor(x) (the
// convention of F.grid_sample's backward): at an integer position it is
// v[x0 + 1] - v[x0].  Corners outside the level count as zero.
template <typename T>
__device__ __forceinline__ void sample_heads_bwd(const T* __restrict__ v, float* gv, int64_t row,
                                                 const Levels& lv, int P, float att, float fx,
                                                 float fy, float g, int lane, float& gatt,
                                                 float& gx, float& gy) {
  const int LP = lv.n * P;
  gatt = gx = gy = 0.f;
  for (int j = 0; j < LP; ++j) {
    const float a = __shfl_sync(kFullMask, att, j);
    const float x = __shfl_sync(kFullMask, fx, j);
    const float y = __shfl_sync(kFullMask, fy, j);
    const int l = j / P;
    const int hl = lv.h[l], wl = lv.w[l];
    const int64_t off0 = (int64_t)lv.start[l] * row + lane;
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float lx = x - x0f, ly = y - y0f;
    const bool vx0 = x0 >= 0 && x0 < wl, vx1 = x0 + 1 >= 0 && x0 + 1 < wl;
    const bool vy0 = y0 >= 0 && y0 < hl, vy1 = y0 + 1 >= 0 && y0 + 1 < hl;
    const int64_t i00 = off0 + ((int64_t)y0 * wl + x0) * row;
    const int64_t i01 = i00 + row, i10 = i00 + (int64_t)wl * row, i11 = i10 + row;
    const float v00 = (vy0 && vx0) ? to_f32(v[i00]) : 0.f;
    const float v01 = (vy0 && vx1) ? to_f32(v[i01]) : 0.f;
    const float v10 = (vy1 && vx0) ? to_f32(v[i10]) : 0.f;
    const float v11 = (vy1 && vx1) ? to_f32(v[i11]) : 0.f;
    const float s = (1.f - lx) * (1.f - ly) * v00 + lx * (1.f - ly) * v01 +
                    (1.f - lx) * ly * v10 + lx * ly * v11;
    const float dx = (1.f - ly) * (v01 - v00) + ly * (v11 - v10);
    const float dy = (1.f - lx) * (v10 - v00) + lx * (v11 - v01);
    const float sa = warp_sum(g * s), sx = warp_sum(g * dx), sy = warp_sum(g * dy);
    if (lane == j) {
      gatt = sa;
      gx = a * sx;
      gy = a * sy;
    }
    const float ga = a * g;
    if (gv != nullptr && a != 0.f) {  // the same in every lane: the branch is uniform
      if (vy0 && vx0) atomicAdd(gv + i00, ga * (1.f - lx) * (1.f - ly));
      if (vy0 && vx1) atomicAdd(gv + i01, ga * lx * (1.f - ly));
      if (vy1 && vx0) atomicAdd(gv + i10, ga * (1.f - lx) * ly);
      if (vy1 && vx1) atomicAdd(gv + i11, ga * lx * ly);
    }
  }
}

}  // namespace mdt
