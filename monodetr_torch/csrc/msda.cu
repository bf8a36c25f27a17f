// Multi-scale deformable attention kernels for Hopper (sm_90a), forward
// and backward.
//
// Kernel 1, encoder (replaces monodetr_tpu/ops/msda_enc_pallas.py:
// ms_deform_attn_enc_fused, forward _fwd_kernel).  Grid queries: query q of
// level lq sits at pixel (gx, gy); in every sampled level l it samples
// around the static centre ((g + 0.5) * size_l / size_lq - 0.5), at
// clip(offset, -lim, lim) pixels.  The prologue (per-head softmax over the
// L*P logits, the clamp, the centres) runs in the kernel on the raw
// projection outputs, so no [B, S, H, L, P] weight or location tensor is
// ever written to device memory.
//
// Kernel 2, decoder (replaces monodetr_tpu/ops/msda_sep_pallas.py:
// ms_deform_attn_sep, forward _fwd_kernel).  Exact MSDA from normalised
// sampling locations: pixel position loc * (w, h) - 0.5, given weights.
//
// Kernel 7, decoder (replaces monodetr_tpu/ops/msda_dense_pallas.py:
// ms_deform_attn_dense_fused).  Kernel 2's function; its backward
// scatters nothing, as the TPU kernel's does not (see
// msda_dense_fused_bwd_value_kernel below).
//
// All share one sampling core (common.cuh:sample_heads_sum): one warp per
// (batch, query, head), lane = channel (D = 32), each bilinear corner one
// coalesced 32-channel load, f32 accumulation.  The backward kernels use
// the same layout (common.cuh:sample_heads_bwd): three warp sums per sample
// give the weight and position gradients, and (kernel 7 apart) the value
// gradient goes to an f32 buffer by one atomicAdd per valid corner and
// channel.  At B=16
// the encoder backward issues 16 * 10200 * 8 * 16 * 4 corner rows of 32
// atomics per layer; they hit L2 in the same neighbourhoods as the forward's
// loads.  A gather over the window's inverse map would need no atomics.
//
// What bounds them on the H100: gathers.  Each warp issues 4 * L * P = 64
// corner loads of 64 B (bf16) or 128 B (f32); at B=16, S=10200 the encoder
// kernel touches ~5 GB of corner rows per layer against ~0.3 GB of unique
// input and output.  Neighbouring queries sample neighbouring pixels, and
// the 8 warps of a block are the 8 heads of one query (together one 512 B
// token row per corner), so the rows are served mostly from L1/L2; the
// kernel is bound by L1/L2 load throughput, not by HBM or arithmetic.  The
// TPU kernels' strip DMAs and hat-function matmuls existed because TPU
// gathers are slow; on Hopper the plain gather is the fast path.
#include "common.cuh"

namespace mdt {

// Where one warp of kernel 1 samples: the query's level and pixel, and in
// lane j < L*P sample j's softmaxed weight, raw offsets and clamped pixel
// position.  The softmax uses the head's own maximum.
struct EncSample {
  float att, ox, oy, fx, fy;
};

template <typename T>
__device__ __forceinline__ EncSample enc_prologue(const T* __restrict__ off,
                                                  const T* __restrict__ logits, int64_t bq,
                                                  int q, int H, int h, const Levels& lv, int P,
                                                  float lim, int lane) {
  const int LP = lv.n * P;
  const GridPos gp = grid_pos(q, lv);

  // lane j < L*P owns sample j = (level j / P, point j % P)
  const bool mine = lane < LP;
  const int64_t nlog = (int64_t)H * LP;
  float logit = -INFINITY;
  EncSample e{0.f, 0.f, 0.f, 0.f, 0.f};
  if (mine) {
    logit = to_f32(logits[bq * nlog + h * LP + lane]);
    e.ox = to_f32(off[bq * 2 * nlog + h * LP + lane]);
    e.oy = to_f32(off[bq * 2 * nlog + nlog + h * LP + lane]);
  }
  const float m = warp_max(logit);  // this head's own maximum
  const float ex = mine ? expf(logit - m) : 0.f;
  e.att = ex / warp_sum(ex);
  if (mine) {
    const float2 c = grid_centre(gp, lv, lane / P);
    e.fx = c.x + fminf(fmaxf(e.ox, -lim), lim);
    e.fy = c.y + fminf(fmaxf(e.oy, -lim), lim);
  }
  return e;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_enc_fused_kernel(const T* __restrict__ value, const T* __restrict__ off,
                      const T* __restrict__ logits, T* __restrict__ out, int B, int S,
                      int H, Levels lv, int P, float lim) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;  // whole warps exit together
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;  // b * S + q
  const int q = (int)(bq % S);
  const int b = (int)(bq / S);
  const EncSample e = enc_prologue(off, logits, bq, q, H, h, lv, P, lim, lane);

  const int64_t row = (int64_t)H * 32;
  const T* v = value + (int64_t)b * S * row + h * 32;
  const float acc = sample_heads_sum(v, row, lv, P, e.att, e.fx, e.fy, lane);
  out[bq * row + h * 32 + lane] = from_f32<T>(acc);
}

// Kernel 1 backward (replaces msda_enc_pallas.py _bwd_kernel).  Same warp
// layout; the prologue is recomputed.  dvalue is accumulated by f32 atomics
// into gvalue (zeroed by the caller); doff is the sampling derivative where
// |off| < lim (the Pallas kernel's strict clamp mask, :471) and 0 where the
// offset was clamped; dlogits goes through the head's softmax:
// att * (gatt - sum(att * gatt)).
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_enc_fused_bwd_kernel(const T* __restrict__ value, const T* __restrict__ off,
                          const T* __restrict__ logits, const T* __restrict__ gout,
                          float* __restrict__ gvalue, T* __restrict__ goff,
                          T* __restrict__ glogits, int B, int S, int H, Levels lv, int P,
                          float lim) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;
  const int q = (int)(bq % S);
  const int b = (int)(bq / S);
  const int LP = lv.n * P;
  const EncSample e = enc_prologue(off, logits, bq, q, H, h, lv, P, lim, lane);

  const int64_t row = (int64_t)H * 32;
  const int64_t base = (int64_t)b * S * row + h * 32;
  const float g = to_f32(gout[bq * row + h * 32 + lane]);
  float gatt, gx, gy;
  sample_heads_bwd(value + base, gvalue + base, row, lv, P, e.att, e.fx, e.fy, g, lane, gatt,
                   gx, gy);
  const float s = warp_sum(e.att * gatt);  // lanes >= L*P hold att = 0
  if (lane < LP) {
    const int64_t nlog = (int64_t)H * LP;
    glogits[bq * nlog + h * LP + lane] = from_f32<T>(e.att * (gatt - s));
    goff[bq * 2 * nlog + h * LP + lane] = from_f32<T>(fabsf(e.ox) < lim ? gx : 0.f);
    goff[bq * 2 * nlog + nlog + h * LP + lane] = from_f32<T>(fabsf(e.oy) < lim ? gy : 0.f);
  }
}

// What lane j < L*P of the warp for (b, q, h) samples in kernels 2 and 7:
// sample j's weight and its pixel position loc * (w, h) - 0.5, read from
// loc [B, Q, H, L, P, 2] and attn [B, Q, H, L, P] (f32).  Other lanes get 0.
struct LocSample {
  float att, fx, fy;
};

__device__ __forceinline__ LocSample loc_sample(const float* __restrict__ loc,
                                                const float* __restrict__ attn, int64_t warp,
                                                const Levels& lv, int P, int lane) {
  LocSample s{0.f, 0.f, 0.f};
  if (lane < lv.n * P) {
    const int l = lane / P;
    const int64_t i = warp * lv.n * P + lane;  // [B, Q, H, L, P] index
    s.att = attn[i];
    s.fx = loc[2 * i] * lv.w[l] - 0.5f;
    s.fy = loc[2 * i + 1] * lv.h[l] - 0.5f;
  }
  return s;
}

// The forward of kernels 2 and 7, one warp per (b, q, h).
template <typename T>
__device__ __forceinline__ void loc_forward(const T* __restrict__ value,
                                            const float* __restrict__ loc,
                                            const float* __restrict__ attn, T* __restrict__ out,
                                            int B, int S, int Q, int H, const Levels& lv, int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;  // b * Q + q
  const int b = (int)(bq / Q);

  const LocSample s = loc_sample(loc, attn, warp, lv, P, lane);
  const int64_t row = (int64_t)H * 32;
  const T* v = value + (int64_t)b * S * row + h * 32;
  const float acc = sample_heads_sum(v, row, lv, P, s.att, s.fx, s.fy, lane);
  out[bq * row + h * 32 + lane] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_sep_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q,
                int H, Levels lv, int P) {
  loc_forward(value, loc, attn, out, B, S, Q, H, lv, P);
}

// Kernel 2 backward (replaces msda_sep_pallas.py _bwd_kernel): dvalue by
// f32 atomics into gvalue (zeroed by the caller), dattn = sum_d g_d *
// sample, dloc = att * d sample / d(x, y) * (w, h).  With gvalue null it
// writes dloc and dattn only: kernel 7's query-side backward.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_sep_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, const T* __restrict__ gout,
                    float* __restrict__ gvalue, float* __restrict__ gloc,
                    float* __restrict__ gattn, int B, int S, int Q, int H, Levels lv, int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;
  const int b = (int)(bq / Q);
  const int LP = lv.n * P;

  const LocSample s = loc_sample(loc, attn, warp, lv, P, lane);
  const int64_t row = (int64_t)H * 32;
  const int64_t base = (int64_t)b * S * row + h * 32;
  const float g = to_f32(gout[bq * row + h * 32 + lane]);
  float gatt, gx, gy;
  sample_heads_bwd(value + base, gvalue == nullptr ? nullptr : gvalue + base, row, lv, P,
                   s.att, s.fx, s.fy, g, lane, gatt, gx, gy);
  if (lane < LP) {
    const int l = lane / P;
    const int64_t i = warp * LP + lane;
    gattn[i] = gatt;
    gloc[2 * i] = gx * lv.w[l];
    gloc[2 * i + 1] = gy * lv.h[l];
  }
}

// Kernel 7, decoder (replaces monodetr_tpu/ops/msda_dense_pallas.py:
// ms_deform_attn_dense_fused).  The same exact function as kernel 2, so
// the same forward, under its own name for the profiler.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_dense_fused_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                        const float* __restrict__ attn, T* __restrict__ out, int B, int S,
                        int Q, int H, Levels lv, int P) {
  loc_forward(value, loc, attn, out, B, S, Q, H, lv, P);
}

// Kernel 7 backward, value side.  What sets the TPU kernel apart is that
// its backward scatters nothing: dvalue comes per value tile as W^T g.
// Here one CTA owns one band of kBandRows value rows of one level for one
// (b, h), and writes each of those dvalue rows once, with no atomics:
//   1. the level's Q*P samples for (b, h) are staged in shared memory,
//      kChunk at a time, as four corner weights (attention weight folded
//      in, 0 for a corner outside the level) and the flat index of corner
//      (x0, y0);
//   2. warp w owns rows [r0 + 16w, r0 + 16w + 16) of the band; it tests 32
//      samples at a time (one per lane), and for each sample with a corner
//      in its rows, in sample order, lane d adds weight * g[q, d] to the
//      row's shared-memory sum (only lane d of warp w touches it);
//   3. the warp writes its rows.
// The order of every sum is fixed, so dvalue is the same bits from run to
// run, as the TPU kernel's is.  At B=16, Q=550 a band re-reads 2,200
// samples: 80 bands x 128 (b, h) x 2,200 ~ 22M sample tests per layer.
// What bounds it is the staging: each sample is 12 bytes read at a
// 512-byte stride, from L2 (0.77 ms a launch on the H100, against 0.35 ms
// for kernel 2's whole atomic backward).
constexpr int kBandRows = 128;
constexpr int kRowsPerWarp = kBandRows / kWarpsPerBlock;
constexpr int kChunk = 1024;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_dense_fused_bwd_value_kernel(const float* __restrict__ loc, const float* __restrict__ attn,
                                  const T* __restrict__ gout, T* __restrict__ gvalue, int S,
                                  int Q, int H, Levels lv, int P) {
  __shared__ float4 s_w[kChunk];  // corner weights 00, 01, 10, 11
  __shared__ int s_i00[kChunk];   // flat index of corner (x0, y0) in the level
  __shared__ float s_acc[kBandRows * 32];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  int l = 0, band = blockIdx.x;
  while (l + 1 < lv.n && band >= (lv.h[l] * lv.w[l] + kBandRows - 1) / kBandRows) {
    band -= (lv.h[l] * lv.w[l] + kBandRows - 1) / kBandRows;
    ++l;
  }
  const int hl = lv.h[l], wl = lv.w[l];
  const int r0 = band * kBandRows;
  const int warp_id = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = r0 + warp_id * kRowsPerWarp;
  const int hi = min(lo + kRowsPerWarp, hl * wl);
  for (int r = lo; r < hi; ++r) s_acc[(r - r0) * 32 + lane] = 0.f;

  const int LP = lv.n * P;
  const int NS = Q * P;  // this level's samples for (b, h), in (q, p) order
  auto in_rows = [&](float w, int i) { return w != 0.f && i >= lo && i < hi; };
  for (int c0 = 0; c0 < NS; c0 += kChunk) {
    const int n = min(kChunk, NS - c0);
    __syncthreads();  // the previous chunk has been read
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const int q = (c0 + s) / P, p = (c0 + s) - q * P;
      const int64_t i = (((int64_t)b * Q + q) * H + h) * LP + l * P + p;
      const float a = attn[i];
      const float x = loc[2 * i] * wl - 0.5f, y = loc[2 * i + 1] * hl - 0.5f;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      int i00 = -(1 << 30);
      // positions past the first corner ring touch no row (this also
      // keeps the int conversion below in range, and drops NaN)
      if (x > -1.f && x < (float)wl && y > -1.f && y < (float)hl) {
        const float x0f = floorf(x), y0f = floorf(y);
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float lx = x - x0f, ly = y - y0f;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 < wl, vy0 = y0 >= 0, vy1 = y0 + 1 < hl;
        w.x = (vy0 && vx0) ? a * (1.f - lx) * (1.f - ly) : 0.f;
        w.y = (vy0 && vx1) ? a * lx * (1.f - ly) : 0.f;
        w.z = (vy1 && vx0) ? a * (1.f - lx) * ly : 0.f;
        w.w = (vy1 && vx1) ? a * lx * ly : 0.f;
        i00 = y0 * wl + x0;
      }
      s_w[s] = w;
      s_i00[s] = i00;
    }
    __syncthreads();
    for (int s0 = 0; s0 < n; s0 += 32) {
      bool hit = false;
      if (s0 + lane < n) {
        const float4 w = s_w[s0 + lane];
        const int i = s_i00[s0 + lane];
        hit = in_rows(w.x, i) || in_rows(w.y, i + 1) || in_rows(w.z, i + wl) ||
              in_rows(w.w, i + wl + 1);
      }
      unsigned m = __ballot_sync(kFullMask, hit);
      while (m) {  // uniform: every lane walks the same samples in order
        const int s = s0 + __ffs(m) - 1;
        m &= m - 1;
        const float4 w = s_w[s];
        const int i = s_i00[s];
        const int q = (c0 + s) / P;
        const float g = to_f32(gout[(((int64_t)b * Q + q) * H + h) * 32 + lane]);
        if (in_rows(w.x, i)) s_acc[(i - r0) * 32 + lane] += w.x * g;
        if (in_rows(w.y, i + 1)) s_acc[(i + 1 - r0) * 32 + lane] += w.y * g;
        if (in_rows(w.z, i + wl)) s_acc[(i + wl - r0) * 32 + lane] += w.z * g;
        if (in_rows(w.w, i + wl + 1)) s_acc[(i + wl + 1 - r0) * 32 + lane] += w.w * g;
      }
    }
  }
  const int64_t row = (int64_t)H * 32;
  T* gv = gvalue + ((int64_t)b * S + lv.start[l]) * row + h * 32 + lane;
  for (int r = lo; r < hi; ++r) gv[r * row] = from_f32<T>(s_acc[(r - r0) * 32 + lane]);
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// value [B, S, H, 32], off [B, S, 2*H*L*P] ([x-block | y-block]),
// logits [B, S, H*L*P], out [B, S, H*32]; all of one dtype.  hw: host int
// array (h0, w0, h1, w1, ...) of the L levels.
int mdt_msda_enc_fused(void* value, void* off, void* logits, void* out, int dtype, int B,
                       int S, int H, int D, int L, int P, void* hw, float lim,
                       void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    msda_enc_fused_kernel<__nv_bfloat16><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const __nv_bfloat16*>(off),
        static_cast<const __nv_bfloat16*>(logits), static_cast<__nv_bfloat16*>(out), B, S,
        H, lv, P, lim);
  } else if (dtype == kF32) {
    msda_enc_fused_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(off),
        static_cast<const float*>(logits), static_cast<float*>(out), B, S, H, lv, P, lim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// value [B, S, H, 32] (dtype), loc [B, Q, H, L, P, 2] f32, attn
// [B, Q, H, L, P] f32, out [B, Q, H*32] (dtype).
int mdt_msda_sep(void* value, void* loc, void* attn, void* out, int dtype, int B, int S,
                 int Q, int H, int D, int L, int P, void* hw, void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * Q * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    msda_sep_kernel<__nv_bfloat16><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<__nv_bfloat16*>(out), B, S, Q, H, lv,
        P);
  } else if (dtype == kF32) {
    msda_sep_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), B, S, Q, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 1 backward.  value, off, logits as mdt_msda_enc_fused; gout
// [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller;
// goff, glogits shaped as off and logits (dtype).
int mdt_msda_enc_fused_bwd(void* value, void* off, void* logits, void* gout, void* gvalue,
                           void* goff, void* glogits, int dtype, int B, int S, int H, int D,
                           int L, int P, void* hw, float lim, void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_enc_fused_bwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), static_cast<const T*>(off),
        static_cast<const T*>(logits), static_cast<const T*>(gout),
        static_cast<float*>(gvalue), static_cast<T*>(goff), static_cast<T*>(glogits), B, S,
        H, lv, P, lim);
  } else if (dtype == kF32) {
    msda_enc_fused_bwd_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(off),
        static_cast<const float*>(logits), static_cast<const float*>(gout),
        static_cast<float*>(gvalue), static_cast<float*>(goff), static_cast<float*>(glogits),
        B, S, H, lv, P, lim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 2 backward.  value, loc, attn as mdt_msda_sep; gout [B, Q, H*32]
// (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller; gloc, gattn
// shaped as loc and attn (f32).
int mdt_msda_sep_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue, void* gloc,
                     void* gattn, int dtype, int B, int S, int Q, int H, int D, int L, int P,
                     void* hw, void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * Q * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_sep_bwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const T*>(gout),
        static_cast<float*>(gvalue), static_cast<float*>(gloc), static_cast<float*>(gattn), B,
        S, Q, H, lv, P);
  } else if (dtype == kF32) {
    msda_sep_bwd_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const float*>(gout),
        static_cast<float*>(gvalue), static_cast<float*>(gloc), static_cast<float*>(gattn), B,
        S, Q, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 7.  Arguments as mdt_msda_sep.
int mdt_msda_dense_fused(void* value, void* loc, void* attn, void* out, int dtype, int B, int S,
                         int Q, int H, int D, int L, int P, void* hw, void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * Q * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_dense_fused_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<T*>(out), B, S, Q, H, lv, P);
  } else if (dtype == kF32) {
    msda_dense_fused_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), B, S, Q, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 7 backward: the query-side kernel (dloc, dattn) and the
// value-side kernel (dvalue), on one stream.  Arguments as
// mdt_msda_sep_bwd, except that gvalue [B, S, H, 32] has value's dtype and
// needs no zeroing: every row is written once.
int mdt_msda_dense_fused_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue,
                             void* gloc, void* gattn, int dtype, int B, int S, int Q, int H,
                             int D, int L, int P, void* hw, void* stream) {
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 32) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * Q * H);
  if (B * H == 0) return 0;  // Q == 0 still writes dvalue = 0
  unsigned bands = 0;
  for (int l = 0; l < L; ++l) bands += (lv.h[l] * lv.w[l] + kBandRows - 1) / kBandRows;
  const dim3 vgrid(bands, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    if (grid > 0)
      msda_sep_bwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const T*>(gout), nullptr,
        static_cast<float*>(gloc), static_cast<float*>(gattn), B, S, Q, H, lv, P);
    msda_dense_fused_bwd_value_kernel<T><<<vgrid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<const T*>(gout), static_cast<T*>(gvalue), S, Q, H, lv, P);
  } else if (dtype == kF32) {
    if (grid > 0)
      msda_sep_bwd_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const float*>(gout), nullptr,
        static_cast<float*>(gloc), static_cast<float*>(gattn), B, S, Q, H, lv, P);
    msda_dense_fused_bwd_value_kernel<float><<<vgrid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<const float*>(gout), static_cast<float*>(gvalue), S, Q, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
