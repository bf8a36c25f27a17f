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
// Both share one sampling core (common.cuh:sample_heads_sum): one warp per
// (batch, query, head), lane = channel (D = 32), each bilinear corner one
// coalesced 32-channel load, f32 accumulation.  The backward kernels use
// the same layout (common.cuh:sample_heads_bwd): three warp sums per sample
// give the weight and position gradients, and the value gradient goes to
// an f32 buffer by one atomicAdd per valid corner and channel.  At B=16
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

constexpr int kWarpsPerBlock = 8;

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
  int lq = 0;
  while (lq + 1 < lv.n && q >= lv.start[lq + 1]) ++lq;
  const int r = q - lv.start[lq];
  const int gy = r / lv.w[lq];
  const int gx = r - gy * lv.w[lq];

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
    const int l = lane / P;
    const float cx = (float)(((double)gx + 0.5) * lv.w[l] / lv.w[lq] - 0.5);
    const float cy = (float)(((double)gy + 0.5) * lv.h[l] / lv.h[lq] - 0.5);
    e.fx = cx + fminf(fmaxf(e.ox, -lim), lim);
    e.fy = cy + fminf(fmaxf(e.oy, -lim), lim);
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

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_sep_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q,
                int H, Levels lv, int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;  // b * Q + q
  const int b = (int)(bq / Q);
  const int LP = lv.n * P;

  float att = 0.f, fx = 0.f, fy = 0.f;
  if (lane < LP) {
    const int l = lane / P;
    const int64_t i = warp * LP + lane;  // [B, Q, H, L, P] index
    att = attn[i];
    fx = loc[2 * i] * lv.w[l] - 0.5f;
    fy = loc[2 * i + 1] * lv.h[l] - 0.5f;
  }
  const int64_t row = (int64_t)H * 32;
  const T* v = value + (int64_t)b * S * row + h * 32;
  const float acc = sample_heads_sum(v, row, lv, P, att, fx, fy, lane);
  out[bq * row + h * 32 + lane] = from_f32<T>(acc);
}

// Kernel 2 backward (replaces msda_sep_pallas.py _bwd_kernel): dvalue by
// f32 atomics into gvalue (zeroed by the caller), dattn = sum_d g_d *
// sample, dloc = att * d sample / d(x, y) * (w, h).
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

  float att = 0.f, fx = 0.f, fy = 0.f;
  const int64_t i = warp * LP + lane;
  if (lane < LP) {
    const int l = lane / P;
    att = attn[i];
    fx = loc[2 * i] * lv.w[l] - 0.5f;
    fy = loc[2 * i + 1] * lv.h[l] - 0.5f;
  }
  const int64_t row = (int64_t)H * 32;
  const int64_t base = (int64_t)b * S * row + h * 32;
  const float g = to_f32(gout[bq * row + h * 32 + lane]);
  float gatt, gx, gy;
  sample_heads_bwd(value + base, gvalue + base, row, lv, P, att, fx, fy, g, lane, gatt, gx, gy);
  if (lane < LP) {
    const int l = lane / P;
    gattn[i] = gatt;
    gloc[2 * i] = gx * lv.w[l];
    gloc[2 * i + 1] = gy * lv.h[l];
  }
}

inline unsigned blocks_for_warps(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
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

const char* mdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
