// Windowed deformable attention for encoder grid queries, the two opt-in
// encoder kernels (msda_impl 'pallas' and 'sepwin'), forward and backward.
//
// Kernel 5 (replaces monodetr_tpu/ops/msda_pallas.py:
// ms_deform_attn_pallas_packed, fwd _fwd_kernel, bwd _bwd_kernel).  Bilinear
// MSDA, zero padding, at pixel positions (fx, fy) that the caller has
// already clamped to each query's window, with given (softmaxed) weights.
// fx, fy and att are lane-packed [B, S, H*L*P] f32, lane = (l*H + h)*P + p
// (lv*32 + h*4 + p at H = 8, P = 4).  The backward writes gfx, gfy, gatt in
// the same layout, unmasked: the clamp lives outside, in autograd.
//
// Kernel 6 (replaces monodetr_tpu/ops/msda_sepwin_pallas.py:
// ms_deform_attn_sepwin, fwd _fwd_kernel, bwd _bwd_kernel).  The same
// windowed function from normalised locations loc [B, S, H, L, P, 2]: the
// prologue computes loc * (w, h) - 0.5 and clamps it to the query's static
// centre +- lim (common.cuh:grid_centre, as kernel 1 does), so the clamped
// [B, S, H, L, P, 2] tensor of the TPU path's _pack (167 MB a layer at
// batch 16) is never written.  The backward masks dloc where the position
// was clamped (strict bounds, as kernel 1's backward) and scales it by
// (w, h).
//
// Both run one warp per (batch, query, head), lane = channel (D = 32),
// lane j < L*P reads sample j, the corner rows gathered by
// common.cuh:sample_heads_sum; dvalue by f32 atomics
// (common.cuh:sample_heads_bwd).  What bounds them on the H100 is L1/L2
// gather throughput; kernel 1's layout of four threads per (query, head)
// with 16-byte loads (msda.cu) computes the same function faster.  The TPU kernels' strip DMAs, hat functions and
// matmuls are not carried over: they existed because TPU gathers are slow.
#include "common.cuh"

namespace mdt {

// Kernel 5's sample for lane j = l*P + p of the warp for (bq, h): packed
// lane (l*H + h)*P + p of row bq.  Other lanes get 0.
struct PackedSample {
  float att, fx, fy;
  int64_t i;
};

__device__ __forceinline__ PackedSample packed_sample(const float* __restrict__ fx,
                                                      const float* __restrict__ fy,
                                                      const float* __restrict__ att,
                                                      int64_t bq, int H, int h,
                                                      const Levels& lv, int P, int lane) {
  PackedSample s{0.f, 0.f, 0.f, 0};
  if (lane < lv.n * P) {
    const int l = lane / P;
    s.i = bq * H * lv.n * P + ((int64_t)l * H + h) * P + (lane - l * P);
    s.att = att[s.i];
    s.fx = fx[s.i];
    s.fy = fy[s.i];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_pallas_kernel(const T* __restrict__ value, const float* __restrict__ fx,
                   const float* __restrict__ fy, const float* __restrict__ att,
                   T* __restrict__ out, int B, int S, int H, Levels lv, int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;  // whole warps exit together
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;  // b * S + q
  const int b = (int)(bq / S);
  const PackedSample s = packed_sample(fx, fy, att, bq, H, h, lv, P, lane);
  const int64_t row = (int64_t)H * 32;
  const float acc =
      sample_heads_sum(value + (int64_t)b * S * row + h * 32, row, lv, P, s.att, s.fx, s.fy, lane);
  out[bq * row + h * 32 + lane] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_pallas_bwd_kernel(const T* __restrict__ value, const float* __restrict__ fx,
                       const float* __restrict__ fy, const float* __restrict__ att,
                       const T* __restrict__ gout, float* __restrict__ gvalue,
                       float* __restrict__ gfx, float* __restrict__ gfy, float* __restrict__ gatt,
                       int B, int S, int H, Levels lv, int P) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;
  const int b = (int)(bq / S);
  const PackedSample s = packed_sample(fx, fy, att, bq, H, h, lv, P, lane);
  const int64_t row = (int64_t)H * 32;
  const int64_t base = (int64_t)b * S * row + h * 32;
  const float g = to_f32(gout[bq * row + h * 32 + lane]);
  float ga, gx, gy;
  sample_heads_bwd(value + base, gvalue + base, row, lv, P, s.att, s.fx, s.fy, g, lane, ga, gx,
                   gy);
  if (lane < lv.n * P) {
    gatt[s.i] = ga;
    gfx[s.i] = gx;
    gfy[s.i] = gy;
  }
}

// Kernel 6's sample for lane j = l*P + p of the warp for (b, q, h): weight,
// raw pixel position loc * (w, h) - 0.5, and the position clamped to
// [centre - lim, centre + lim] (bounds rounded to f32 as the plain
// version's tables are).
struct WinSample {
  float att, rx, ry, fx, fy, lox, hix, loy, hiy;
};

__device__ __forceinline__ WinSample win_sample(const float* __restrict__ loc,
                                                const float* __restrict__ attn, int64_t warp,
                                                int q, const Levels& lv, int P, float lim,
                                                int lane) {
  WinSample s{};
  if (lane < lv.n * P) {
    const int l = lane / P;
    const int64_t i = warp * lv.n * P + lane;  // [B, S, H, L, P] index
    const float2 c = grid_centre(grid_pos(q, lv), lv, l);
    s.att = attn[i];
    s.rx = loc[2 * i] * lv.w[l] - 0.5f;
    s.ry = loc[2 * i + 1] * lv.h[l] - 0.5f;
    s.lox = c.x - lim;
    s.hix = c.x + lim;
    s.loy = c.y - lim;
    s.hiy = c.y + lim;
    s.fx = fminf(fmaxf(s.rx, s.lox), s.hix);
    s.fy = fminf(fmaxf(s.ry, s.loy), s.hiy);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_sepwin_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn, T* __restrict__ out, int B, int S, int H,
                   Levels lv, int P, float lim) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;
  const int q = (int)(bq % S);
  const int b = (int)(bq / S);
  const WinSample s = win_sample(loc, attn, warp, q, lv, P, lim, lane);
  const int64_t row = (int64_t)H * 32;
  const float acc =
      sample_heads_sum(value + (int64_t)b * S * row + h * 32, row, lv, P, s.att, s.fx, s.fy, lane);
  out[bq * row + h * 32 + lane] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_sepwin_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ attn, const T* __restrict__ gout,
                       float* __restrict__ gvalue, float* __restrict__ gloc,
                       float* __restrict__ gattn, int B, int S, int H, Levels lv, int P,
                       float lim) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * S * H) return;
  const int h = (int)(warp % H);
  const int64_t bq = warp / H;
  const int q = (int)(bq % S);
  const int b = (int)(bq / S);
  const WinSample s = win_sample(loc, attn, warp, q, lv, P, lim, lane);
  const int64_t row = (int64_t)H * 32;
  const int64_t base = (int64_t)b * S * row + h * 32;
  const float g = to_f32(gout[bq * row + h * 32 + lane]);
  float ga, gx, gy;
  sample_heads_bwd(value + base, gvalue + base, row, lv, P, s.att, s.fx, s.fy, g, lane, ga, gx,
                   gy);
  if (lane < lv.n * P) {
    const int l = lane / P;
    const int64_t i = warp * lv.n * P + lane;
    gattn[i] = ga;
    gloc[2 * i] = (s.rx > s.lox && s.rx < s.hix) ? gx * lv.w[l] : 0.f;
    gloc[2 * i + 1] = (s.ry > s.loy && s.ry < s.hiy) ? gy * lv.h[l] : 0.f;
  }
}

inline bool bad_shape(int D, int L, int P) { return D != 32 || L < 1 || L > kMaxLevels || L * P > 32; }

}  // namespace mdt

using namespace mdt;

extern "C" {

// Kernel 5.  value [B, S, H, 32] (dtype), fx, fy, att [B, S, H*L*P] f32
// (lane-packed), out [B, S, H*32] (dtype); hw: host int array
// (h0, w0, h1, w1, ...) of the L levels.
int mdt_msda_pallas(void* value, void* fx, void* fy, void* att, void* out, int dtype, int B,
                    int S, int H, int D, int L, int P, void* hw, void* stream) {
  if (bad_shape(D, L, P)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(fx), *y = static_cast<const float*>(fy),
              *a = static_cast<const float*>(att);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_pallas_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), x, y, a, static_cast<T*>(out), B, S, H, lv, P);
  } else if (dtype == kF32) {
    msda_pallas_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), x, y, a, static_cast<float*>(out), B, S, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 5 backward.  value, fx, fy, att as mdt_msda_pallas; gout
// [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller;
// gfx, gfy, gatt shaped as fx (f32).
int mdt_msda_pallas_bwd(void* value, void* fx, void* fy, void* att, void* gout, void* gvalue,
                        void* gfx, void* gfy, void* gatt, int dtype, int B, int S, int H, int D,
                        int L, int P, void* hw, void* stream) {
  if (bad_shape(D, L, P)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(fx), *y = static_cast<const float*>(fy),
              *a = static_cast<const float*>(att);
  float *gv = static_cast<float*>(gvalue), *gx = static_cast<float*>(gfx),
        *gy = static_cast<float*>(gfy), *ga = static_cast<float*>(gatt);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_pallas_bwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), x, y, a, static_cast<const T*>(gout), gv, gx, gy, ga, B,
        S, H, lv, P);
  } else if (dtype == kF32) {
    msda_pallas_bwd_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), x, y, a, static_cast<const float*>(gout), gv, gx, gy,
        ga, B, S, H, lv, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 6.  value [B, S, H, 32] (dtype), loc [B, S, H, L, P, 2] f32, attn
// [B, S, H, L, P] f32, out [B, S, H*32] (dtype); lim: the window's clamp.
int mdt_msda_sepwin(void* value, void* loc, void* attn, void* out, int dtype, int B, int S,
                    int H, int D, int L, int P, void* hw, float lim, void* stream) {
  if (bad_shape(D, L, P)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *a = static_cast<const float*>(attn);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_sepwin_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), lc, a, static_cast<T*>(out), B, S, H, lv, P, lim);
  } else if (dtype == kF32) {
    msda_sepwin_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), lc, a, static_cast<float*>(out), B, S, H, lv, P, lim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 6 backward.  value, loc, attn as mdt_msda_sepwin; gout
// [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller;
// gloc, gattn shaped as loc and attn (f32).
int mdt_msda_sepwin_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue,
                        void* gloc, void* gattn, int dtype, int B, int S, int H, int D, int L,
                        int P, void* hw, float lim, void* stream) {
  if (bad_shape(D, L, P)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = blocks_for_warps((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *a = static_cast<const float*>(attn);
  float *gv = static_cast<float*>(gvalue), *gl = static_cast<float*>(gloc),
        *ga = static_cast<float*>(gattn);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_sepwin_bwd_kernel<T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(value), lc, a, static_cast<const T*>(gout), gv, gl, ga, B, S, H,
        lv, P, lim);
  } else if (dtype == kF32) {
    msda_sepwin_bwd_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(value), lc, a, static_cast<const float*>(gout), gv, gl, ga, B,
        S, H, lv, P, lim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
