// The encoder's multi-scale deformable attention for Hopper (sm_90a),
// forward.  Its backward is msda_win.cu's msda_enc_fused_bwd_*_kernel.
//
// Kernel 1 (replaces monodetr_tpu/ops/msda_enc_pallas.py:
// ms_deform_attn_enc_fused, forward _fwd_kernel).  Grid queries: query q of
// level lq sits at pixel (gx, gy); in every sampled level l it samples
// around the static centre ((g + 0.5) * size_l / size_lq - 0.5), at
// clip(offset, -lim, lim) pixels.  The prologue (per-head softmax over the
// L*P logits, the clamp, the centres) runs in the kernel on the raw
// projection outputs, so no [B, S, H, L, P] weight or location tensor is
// ever written to device memory.
//
// It runs the quad core of common.cuh (quad_sample_sum, quad_sample_dots),
// which it shares with the windowed kernels 5 and 6 of msda_win.cu and the
// decoder's kernels 2 and 7 of msda_loc.cu: four threads per (b, q, h),
// 16-byte corner loads.  Its backward is that of kernels 5 and 6 (the
// windowed tile sums of msda_win.cu) on kernel 1's operands.
//
// What bounds it on the H100: gathers.  At B=16, S=10200 kernel 1 reads
// 16 * 10200 * 8 * 16 * 4 corner rows of 64 B (bf16), ~5 GB of corner rows
// per layer against ~0.3 GB of unique input and output.  Neighbouring
// queries sample neighbouring pixels, and a block holds all heads of its
// queries (one 512 B token row per corner), so the rows are served mostly
// from L1/L2: the kernel is bound by the L1/L2 load path (instructions
// and bytes), not by HBM or arithmetic.  The TPU kernels' strip DMAs and
// hat-function matmuls existed because TPU gathers are slow; on Hopper the
// plain gather is the fast path.  Staging a query tile's value window in
// shared memory (the Hopper analogue of the TPU strips) is the next step
// if the L1 hit rate turns out to bound kernel 1's forward; its backward
// already sums a tile's value gradient there.
#include "common.cuh"

namespace mdt {

// Kernel 1 runs the quad core of common.cuh: 4 threads per (batch, query,
// head), thread s owning channels 8s .. 8s + 7.  A block is 64 quads: 8
// consecutive queries of one batch item x 8 heads, whose sampling windows
// overlap in L1.  Prologue: thread s reads logits and x/y offsets of samples
// 4s .. 4s + 3 by vector loads; the head's max and sum take 2 quad shuffles
// each (the head's own maximum, ROADMAP.md C2); each thread computes the
// weight, clamp and pixel position of its 4 samples (common.cuh:
// quad_softmax).  Sampling: common.cuh:quad_sample_sum.  The level table is
// a __grid_constant__ parameter, indexed in place, so the kernel keeps no
// stack frame.
constexpr int kEncQuads = 64;
constexpr int kEncThreads = 4 * kEncQuads;

// Thread s of the quad of (b, q, h): samples j = 4s + u (u < n), their
// softmaxed weight and clamped pixel position.
struct EncQuad {
  int n;
  float att[4], fx[4], fy[4];
};

template <typename T>
__device__ __forceinline__ EncQuad enc_prologue(const T* __restrict__ off,
                                                const T* __restrict__ logits, int64_t bq, int q,
                                                int H, int h, const Levels& lv, int P, float lim,
                                                int sub, unsigned qmask, bool vec) {
  const int LP = lv.n * P;
  const int64_t nlog = (int64_t)H * LP;
  EncQuad e;
  e.n = min(max(LP - 4 * sub, 0), 4);
  float ox[4], oy[4];
  load4(logits + bq * nlog + h * LP + 4 * sub, e.att, e.n, vec);
  load4(off + bq * 2 * nlog + h * LP + 4 * sub, ox, e.n, vec);
  load4(off + bq * 2 * nlog + nlog + h * LP + 4 * sub, oy, e.n, vec);
  quad_softmax(e.att, e.n, qmask);
  const GridPos gp = grid_pos(q, lv);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    e.fx[u] = e.fy[u] = 0.f;
    if (u < e.n) {
      const float2 c = grid_centre(gp, lv, (4 * sub + u) / P);
      e.fx[u] = c.x + fminf(fmaxf(ox[u], -lim), lim);
      e.fy[u] = c.y + fminf(fmaxf(oy[u], -lim), lim);
    }
  }
  return e;
}

template <typename T>
__global__ void __launch_bounds__(kEncThreads, 3)
msda_enc_fused_kernel(const T* __restrict__ value, const T* __restrict__ off,
                      const T* __restrict__ logits, T* __restrict__ out, int B, int S, int H,
                      const __grid_constant__ Levels lv, int P, float lim, bool vec) {
  const int64_t quad = ((int64_t)blockIdx.x * kEncThreads + threadIdx.x) >> 2;
  if (quad >= (int64_t)B * S * H) return;  // whole quads exit together
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const int h = (int)(quad % H);
  const int64_t bq = quad / H;  // b * S + q
  const int q = (int)(bq % S);
  const int b = (int)(bq / S);
  const EncQuad e = enc_prologue(off, logits, bq, q, H, h, lv, P, lim, sub, qmask, vec);

  const int row = H * 32;
  const T* vb = value + (int64_t)b * S * row + h * 32 + sub * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  quad_sample_sum(vb, row, lv, P, e.att, e.fx, e.fy, lane, qmask, acc);
  store8(out + bq * row + h * 32 + sub * 8, acc);
}

inline unsigned enc_blocks(int64_t quads) {
  return (unsigned)((quads + kEncQuads - 1) / kEncQuads);
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
  if (D != 32 || L < 1 || L > kMaxLevels || L * P > 16 || !fits_int32(S, H))
    return (int)cudaErrorInvalidValue;
  if (!aligned16({value, out})) return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = enc_blocks((int64_t)B * S * H);
  if (grid == 0) return 0;
  const bool vec = enc_vec(dtype, L * P, off, logits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_enc_fused_kernel<T><<<grid, kEncThreads, 0, st>>>(
        static_cast<const T*>(value), static_cast<const T*>(off), static_cast<const T*>(logits),
        static_cast<T*>(out), B, S, H, lv, P, lim, vec);
  } else if (dtype == kF32) {
    msda_enc_fused_kernel<float><<<grid, kEncThreads, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(off),
        static_cast<const float*>(logits), static_cast<float*>(out), B, S, H, lv, P, lim, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
