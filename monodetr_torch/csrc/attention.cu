// Multi-head attention forward, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces monodetr_tpu/ops/attention_pallas.py:fused_attention (forward
// _fwd_kernel, dropout_p == 0): the depth encoder's 1920 x 1920
// self-attention, H = 8, D = 32.
//
// Flash-style: one block per (batch*head, tile of 128 queries), one thread
// per query row.  K and V stream through shared memory in tiles of 64 keys
// (converted to f32 once per tile); each thread keeps its scaled row of
// logits for the tile in registers and folds it into a running max, sum and
// f32 output accumulator (online softmax), so the [Tq, Tk] logits and
// probabilities never reach device memory.  As in the Pallas kernel, logits
// and accumulator are f32 and the probabilities are rounded to v's type
// before they multiply v.
//
// What bounds it on the H100: arithmetic in the CUDA cores.  The kernel does
// 2 * 2 * Tq * Tk * D flops per (batch, head) (3.8 GFLOP per batch item at
// 1920 tokens and 8 heads) as scalar f32 FMAs with shared-memory broadcast
// operands, far below the tensor cores' rate; device-memory traffic is only
// q, k, v and out (~4 MB per batch item in bf16).  Moving QK^T and PV onto
// wgmma is the way to a faster kernel.
#include "common.cuh"

namespace mdt {

constexpr int kHeadDim = 32;
constexpr int kRows = 128;  // queries per block, one per thread
constexpr int kKeys = 64;   // keys per shared-memory tile

template <typename T>
__global__ void __launch_bounds__(kRows)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
                     float scale) {
  __shared__ __align__(16) float ks[kKeys][kHeadDim];
  __shared__ __align__(16) float vs[kKeys][kHeadDim];

  const int64_t bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < Tq;
  const T* kb = k + bh * Tk * kHeadDim;
  const T* vb = v + bh * Tk * kHeadDim;

  float qr[kHeadDim];
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    qr[d] = live ? to_f32(q[(bh * Tq + row) * kHeadDim + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kKeys) {
    const int nk = min(kKeys, Tk - k0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < kKeys * kHeadDim; i += kRows) {
      const int j = i / kHeadDim;
      const bool in = j < nk;
      ks[j][i % kHeadDim] = in ? to_f32(kb[(int64_t)k0 * kHeadDim + i]) : 0.f;
      vs[j][i % kHeadDim] = in ? to_f32(vb[(int64_t)k0 * kHeadDim + i]) : 0.f;
    }
    __syncthreads();

    float s[kKeys];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[j] = j < nk ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l += p;
      const float pv = to_f32(from_f32<T>(p));  // probabilities in v's type
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(pv, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d)
      o[(bh * Tq + row) * kHeadDim + d] = from_f32<T>(acc[d] * inv);
  }
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// q [BH, Tq, 32], k, v [BH, Tk, 32], o [BH, Tq, 32]; all of one dtype.
int mdt_attention_fwd(void* q, void* k, void* v, void* o, int dtype, int BH, int Tq,
                      int Tk, int D, float scale, void* stream) {
  if (D != kHeadDim || Tk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return 0;
  const dim3 grid((Tq + kRows - 1) / kRows, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    attention_fwd_kernel<__nv_bfloat16><<<grid, kRows, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Tq, Tk,
        scale);
  } else if (dtype == kF32) {
    attention_fwd_kernel<float><<<grid, kRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Tq, Tk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
