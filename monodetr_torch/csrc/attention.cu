// Multi-head attention, out = dropout(softmax(q k^T * scale)) v, forward and
// backward, for Hopper (sm_90a).
//
// Replaces monodetr_tpu/ops/attention_pallas.py:fused_attention (forward
// _fwd_kernel, backward _bwd_kernel): the depth encoder's 1920 x 1920
// self-attention and, in training, the decoder's 550 x 1920 depth
// cross-attention; H = 8, D = 32.
//
// Dropout (training): inverted dropout on the normalised probabilities,
// P(keep) = 1 - p, kept terms scaled by 1 / (1 - p).  The keep bit of
// (batch*head bh, query row i, key column j) is a pure function of the
// position and a 32-bit seed: word j % 4 of Philox4x32-10 at counter
// (j / 4, i, bh, 0), key (seed, kKey1), kept when the word is >= thr =
// p * 2^32.  The backward regenerates the same bits instead of storing a
// mask.  The seed is read from device memory, so a seed drawn from a CUDA
// generator never goes through the host.
//
// Forward, flash-style: one block per (batch*head, tile of 128 queries), one
// thread per query row.  K and V stream through shared memory in tiles of
// 64 keys (converted to f32 once per tile); each thread keeps its scaled row
// of logits for the tile in registers and folds it into a running max, sum
// and f32 output accumulator (online softmax), so the [Tq, Tk] logits and
// probabilities never reach device memory.  The keep bits and 1 / (1 - p)
// apply to the unnormalised terms; the row sum divides at the end.  As in
// the Pallas kernel, logits and accumulator are f32 and the probabilities
// are rounded to v's type before they multiply v.  The forward also writes
// the per-row log-sum-exp for the backward.
//
// Backward, flash-style, two kernels without atomics:
//   dq:  one thread per query row, looping over key tiles: recomputes
//        P = exp(s - lse), dP = keep / (1 - p) * dO.V^T,
//        dS = P (dP - rowsum(dO o O)) (the identity holds with dropout:
//        rowsum(P dP) = dO.O), dQ = dS K * scale.  It also writes
//        delta = rowsum(dO o O) for the second kernel.
//   dkv: one thread per key row, looping over query tiles: dV = Pd^T dO with
//        Pd = keep / (1 - p) * P, dK = dS^T Q * scale.
// Tq != Tk works (550 x 1920 in training).
//
// What bounds them on the H100: arithmetic in the CUDA cores.  The forward
// does 2 * 2 * Tq * Tk * D flops per (batch, head), the backward twice that
// again plus one Philox call per probability in the dkv kernel, as scalar
// f32 FMAs with shared-memory broadcast operands, far below the tensor
// cores' rate; device-memory traffic is only q, k, v, o, dO and the grads.
// Moving the products onto wgmma is the way to faster kernels.
#include "common.cuh"

namespace mdt {

constexpr int kHeadDim = 32;
constexpr int kRows = 128;  // queries (or keys) per block, one per thread
constexpr int kKeys = 64;   // keys (or queries) per shared-memory tile
constexpr uint32_t kKey1 = 0x6D2B79F5u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// The four keep bits of columns 4*j4 .. 4*j4+3 of row i (bit c for column
// 4*j4 + c).
__device__ __forceinline__ uint32_t keep4(uint32_t seed, uint32_t bh, uint32_t i, uint32_t j4,
                                          uint32_t thr) {
  const uint4 r = philox4x32_10(make_uint4(j4, i, bh, 0u), make_uint2(seed, kKey1));
  return (uint32_t)(r.x >= thr) | ((uint32_t)(r.y >= thr) << 1) |
         ((uint32_t)(r.z >= thr) << 2) | ((uint32_t)(r.w >= thr) << 3);
}

__device__ __forceinline__ bool keep1(uint32_t seed, uint32_t bh, uint32_t i, uint32_t j,
                                      uint32_t thr) {
  return (keep4(seed, bh, i, j >> 2, thr) >> (j & 3)) & 1u;
}

// a: registers, b: a 16-byte aligned row of shared memory.
__device__ __forceinline__ float dot32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
    const float4 bb = reinterpret_cast<const float4*>(b)[d4];
    acc = fmaf(a[4 * d4], bb.x, acc);
    acc = fmaf(a[4 * d4 + 1], bb.y, acc);
    acc = fmaf(a[4 * d4 + 2], bb.z, acc);
    acc = fmaf(a[4 * d4 + 3], bb.w, acc);
  }
  return acc;
}

// y (registers) += a * x (a 16-byte aligned row of shared memory).
__device__ __forceinline__ void axpy32(float a, const float* x, float* y) {
#pragma unroll
  for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
    const float4 xx = reinterpret_cast<const float4*>(x)[d4];
    y[4 * d4] = fmaf(a, xx.x, y[4 * d4]);
    y[4 * d4 + 1] = fmaf(a, xx.y, y[4 * d4 + 1]);
    y[4 * d4 + 2] = fmaf(a, xx.z, y[4 * d4 + 2]);
    y[4 * d4 + 3] = fmaf(a, xx.w, y[4 * d4 + 3]);
  }
}

// Copy rows [r0, r0 + n) of two [T, 32] matrices into [kKeys][32] f32
// tiles, zero-filling past n.  The stride is the block size as a constant,
// so the loop unrolls and all of a thread's loads are in flight together:
// with blockDim.x as the stride the forward at 1920 x 1920, batch 16, took
// 5.4 ms instead of 3.5 ms on the H100.
template <typename T>
__device__ __forceinline__ void load_tiles(float (*da)[kHeadDim], const T* __restrict__ a,
                                           float (*db)[kHeadDim], const T* __restrict__ b,
                                           int r0, int n) {
#pragma unroll
  for (int i = threadIdx.x; i < kKeys * kHeadDim; i += kRows) {
    const int j = i / kHeadDim;
    const bool in = j < n;
    da[j][i % kHeadDim] = in ? to_f32(a[(int64_t)r0 * kHeadDim + i]) : 0.f;
    db[j][i % kHeadDim] = in ? to_f32(b[(int64_t)r0 * kHeadDim + i]) : 0.f;
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRows)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int Tq, int Tk, float scale, const int64_t* __restrict__ seed_ptr,
                     uint32_t thr, float inv_keep) {
  __shared__ __align__(16) float ks[kKeys][kHeadDim];
  __shared__ __align__(16) float vs[kKeys][kHeadDim];

  const int64_t bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < Tq;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
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
    load_tiles(ks, kb, vs, vb, k0, nk);
    __syncthreads();

    uint64_t keep = ~0ull;
    if (kDrop) {
      keep = 0ull;
#pragma unroll 4
      for (int j4 = 0; j4 < kKeys / 4; ++j4)
        keep |= (uint64_t)keep4(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)((k0 >> 2) + j4),
                                thr)
                << (4 * j4);
    }

    float s[kKeys];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = j < nk ? dot32(qr, ks[j]) * scale : -INFINITY;
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
      // probabilities in v's type, then the keep bit and 1 / (1 - p)
      const float pr = to_f32(from_f32<T>(p));
      const float pv = kDrop ? (((keep >> j) & 1ull) ? pr * inv_keep : 0.f) : pr;
      axpy32(pv, vs[j], acc);
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d)
      o[(bh * Tq + row) * kHeadDim + d] = from_f32<T>(acc[d] * inv);
    if (lse != nullptr) lse[bh * Tq + row] = m + logf(l);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRows)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ go, const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk,
                        float scale, const int64_t* __restrict__ seed_ptr, uint32_t thr,
                        float inv_keep) {
  __shared__ __align__(16) float ks[kKeys][kHeadDim];
  __shared__ __align__(16) float vs[kKeys][kHeadDim];

  const int64_t bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < Tq;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
  const T* kb = k + bh * Tk * kHeadDim;
  const T* vb = v + bh * Tk * kHeadDim;
  const int64_t r = (bh * Tq + row) * kHeadDim;

  float qr[kHeadDim], gr[kHeadDim], acc[kHeadDim];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    qr[d] = live ? to_f32(q[r + d]) : 0.f;
    gr[d] = live ? to_f32(go[r + d]) : 0.f;
    dl = fmaf(gr[d], live ? to_f32(o[r + d]) : 0.f, dl);
    acc[d] = 0.f;
  }
  const float lse_i = live ? lse[bh * Tq + row] : 0.f;
  if (live) delta[bh * Tq + row] = dl;

  for (int k0 = 0; k0 < Tk; k0 += kKeys) {
    const int nk = min(kKeys, Tk - k0);
    __syncthreads();
    load_tiles(ks, kb, vs, vb, k0, nk);
    __syncthreads();

    uint64_t keep = ~0ull;
    if (kDrop) {
      keep = 0ull;
#pragma unroll 4
      for (int j4 = 0; j4 < kKeys / 4; ++j4)
        keep |= (uint64_t)keep4(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)((k0 >> 2) + j4),
                                thr)
                << (4 * j4);
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot32(qr, ks[j]) * scale - lse_i);
      const float dpd = dot32(gr, vs[j]);
      const float dp = kDrop ? (((keep >> j) & 1ull) ? dpd * inv_keep : 0.f) : dpd;
      axpy32(p * (dp - dl), ks[j], acc);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) dq[r + d] = from_f32<T>(acc[d] * scale);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRows)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ go,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, float scale,
                         const int64_t* __restrict__ seed_ptr, uint32_t thr, float inv_keep) {
  __shared__ __align__(16) float qs[kKeys][kHeadDim];
  __shared__ __align__(16) float gs[kKeys][kHeadDim];
  __shared__ float ls[kKeys];
  __shared__ float ds[kKeys];

  const int64_t bh = blockIdx.y;
  const int col = blockIdx.x * kRows + threadIdx.x;
  const bool live = col < Tk;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
  const T* qb = q + bh * Tq * kHeadDim;
  const T* gb = go + bh * Tq * kHeadDim;
  const int64_t r = (bh * Tk + col) * kHeadDim;

  float kr[kHeadDim], vr[kHeadDim], dka[kHeadDim], dva[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    kr[d] = live ? to_f32(k[r + d]) : 0.f;
    vr[d] = live ? to_f32(v[r + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < Tq; q0 += kKeys) {
    const int nq = min(kKeys, Tq - q0);
    __syncthreads();
    load_tiles(qs, qb, gs, gb, q0, nq);
    if (threadIdx.x < kKeys) {
      const int i = threadIdx.x;
      ls[i] = i < nq ? lse[bh * Tq + q0 + i] : 0.f;
      ds[i] = i < nq ? delta[bh * Tq + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < nq; ++i) {
      const float p = expf(dot32(kr, qs[i]) * scale - ls[i]);
      const bool kept =
          !kDrop || keep1(seed, (uint32_t)bh, (uint32_t)(q0 + i), (uint32_t)col, thr);
      const float dp = kept ? dot32(vr, gs[i]) * inv_keep : 0.f;
      axpy32(kept ? p * inv_keep : 0.f, gs[i], dva);
      axpy32(p * (dp - ds[i]), qs[i], dka);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      dk[r + d] = from_f32<T>(dka[d] * scale);
      dv[r + d] = from_f32<T>(dva[d]);
    }
  }
}

__global__ void attention_keep_mask_kernel(uint8_t* __restrict__ out, int BH, int Tq, int Tk,
                                           const int64_t* __restrict__ seed_ptr,
                                           uint32_t thr) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)BH * Tq * Tk) return;
  const int j = (int)(idx % Tk);
  const int64_t bi = idx / Tk;
  const int i = (int)(bi % Tq);
  const int bh = (int)(bi / Tq);
  out[idx] = keep1((uint32_t)*seed_ptr, (uint32_t)bh, (uint32_t)i, (uint32_t)j, thr) ? 1 : 0;
}

inline float inv_keep_of(uint32_t thr) {
  return thr == 0u ? 1.f : (float)(1.0 / (1.0 - (double)thr / 4294967296.0));
}

// The instantiation without dropout carries no mask code.
template <typename T>
void launch_fwd(dim3 grid, cudaStream_t st, void* q, void* k, void* v, void* o, float* lse,
                int Tq, int Tk, float scale, const int64_t* seed, uint32_t thr, float ik) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  if (thr != 0u)
    attention_fwd_kernel<T, true><<<grid, kRows, 0, st>>>(qt, kt, vt, static_cast<T*>(o), lse,
                                                          Tq, Tk, scale, seed, thr, ik);
  else
    attention_fwd_kernel<T, false><<<grid, kRows, 0, st>>>(qt, kt, vt, static_cast<T*>(o), lse,
                                                           Tq, Tk, scale, seed, thr, ik);
}

template <typename T, bool kDrop>
void launch_bwd_as(dim3 gq, dim3 gk, cudaStream_t st, void* q, void* k, void* v, void* o,
                   void* go, const float* lse, float* delta, void* dq, void* dk, void* dv, int Tq,
                   int Tk, float scale, const int64_t* seed, uint32_t thr, float ik) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(go);
  attention_bwd_dq_kernel<T, kDrop><<<gq, kRows, 0, st>>>(
      qt, kt, vt, static_cast<const T*>(o), gt, lse, delta, static_cast<T*>(dq), Tq, Tk, scale,
      seed, thr, ik);
  attention_bwd_dkv_kernel<T, kDrop><<<gk, kRows, 0, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, scale, seed,
      thr, ik);
}

template <typename T>
void launch_bwd(dim3 gq, dim3 gk, cudaStream_t st, void* q, void* k, void* v, void* o,
                void* go, const float* lse, float* delta, void* dq, void* dk, void* dv, int Tq,
                int Tk, float scale, const int64_t* seed, uint32_t thr, float ik) {
  if (thr != 0u)
    launch_bwd_as<T, true>(gq, gk, st, q, k, v, o, go, lse, delta, dq, dk, dv, Tq, Tk, scale,
                           seed, thr, ik);
  else
    launch_bwd_as<T, false>(gq, gk, st, q, k, v, o, go, lse, delta, dq, dk, dv, Tq, Tk, scale,
                            seed, thr, ik);
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// q [BH, Tq, 32], k, v [BH, Tk, 32], o [BH, Tq, 32], all of one dtype;
// lse [BH, Tq] f32 or null; seed: device int64; thr = p * 2^32 (0: no
// dropout).
int mdt_attention_fwd(void* q, void* k, void* v, void* o, void* lse, int dtype, int BH,
                      int Tq, int Tk, int D, float scale, void* seed, unsigned thr,
                      void* stream) {
  if (D != kHeadDim || Tk < 1 || BH > 65535 || (thr != 0u && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return 0;
  const dim3 grid((Tq + kRows - 1) / kRows, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* sp = static_cast<const int64_t*>(seed);
  float* l = static_cast<float*>(lse);
  const float ik = inv_keep_of(thr);
  if (dtype == kBF16) {
    launch_fwd<__nv_bfloat16>(grid, st, q, k, v, o, l, Tq, Tk, scale, sp, thr, ik);
  } else if (dtype == kF32) {
    launch_fwd<float>(grid, st, q, k, v, o, l, Tq, Tk, scale, sp, thr, ik);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward.  q, k, v, o, go (dtype) as the forward; lse [BH, Tq] f32 from
// the forward; delta [BH, Tq] f32 scratch; dq, dk, dv shaped as q, k, v.
int mdt_attention_bwd(void* q, void* k, void* v, void* o, void* go, void* lse, void* delta,
                      void* dq, void* dk, void* dv, int dtype, int BH, int Tq, int Tk, int D,
                      float scale, void* seed, unsigned thr, void* stream) {
  if (D != kHeadDim || Tk < 1 || BH > 65535 || (thr != 0u && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return 0;
  const dim3 gq((Tq + kRows - 1) / kRows, BH), gk((Tk + kRows - 1) / kRows, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* sp = static_cast<const int64_t*>(seed);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float ik = inv_keep_of(thr);
  if (dtype == kBF16) {
    launch_bwd<__nv_bfloat16>(gq, gk, st, q, k, v, o, go, l, dl, dq, dk, dv, Tq, Tk, scale, sp,
                              thr, ik);
  } else if (dtype == kF32) {
    launch_bwd<float>(gq, gk, st, q, k, v, o, go, l, dl, dq, dk, dv, Tq, Tk, scale, sp, thr,
                      ik);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The keep mask [BH, Tq, Tk] (uint8 0/1) that the kernels above draw for
// this seed and threshold, for holding them against their plain version.
int mdt_attention_keep_mask(void* out, int BH, int Tq, int Tk, void* seed, unsigned thr,
                            void* stream) {
  const int64_t n = (int64_t)BH * Tq * Tk;
  if (n == 0) return 0;
  attention_keep_mask_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), BH, Tq, Tk, static_cast<const int64_t*>(seed), thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
