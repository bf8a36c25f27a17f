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
// The function, in every kernel below: f32 logits, online softmax in f32,
// the probabilities rounded to v's type before they multiply v, the keep
// bits applied to the rounded probabilities, 1 / (1 - p) applied once to
// the f32 sum (every kept term carries it), and the per-row log-sum-exp
// written for the backward.  The backward recomputes P = exp(s - lse) and
// uses dS = P (dP - rowsum(dO o O)) (the identity holds with dropout:
// rowsum(P dP) = dO.O).  Tq != Tk works (550 x 1920 in training).
//
// bf16 (the training and eval path): tensor-core kernels, `wgmma` only.
//   What bounds them on the H100: at D = 32 each key tile is 64 keys x 64
//   bytes, so the products are small and cheap on the tensor cores (the
//   forward at 1920 x 1920, batch 16 is 60 GFLOP, 0.06 ms at 989 TF/s);
//   what is left is the per-probability work on the CUDA cores: the exp,
//   the online-softmax bookkeeping, the conversion to bf16 and, with
//   dropout, one Philox4x32-10 call per 4 probabilities (10 rounds of 2
//   mul.hi, 2 mul.lo and 4 xor/add, ~18 integer ops per probability,
//   more than the rest together).
//   Design: one CTA of one warpgroup (128 threads) per (batch*head, tile
//   of 64 rows).  Every product is `wgmma.mma_async` m64nNk16 with A in
//   registers and B in shared memory:
//     forward  S = Q K^T (n64, 2 k-steps), O += P V (n32, 4 k-steps);
//     dq       S = Q K^T, dP = dO V^T (n64), dQ += dS K (n32);
//     dkv      S^T = K Q^T, dP^T = V dO^T (n64), dV += Pd^T dO, dK += dS^T Q
//              (n32): the dkv kernel recomputes the transposed tile, so its
//              A operands are the accumulators of its own products.
//   A is Q / dO / K / V loaded once into registers, or an f32 accumulator
//   converted to bf16 in place (the m64nN accumulator layout of one k16
//   column block is the A fragment layout).  Every shared-memory tile is a
//   [64 rows, 32 bf16] tile of core matrices (8 rows x 16 bytes, 128
//   contiguous bytes; core (r / 8, c / 8) at byte ((r / 8) * 4 + c / 8) *
//   128), which is B as [N rows, K cols] K-major (K^T, V^T, Q^T, dO^T) and,
//   with the transpose bit, B as [K rows, N cols] MN-major (V, K, dO, Q),
//   so no tile is ever transposed in memory.  The tiles stream through a
//   3-stage ring by cp.async (16 bytes a copy, zero-filled past the
//   ragged edge), completed by cp.async groups and one __syncthreads per
//   tile: with one warpgroup per CTA an mbarrier would only replace that
//   barrier.  Ragged edges (Tq = 550, 50,
//   Tk in general) are masked in the kernel.  The keep bits: a thread
//   holds 2 rows x 16 columns of each 64 x 64 tile; each Philox word is
//   computed by one thread and passed to the threads holding its other
//   columns by __shfl_xor_sync (forward, dq: pairs of lanes) or
//   __shfl_sync (dkv: groups of 4 lanes, whose rows are the 4 keys of a
//   word), so each call is made once per 4 probabilities.
//
// f32 (only the f32 parity checks run it): the scalar kernels below, one
// thread per row, f32 FMAs on the CUDA cores.  On the tensor cores f32
// would run as TF32 (10-bit mantissa) and miss the f32 tolerance of the
// checks; mdt_attention_fwd and mdt_attention_bwd dispatch by dtype.
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

// ---------------------------------------------------------------------------
// f32: one thread per row, scalar FMAs.  Forward: one block per (batch*head,
// 128 queries); K and V stream through shared memory in tiles of 64 keys,
// each thread folds its row of logits into a running max, sum and output
// (online softmax).  Backward: dq (one thread per query row, looping over
// key tiles; also writes delta = rowsum(dO o O)) and dkv (one thread per
// key row, looping over query tiles), no atomics.

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (see the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;    // rows per CTA, and rows per shared-memory tile
constexpr int kStages = 3;   // tiles in flight in the cp.async ring
constexpr int kTileElems = kTile * kHeadDim;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// wgmma descriptor strides of a tile (bytes between neighbouring core
// matrices): K-major B walks 16 columns (2 cores, 256 B) per k-step, cores
// along K are 128 B apart and cores along N 512 B; MN-major (transposed) B
// walks 16 rows (2 cores, 1024 B) per k-step, cores along K are 512 B apart
// and cores along N 128 B.
constexpr uint32_t kKmajLbo = 128, kKmajSbo = 512, kKmajStep = 256;
constexpr uint32_t kMnLbo = 512, kMnSbo = 128, kMnStep = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (4-byte) copy from global to shared memory; src_bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until this thread's copies of the oldest tile have landed, make them
// visible to wgmma (the async proxy) and to the other threads.
__device__ __forceinline__ void tile_arrived() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [r0, r0 + n) of a [T, 32] bf16 matrix into a tile of core matrices,
// zeros past n.  Chunk s (16 bytes) of the tile is row (s / 32) * 8 + s % 8,
// columns 8 * ((s / 8) % 4) + 0..7: consecutive threads write consecutive
// shared memory, and a warp reads 8 whole rows (512 contiguous bytes).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int n) {
  const uint32_t d = smem_u32(dst);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = threadIdx.x + h * 128;
    const int row = (s >> 5) * 8 + (s & 7), cb = (s >> 3) & 3;
    const bool in = row < n;
    cp_async16(d + s * 16, src + (in ? (int64_t)(r0 + row) * kHeadDim + cb * 8 : 0),
               in ? 16 : 0);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// B = the tile as [N = 64 rows, K = 32 columns] (K-major), k-step kk.
__device__ __forceinline__ uint64_t desc_kmaj(const bf16* tile, int kk) {
  return desc(smem_u32(tile) + kKmajStep * kk, kKmajLbo, kKmajSbo);
}
// B = the tile as [K = 64 rows, N = 32 columns] (MN-major), k-step kk.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return desc(smem_u32(tile) + kMnStep * kk, kMnLbo, kMnSbo);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's accesses of accumulator registers against wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 16] (registers) * B (K-major tile).
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 16] (registers) * B (MN-major tile, transpose bit).
__device__ __forceinline__ void mma_n32t(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Accumulator element i of thread (warp w, lane l) of an m64nN product:
// row 16w + l / 4 + 8 * hf(i), column col(i, l).
__device__ __forceinline__ int hf(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

// The A fragments (two k16 steps over the 32 columns) of rows r and r + 8
// of a [T, 32] bf16 matrix, zeros past row n.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* __restrict__ m, int r,
                                       int n, int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = r + 8 * (j & 1), cc = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + c;
    a[j >> 2][j & 3] =
        row < n ? *reinterpret_cast<const uint32_t*>(m + (int64_t)row * kHeadDim + cc) : 0u;
  }
}

// An m64n64 accumulator in bf16 as the A fragments of a product over its 64
// columns (k-step kk = columns 16kk .. 16kk + 15).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// The keep bits of a thread's 32 elements of a 64 x 64 tile whose rows are
// queries (forward, dq): bit 4 * (i / 4) + 2 * (lane & 1) + i % 2 of
// word[hf(i)].  Lanes l and l ^ 1 hold the same rows and the two halves of
// each group of 4 keys: the even lane draws row r's 8 words, the odd lane
// row r + 8's, and they swap.
__device__ __forceinline__ void keep_rows(uint32_t (&word)[2], uint32_t seed, uint32_t bh,
                                          int r, int k0, uint32_t thr, int lane) {
  const uint32_t row = r + 8 * (lane & 1), j4 = (k0 >> 2) + ((lane & 3) >> 1);
  uint32_t w = 0;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) w |= keep4(seed, bh, row, j4 + 2 * jb, thr) << (4 * jb);
  const uint32_t other = __shfl_xor_sync(kFullMask, w, 1);
  word[0] = (lane & 1) ? other : w;
  word[1] = (lane & 1) ? w : other;
}
__device__ __forceinline__ bool kept_rows(const uint32_t (&word)[2], int i, int lane) {
  return (word[hf(i)] >> (4 * (i >> 2) + 2 * (lane & 1) + (i & 1))) & 1u;
}

// The same for a tile whose rows are keys and columns queries (dkv).  The
// key rows of lanes l ^ {0, 4, 8, 12} are the 4 keys of one Philox word;
// lane t = (l / 4) % 4 of the four draws the words of column blocks 2t and
// 2t + 1 (for both row halves), and each lane reads all four.
__device__ __forceinline__ void keep_cols(uint32_t (&word)[4], uint32_t seed, uint32_t bh,
                                          int r, int q0, uint32_t thr, int lane) {
  const int t = (lane >> 2) & 3;
  const uint32_t g4 = (uint32_t)r >> 2;  // key group of row r; row r + 8 is group g4 + 2
  uint32_t w = 0;
#pragma unroll
  for (int idx = 0; idx < 8; ++idx) {
    const int jb = 2 * t + (idx >> 2), e = (idx >> 1) & 1, rg = idx & 1;
    const uint32_t c = q0 + 8 * jb + 2 * (lane & 3) + e;
    w |= keep4(seed, bh, c, g4 + 2 * rg, thr) << (4 * idx);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) word[u] = __shfl_sync(kFullMask, w, (lane & ~12) | (u << 2));
}
__device__ __forceinline__ bool kept_cols(const uint32_t (&word)[4], int i, int lane) {
  const int jb = i >> 2, idx = ((jb & 1) << 2) | ((i & 1) << 1) | hf(i);
  return (word[jb >> 1] >> (4 * idx + ((lane >> 2) & 3))) & 1u;
}

// Forward.  grid (ceil(Tq / 64), BH), 128 threads.
template <bool kDrop>
__global__ void __launch_bounds__(128)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int Tq, int Tk, float scale,
                        const int64_t* __restrict__ seed_ptr, uint32_t thr, float inv_keep) {
  __shared__ __align__(128) bf16 ks[kStages][kTileElems];
  __shared__ __align__(128) bf16 vs[kStages][kTileElems];
  const int bh = blockIdx.y, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kTile + (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows r, r + 8
  const bf16* kb = k + (int64_t)bh * Tk * kHeadDim;
  const bf16* vb = v + (int64_t)bh * Tk * kHeadDim;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
  const float sl = scale * kLog2e;
  const int nt = (Tk + kTile - 1) / kTile;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) {
      load_tile(ks[t], kb, t * kTile, min(kTile, Tk - t * kTile));
      load_tile(vs[t], vb, t * kTile, min(kTile, Tk - t * kTile));
    }
    cp_async_commit();
  }
  uint32_t qa[2][4];
  load_a(qa, q + (int64_t)bh * Tq * kHeadDim, r, Tq, lane);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nt; ++t) {
    tile_arrived();
    const int tn = t + kStages - 1;
    if (tn < nt) {  // into the stage that tile t - 1 used
      load_tile(ks[tn % kStages], kb, tn * kTile, min(kTile, Tk - tn * kTile));
      load_tile(vs[tn % kStages], vb, tn * kTile, min(kTile, Tk - tn * kTile));
    }
    cp_async_commit();
    const bf16* kt = ks[t % kStages];
    const bf16* vt = vs[t % kStages];
    const int k0 = t * kTile;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    mma_n64(s, qa[0], desc_kmaj(kt, 0));
    mma_n64(s, qa[1], desc_kmaj(kt, 1));
    wg_commit_wait();
    fence_regs(s);

    uint32_t word[2] = {0u, 0u};
    if (kDrop) keep_rows(word, seed, bh, r, k0, thr, lane);
    const bool ragged = k0 + kTile > Tk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (ragged && k0 + col(i, lane) >= Tk) ? -INFINITY : s[i] * sl;
      mx[hf(i)] = fmaxf(mx[hf(i)], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - mn);  // 0 on the first tile (m = -inf)
      m[h] = mn;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[hf(i)]);  // 0 for masked keys
      l[hf(i)] += p;  // this thread's part of the row sum, before dropout
      s[i] = (!kDrop || kept_rows(word, i, lane)) ? p : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= corr[hf(i)];
    uint32_t pa[4][4];
    acc_to_a(pa, s);  // the probabilities in bf16
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_n32t(acc, pa[kk], desc_mn(vt, kk));
    wg_commit_wait();
    fence_regs(acc);
  }

  bf16* ob = o + (int64_t)bh * Tq * kHeadDim;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFullMask, l[h], 1);
    l[h] += __shfl_xor_sync(kFullMask, l[h], 2);
    const int row = r + 8 * h;
    if (row < Tq) {
      const float f = (kDrop ? inv_keep : 1.f) / l[h];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
        *reinterpret_cast<uint32_t*>(ob + (int64_t)row * kHeadDim + 8 * jb + 2 * (lane & 3)) =
            pack_bf16(acc[4 * jb + 2 * h] * f, acc[4 * jb + 2 * h + 1] * f);
      if (lse != nullptr && (lane & 3) == 0)
        lse[(int64_t)bh * Tq + row] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

// Backward, dq: also writes delta = rowsum(dO o O).  Grid (ceil(Tq / 64), BH).
template <bool kDrop>
__global__ void __launch_bounds__(128)
attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ o,
                           const bf16* __restrict__ go, const float* __restrict__ lse,
                           float* __restrict__ delta, bf16* __restrict__ dq, int Tq, int Tk,
                           float scale, const int64_t* __restrict__ seed_ptr, uint32_t thr,
                           float inv_keep) {
  __shared__ __align__(128) bf16 ks[kStages][kTileElems];
  __shared__ __align__(128) bf16 vs[kStages][kTileElems];
  const int bh = blockIdx.y, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kTile + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const bf16* kb = k + (int64_t)bh * Tk * kHeadDim;
  const bf16* vb = v + (int64_t)bh * Tk * kHeadDim;
  const int64_t qoff = (int64_t)bh * Tq * kHeadDim;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
  const float sl = scale * kLog2e;
  const int nt = (Tk + kTile - 1) / kTile;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) {
      load_tile(ks[t], kb, t * kTile, min(kTile, Tk - t * kTile));
      load_tile(vs[t], vb, t * kTile, min(kTile, Tk - t * kTile));
    }
    cp_async_commit();
  }
  uint32_t qa[2][4], ga[2][4], oa[2][4];
  load_a(qa, q + qoff, r, Tq, lane);
  load_a(ga, go + qoff, r, Tq, lane);
  load_a(oa, o + qoff, r, Tq, lane);
  float dl[2] = {0.f, 0.f}, ls[2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // fragment j holds 2 columns of row r + 8 * (j & 1)
    const float2 a = unpack_bf16(ga[j >> 2][j & 3]), b = unpack_bf16(oa[j >> 2][j & 3]);
    dl[j & 1] = fmaf(a.x, b.x, fmaf(a.y, b.y, dl[j & 1]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dl[h] += __shfl_xor_sync(kFullMask, dl[h], 1);
    dl[h] += __shfl_xor_sync(kFullMask, dl[h], 2);
    const int row = r + 8 * h;
    ls[h] = row < Tq ? lse[(int64_t)bh * Tq + row] * kLog2e : 0.f;
    if (row < Tq && (lane & 3) == 0) delta[(int64_t)bh * Tq + row] = dl[h];
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    tile_arrived();
    const int tn = t + kStages - 1;
    if (tn < nt) {
      load_tile(ks[tn % kStages], kb, tn * kTile, min(kTile, Tk - tn * kTile));
      load_tile(vs[tn % kStages], vb, tn * kTile, min(kTile, Tk - tn * kTile));
    }
    cp_async_commit();
    const bf16* kt = ks[t % kStages];
    const bf16* vt = vs[t % kStages];
    const int k0 = t * kTile;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    mma_n64(s, qa[0], desc_kmaj(kt, 0));
    mma_n64(s, qa[1], desc_kmaj(kt, 1));
    mma_n64(dp, ga[0], desc_kmaj(vt, 0));
    mma_n64(dp, ga[1], desc_kmaj(vt, 1));
    wg_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    uint32_t word[2] = {0u, 0u};
    if (kDrop) keep_rows(word, seed, bh, r, k0, thr, lane);
    const bool ragged = k0 + kTile > Tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool in = !ragged || k0 + col(i, lane) < Tk;
      const float p = in ? exp2f(s[i] * sl - ls[hf(i)]) : 0.f;
      const float dpd = (!kDrop || kept_rows(word, i, lane)) ? dp[i] * (kDrop ? inv_keep : 1.f)
                                                             : 0.f;
      s[i] = p * (dpd - dl[hf(i)]);  // dS
    }
    uint32_t sa[4][4];
    acc_to_a(sa, s);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_n32t(acc, sa[kk], desc_mn(kt, kk));
    wg_commit_wait();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row < Tq) {
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
        *reinterpret_cast<uint32_t*>(dq + qoff + (int64_t)row * kHeadDim + 8 * jb +
                                     2 * (lane & 3)) =
            pack_bf16(acc[4 * jb + 2 * h] * scale, acc[4 * jb + 2 * h + 1] * scale);
    }
  }
}

// Backward, dk and dv, on the transposed tiles.  Grid (ceil(Tk / 64), BH).
template <bool kDrop>
__global__ void __launch_bounds__(128)
attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ go,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                            float scale, const int64_t* __restrict__ seed_ptr, uint32_t thr,
                            float inv_keep) {
  __shared__ __align__(128) bf16 qs[kStages][kTileElems];
  __shared__ __align__(128) bf16 gs[kStages][kTileElems];
  __shared__ float lds[kStages][2 * kTile];  // lse, then delta, of the tile's queries
  const int bh = blockIdx.y, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kTile + (threadIdx.x >> 5) * 16 + (lane >> 2);  // key rows
  const bf16* qb = q + (int64_t)bh * Tq * kHeadDim;
  const bf16* gb = go + (int64_t)bh * Tq * kHeadDim;
  const float* lb = (threadIdx.x < kTile ? lse : delta) + (int64_t)bh * Tq;
  const int64_t koff = (int64_t)bh * Tk * kHeadDim;
  const uint32_t seed = kDrop ? (uint32_t)*seed_ptr : 0u;
  const float sl = scale * kLog2e;
  const int nt = (Tq + kTile - 1) / kTile;
  auto load = [&](int t) {
    const int st = t % kStages, q0 = t * kTile, n = min(kTile, Tq - q0);
    load_tile(qs[st], qb, q0, n);
    load_tile(gs[st], gb, q0, n);
    const int c = threadIdx.x & (kTile - 1);
    cp_async4(smem_u32(&lds[st][threadIdx.x]), lb + (c < n ? q0 + c : 0), c < n ? 4 : 0);
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) load(t);
    cp_async_commit();
  }
  uint32_t ka[2][4], va[2][4];
  load_a(ka, k + koff, r, Tk, lane);
  load_a(va, v + koff, r, Tk, lane);
  float dka[16], dva[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dka[i] = dva[i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    tile_arrived();
    if (t + kStages - 1 < nt) load(t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages, q0 = t * kTile;
    const bf16* qt = qs[st];
    const bf16* gt = gs[st];

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    mma_n64(s, ka[0], desc_kmaj(qt, 0));  // S^T = K Q^T
    mma_n64(s, ka[1], desc_kmaj(qt, 1));
    mma_n64(dp, va[0], desc_kmaj(gt, 0));  // dP^T = V dO^T
    mma_n64(dp, va[1], desc_kmaj(gt, 1));
    wg_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    uint32_t word[4] = {0u, 0u, 0u, 0u};
    if (kDrop) keep_cols(word, seed, bh, r, q0, thr, lane);
    const bool ragged = q0 + kTile > Tq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = col(i, lane);
      const bool in = !ragged || q0 + c < Tq;
      const float p = in ? exp2f(s[i] * sl - lds[st][c] * kLog2e) : 0.f;
      const bool kept = !kDrop || kept_cols(word, i, lane);
      const float dpd = kept ? dp[i] * (kDrop ? inv_keep : 1.f) : 0.f;
      s[i] = kept ? p : 0.f;                   // Pd^T without 1 / (1 - p)
      dp[i] = p * (dpd - lds[st][kTile + c]);  // dS^T
    }
    uint32_t pa[4][4], sa[4][4];
    acc_to_a(pa, s);
    acc_to_a(sa, dp);
    fence_regs(dva);
    fence_regs(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_n32t(dva, pa[kk], desc_mn(gt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_n32t(dka, sa[kk], desc_mn(qt, kk));
    wg_commit_wait();
    fence_regs(dva);
    fence_regs(dka);
  }

  const float fv = kDrop ? inv_keep : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row < Tk) {
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const int64_t i = koff + (int64_t)row * kHeadDim + 8 * jb + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(dk + i) =
            pack_bf16(dka[4 * jb + 2 * h] * scale, dka[4 * jb + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + i) =
            pack_bf16(dva[4 * jb + 2 * h] * fv, dva[4 * jb + 2 * h + 1] * fv);
      }
    }
  }
}

inline float inv_keep_of(uint32_t thr) {
  return thr == 0u ? 1.f : (float)(1.0 / (1.0 - (double)thr / 4294967296.0));
}

// The instantiations without dropout carry no mask code.
void launch_fwd_f32(cudaStream_t st, const float* q, const float* k, const float* v, float* o,
                    float* lse, int BH, int Tq, int Tk, float scale, const int64_t* seed,
                    uint32_t thr, float ik) {
  const dim3 grid((Tq + kRows - 1) / kRows, BH);
  if (thr != 0u)
    attention_fwd_kernel<float, true><<<grid, kRows, 0, st>>>(q, k, v, o, lse, Tq, Tk, scale,
                                                              seed, thr, ik);
  else
    attention_fwd_kernel<float, false><<<grid, kRows, 0, st>>>(q, k, v, o, lse, Tq, Tk, scale,
                                                               seed, thr, ik);
}

void launch_fwd_bf16(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, bf16* o,
                     float* lse, int BH, int Tq, int Tk, float scale, const int64_t* seed,
                     uint32_t thr, float ik) {
  const dim3 grid((Tq + kTile - 1) / kTile, BH);
  if (thr != 0u)
    attention_fwd_tc_kernel<true><<<grid, 128, 0, st>>>(q, k, v, o, lse, Tq, Tk, scale, seed,
                                                        thr, ik);
  else
    attention_fwd_tc_kernel<false><<<grid, 128, 0, st>>>(q, k, v, o, lse, Tq, Tk, scale, seed,
                                                         thr, ik);
}

template <bool kDrop>
void launch_bwd_f32(cudaStream_t st, const float* q, const float* k, const float* v,
                    const float* o, const float* go, const float* lse, float* delta, float* dq,
                    float* dk, float* dv, int BH, int Tq, int Tk, float scale,
                    const int64_t* seed, uint32_t thr, float ik) {
  attention_bwd_dq_kernel<float, kDrop><<<dim3((Tq + kRows - 1) / kRows, BH), kRows, 0, st>>>(
      q, k, v, o, go, lse, delta, dq, Tq, Tk, scale, seed, thr, ik);
  attention_bwd_dkv_kernel<float, kDrop><<<dim3((Tk + kRows - 1) / kRows, BH), kRows, 0, st>>>(
      q, k, v, go, lse, delta, dk, dv, Tq, Tk, scale, seed, thr, ik);
}

template <bool kDrop>
void launch_bwd_bf16(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v,
                     const bf16* o, const bf16* go, const float* lse, float* delta, bf16* dq,
                     bf16* dk, bf16* dv, int BH, int Tq, int Tk, float scale,
                     const int64_t* seed, uint32_t thr, float ik) {
  attention_bwd_dq_tc_kernel<kDrop><<<dim3((Tq + kTile - 1) / kTile, BH), 128, 0, st>>>(
      q, k, v, o, go, lse, delta, dq, Tq, Tk, scale, seed, thr, ik);
  attention_bwd_dkv_tc_kernel<kDrop><<<dim3((Tk + kTile - 1) / kTile, BH), 128, 0, st>>>(
      q, k, v, go, lse, delta, dk, dv, Tq, Tk, scale, seed, thr, ik);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* sp = static_cast<const int64_t*>(seed);
  float* l = static_cast<float*>(lse);
  const float ik = inv_keep_of(thr);
  if (dtype == kBF16) {
    if (!aligned16({q, k, v, o})) return (int)cudaErrorMisalignedAddress;
    launch_fwd_bf16(st, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), l, BH, Tq, Tk, scale, sp,
                    thr, ik);
  } else if (dtype == kF32) {
    launch_fwd_f32(st, static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(o), l, BH, Tq, Tk, scale,
                   sp, thr, ik);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* sp = static_cast<const int64_t*>(seed);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float ik = inv_keep_of(thr);
  if (dtype == kBF16) {
    if (!aligned16({q, k, v, o, go, dq, dk, dv})) return (int)cudaErrorMisalignedAddress;
    auto b = [](void* x) { return static_cast<bf16*>(x); };
    (thr != 0u ? launch_bwd_bf16<true> : launch_bwd_bf16<false>)(
        st, b(q), b(k), b(v), b(o), b(go), l, dl, b(dq), b(dk), b(dv), BH, Tq, Tk, scale, sp, thr,
        ik);
  } else if (dtype == kF32) {
    auto f = [](void* x) { return static_cast<float*>(x); };
    (thr != 0u ? launch_bwd_f32<true> : launch_bwd_f32<false>)(
        st, f(q), f(k), f(v), f(o), f(go), l, dl, f(dq), f(dk), f(dv), BH, Tq, Tk, scale, sp, thr,
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
