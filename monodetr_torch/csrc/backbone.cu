// The backbone's epilogues for Hopper (sm_90a): the elementwise passes
// between the bottleneck blocks' cuDNN convolutions, forward and backward.
//
// Replaces no TPU kernel: XLA fuses these passes into the convolutions'
// epilogues on the TPU (monodetr_tpu/models/backbone.py: FoldedConv, relu,
// the residual add), while on this card cuDNN's convolution is followed by
// PyTorch's bias add, ReLU, residual add and their backwards, each a full
// read and write of the activation through the strided broadcast kernel.
// These three kernels do that work in one pass each (ops/backbone.py):
//
//   backbone_bias_relu_kernel        y = max(x + b[c], 0)               (a)
//   backbone_tail_kernel             y = max((o3 + b3[c]) + idn, 0)     (b)
//                                    (with bd: (o3 + b3[c]) + (idn + bd[c]))
//   backbone_accumulate_mask_kernel  g' = x > 0 ? ga + gb : 0           (d)
//                                    (without x: g' = ga + gb)
//
// Layout: NHWC memory (channels-last), C innermost, C a multiple of 8; the
// biases are f32 [C].  Arithmetic is f32 and each output is rounded once;
// in f32 every sum is taken in the order of PyTorch's passes (each
// convolution's bias add, then the residual add), so f32 results are
// PyTorch's bit for bit.
// Where (d) reads a mask value that is not positive (NaN included: not
// `<= 0`) it keeps or drops the gradient as PyTorch's threshold_backward
// does, and (a) and (b) pass a NaN through as clamp_min does.  (The lone
// ReLU masks of the backward stay PyTorch's threshold_backward, which is
// as fast as a kernel of their own.)
//
// What bounds them on the H100: bytes.  Each reads its inputs once and
// writes its output once (3.35 TB/s); there is no arithmetic to speak of.
// So every access is a 16-byte vector (8 bf16 or 4 f32), each thread keeps
// kEpiUnroll vectors of every input in flight before it computes, and the
// per-channel biases are read once per thread into registers: the grid's
// thread count is made a multiple of the vectors in a row of C channels, so
// a thread's grid-stride walk meets the same channels at every step.
#include "common.cuh"

namespace mdt {

constexpr int kEpiThreads = 256;
constexpr int kEpiUnroll = 2;

// One 16-byte vector of T, as loaded: kN elements.
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&x)[kN]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&x)[kN]) {
    store8(p, x);
  }
};
template <>
struct Pack<float> {
  static constexpr int kN = 4;
  float4 a;
  __device__ __forceinline__ void load(const float* p) { a = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ void get(float (&x)[kN]) const {
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&x)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

enum EpiOp : int { kBiasRelu, kTail, kTailDown, kAccumulate, kAccumulateMask };

// kN f32 values of a bias from c on.
template <int kN>
__device__ __forceinline__ void load_bias(const float* __restrict__ p, float (&b)[kN]) {
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    b[4 * i] = f.x, b[4 * i + 1] = f.y, b[4 * i + 2] = f.z, b[4 * i + 3] = f.w;
  }
}

// The pass over vectors t, t + stride, ... of `nvec` (stride: the grid's
// threads, a multiple of `cvec`, the vectors in a row of C channels).
// Inputs: a, b (kTail*, kAccumulate*), m (the mask's values:
// kAccumulateMask), bias (kBiasRelu, kTail*: added to a), bias2 (kTailDown:
// added to b).  `out` may be `a` or `b`, so none of the three is
// __restrict__ (each thread loads its elements before it stores them).
template <typename T, int kOp>
__device__ __forceinline__ void epilogue(const T* a, const T* b, const T* m,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ bias2, T* out, int64_t nvec,
                                         int cvec) {
  constexpr int N = Pack<T>::kN;
  constexpr bool kTails = kOp == kTail || kOp == kTailDown;
  constexpr bool kB = kTails || kOp == kAccumulate || kOp == kAccumulateMask;
  constexpr bool kM = kOp == kAccumulateMask;
  constexpr bool kBias = kOp == kBiasRelu || kTails;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float bv[N], bv2[N];
  if (kBias) load_bias(bias + (t % cvec) * N, bv);
  if (kOp == kTailDown) load_bias(bias2 + (t % cvec) * N, bv2);
  for (int64_t v0 = t; v0 < nvec; v0 += stride * kEpiUnroll) {
    Pack<T> pa[kEpiUnroll], pb[kEpiUnroll], pm[kEpiUnroll];
#pragma unroll
    for (int u = 0; u < kEpiUnroll; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) {
        pa[u].load(a + v * N);
        if (kB) pb[u].load(b + v * N);
        if (kM) pm[u].load(m + v * N);
      }
    }
#pragma unroll
    for (int u = 0; u < kEpiUnroll; ++u) {
      const int64_t v = v0 + u * stride;
      if (v < nvec) {
        float x[N], y[N], k[N];
        pa[u].get(x);
        if (kB) pb[u].get(y);
        if (kM) pm[u].get(k);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float s = x[i];
          if (kBias) s += bv[i];
          if (kOp == kTailDown) y[i] += bv2[i];
          if (kB) s += y[i];
          if (kBias) s = s <= 0.f ? 0.f : s;
          if (kM) s = k[i] <= 0.f ? 0.f : s;
          x[i] = s;
        }
        Pack<T>::store(out + v * N, x);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kEpiThreads)
    backbone_bias_relu_kernel(const T* x, const float* bias, T* out, int64_t nvec, int cvec) {
  epilogue<T, kBiasRelu>(x, nullptr, nullptr, bias, nullptr, out, nvec, cvec);
}

template <typename T, bool kDown>
__global__ void __launch_bounds__(kEpiThreads)
    backbone_tail_kernel(const T* o3, const T* idn, const float* b3, const float* bd, T* out,
                         int64_t nvec, int cvec) {
  epilogue<T, kDown ? kTailDown : kTail>(o3, idn, nullptr, b3, bd, out, nvec, cvec);
}

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kEpiThreads)
    backbone_accumulate_mask_kernel(const T* ga, const T* gb, const T* x, T* out, int64_t nvec) {
  epilogue<T, kMasked ? kAccumulateMask : kAccumulate>(ga, gb, x, nullptr, nullptr, out, nvec,
                                                       1);
}

inline int gcd_int(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// Blocks for `nvec` vectors: kEpiUnroll vectors a thread, rounded up so
// that the grid's threads are a multiple of `cvec`.  (Capping the grid at
// 8 blocks a multiprocessor, with a grid-stride walk and 4 vectors a
// thread, was 2-5% slower at r101x2's layer3 shapes; 8 vectors a thread
// 1-2%.)
inline unsigned epi_blocks(int64_t nvec, int cvec) {
  const int64_t per_block = (int64_t)kEpiThreads * kEpiUnroll;
  const int q = cvec / gcd_int(cvec, kEpiThreads);
  return (unsigned)(((nvec + per_block - 1) / per_block + q - 1) / q * q);
}

// The checks every entry point makes: a known dtype, n a whole number of
// rows of C channels, C a multiple of 8, 16-byte aligned pointers.
inline int epi_check(int dtype, long long n, int C, std::initializer_list<const void*> ps) {
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (n < 0 || C <= 0 || C % 8 != 0 || n % C != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(ps)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

inline int epi_vec(int dtype) { return dtype == kBF16 ? 8 : 4; }

template <typename T>
void launch_tail(const void* o3, const void* idn, const void* b3, const void* bd, void* out,
                 int64_t nvec, int cvec, cudaStream_t st) {
  const unsigned grid = epi_blocks(nvec, cvec);
  const T *a = static_cast<const T*>(o3), *b = static_cast<const T*>(idn);
  const float *c = static_cast<const float*>(b3), *d = static_cast<const float*>(bd);
  if (d)
    backbone_tail_kernel<T, true><<<grid, kEpiThreads, 0, st>>>(a, b, c, d, static_cast<T*>(out),
                                                                nvec, cvec);
  else
    backbone_tail_kernel<T, false><<<grid, kEpiThreads, 0, st>>>(a, b, c, d, static_cast<T*>(out),
                                                                 nvec, cvec);
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// x, out [n] (NHWC, C innermost; out may be x), bias [C] f32.
int mdt_backbone_bias_relu(void* x, void* bias, void* out, int dtype, long long n, int C,
                           void* stream) {
  if (const int rc = epi_check(dtype, n, C, {x, bias, out})) return rc;
  const int64_t nvec = n / epi_vec(dtype);
  if (nvec == 0) return 0;
  const int cvec = C / epi_vec(dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = epi_blocks(nvec, cvec);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    backbone_bias_relu_kernel<T><<<grid, kEpiThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(bias), static_cast<T*>(out), nvec,
        cvec);
  } else {
    backbone_bias_relu_kernel<float><<<grid, kEpiThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias), static_cast<float*>(out),
        nvec, cvec);
  }
  return (int)cudaGetLastError();
}

// o3, idn, out [n] (NHWC; out may be o3 or idn), b3 [C] f32, bd [C] f32 or
// null (no downsample).
int mdt_backbone_tail(void* o3, void* idn, void* b3, void* bd, void* out, int dtype, long long n,
                      int C, void* stream) {
  if (const int rc = epi_check(dtype, n, C, {o3, idn, b3, bd, out})) return rc;
  const int64_t nvec = n / epi_vec(dtype);
  if (nvec == 0) return 0;
  const int cvec = C / epi_vec(dtype);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_tail<__nv_bfloat16>(o3, idn, b3, bd, out, nvec, cvec, st);
  else
    launch_tail<float>(o3, idn, b3, bd, out, nvec, cvec, st);
  return (int)cudaGetLastError();
}

// ga, gb, out [n] (out may be ga or gb), x [n] or null (no mask).
int mdt_backbone_accumulate_mask(void* ga, void* gb, void* x, void* out, int dtype, long long n,
                                 int C, void* stream) {
  if (const int rc = epi_check(dtype, n, C, {ga, gb, x, out})) return rc;
  const int64_t nvec = n / epi_vec(dtype);
  if (nvec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = epi_blocks(nvec, 1);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    const T *a = static_cast<const T*>(ga), *b = static_cast<const T*>(gb),
            *m = static_cast<const T*>(x);
    if (m)
      backbone_accumulate_mask_kernel<T, true><<<grid, kEpiThreads, 0, st>>>(
          a, b, m, static_cast<T*>(out), nvec);
    else
      backbone_accumulate_mask_kernel<T, false><<<grid, kEpiThreads, 0, st>>>(
          a, b, m, static_cast<T*>(out), nvec);
  } else {
    const float *a = static_cast<const float*>(ga), *b = static_cast<const float*>(gb),
                *m = static_cast<const float*>(x);
    if (m)
      backbone_accumulate_mask_kernel<float, true><<<grid, kEpiThreads, 0, st>>>(
          a, b, m, static_cast<float*>(out), nvec);
    else
      backbone_accumulate_mask_kernel<float, false><<<grid, kEpiThreads, 0, st>>>(
          a, b, m, static_cast<float*>(out), nvec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
