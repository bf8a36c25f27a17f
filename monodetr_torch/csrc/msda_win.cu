// Windowed deformable attention for encoder grid queries: the two opt-in
// encoder kernels (msda_impl 'pallas' and 'sepwin'), forward and backward,
// and the backward of kernel 1 (msda_impl 'fused', the default).
//
// Kernel 5 (replaces monodetr_tpu/ops/msda_pallas.py:
// ms_deform_attn_pallas_packed, fwd _fwd_kernel, bwd _bwd_kernel).  Bilinear
// MSDA, zero padding, at pixel positions (fx, fy) that the caller has
// already clamped to each query's window, with given (softmaxed) weights.
// fx, fy and att are lane-packed [B, S, H*L*P] f32, lane = (l*H + h)*P + p
// (lv*32 + h*4 + p at H = 8, P = 4).  The backward writes gfx, gfy, gatt in
// the same layout, unmasked: the clamp lives outside, in autograd.  The
// kernels are exact at any position, however far outside the level
// (common.cuh:corners): the window only decides where the backward sums.
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
// Kernel 1's backward (replaces monodetr_tpu/ops/msda_enc_pallas.py:
// ms_deform_attn_enc_fused, bwd _bwd_kernel; its forward is msda.cu).  The
// same backward on kernel 1's raw operands, the offset and logit
// projections, in three passes.  (1) msda_enc_fused_bwd_weights_kernel, a
// quad per (b, q, h) as kernel 1's forward, softmaxes each head's logits
// with the forward's arithmetic (common.cuh:quad_softmax) into an f32
// scratch, and zeroes the f32 value gradient.  (2) The tile pass on
// EncSrc: the clamp to +-lim around the query's static centre and its
// strict mask are recomputed as kernel 1's forward computes them, and each
// weight's gradient replaces the weight.  (3)
// msda_enc_fused_bwd_softmax_kernel, a quad per (b, q, h): dlogits = att *
// (gatt - sum(att * gatt)), over the gradients of all levels, which four
// warps of the tile pass hold, and the value gradient rounded to bf16.  The
// softmax has its own pass because inside the tile pass it sits on each
// warp's critical path; at batch 16 on an H100 SXM at 700 W the tile pass
// takes 2.02 ms (kernel 6's whole backward: 2.02), passes (1) and (3) 0.10
// and 0.14 ms (chip_smoke.py).
//
// All three are kernel 1's function from other operands and share its quad
// core (common.cuh): four threads per unit of work, thread s owning
// channels 8s .. 8s + 7, every corner one 16-byte load per thread (bf16; two
// in f32).  They differ only in their prologue (PackedSrc, LocSrc, EncSrc
// below); P is 4, so the 4 points of one (query, head, level) are one
// vector of each operand.
//   Forward: a quad per (b, q, h), 64 quads a block (8 consecutive queries
// x 8 heads); thread s reads level s's 4 points; common.cuh:quad_sample_sum.
//   Backward: what bounded the first version was the value gradient, one
// f32 atomic per corner and channel into device memory (2.7 G a launch at
// batch 16).  Now a block is 2 heads of one tile, a region of the image in
// every level (8 x 8 pixels of the finest level and the 4 x 4, 2 x 2 and 1
// of the coarser ones over them: 85 queries), a quad works on one (b, q, h,
// level), and warp (head, level) sums the tile's value gradient for that
// level in shared memory, with no atomics, before each row goes to device
// memory once (common.cuh: WinPlan, win_add, win_flush): 350 rows per head
// for 5440 corner adds.  The tiling is the host's
// (ops/msda_windowed.py:window_tiles): which queries a tile holds and where
// its rectangles start the kernels read from its per-tile table.  The
// weight and position gradients are the four dots of the output gradient
// with the corner rows, 8 channels a thread and 2 quad shuffles each
// (quad_sample_dots).  The TPU kernels used the same
// locality for strip DMAs; their hat functions and matmuls are not carried
// over: they existed because TPU gathers are slow.
//   What bounds them on the H100: the forward, the L1/L2 gather path, as
// kernel 1.  The backward, instruction issue: ~2,000 instructions per warp
// and 8 queries, a fifth of them the shared-memory read-modify-write of
// every corner row channel by channel (the 32 threads of a step must touch
// 32 different addresses, so the accesses cannot be vectors), most of the
// rest integer, predicate and bf16-unpack work around 128 multiply-adds of
// dots; then the rows' vector atomics (43 M a launch at batch 16).
#include "common.cuh"

namespace mdt {

constexpr int kWinQuads = 64;
constexpr int kWinThreads = 4 * kWinQuads;
// The kernels fix H = 8 (the lane packing of kernel 5; ops/msda_pallas.py:
// check_contract; kernels 1 and 6 refuse other head counts), so a token
// row is 256 elements, a compile-time stride: a corner's neighbour is an
// immediate offset of its load.
constexpr int kWinHeads = 8;
constexpr int kWinRow = kWinHeads * 32;

// common.cuh:grid_centre in f32: pixel g of a level whose pixels are s
// pixels of the sampled level, (g + 0.5) * s - 0.5.  Where the level ratios
// are powers of two (kernels 5 and 6: the wrappers' contract), s and every
// step are exact, and the result is the f64 formula rounded once.
__device__ __forceinline__ float2 win_centre(const GridPos& g, float sx, float sy) {
  return make_float2(((float)g.gx + 0.5f) * sx - 0.5f, ((float)g.gy + 0.5f) * sy - 0.5f);
}

// Kernel 5's operands.  fetch: the 4 points of (row bq, head h, level l),
// lanes (l*H + h)*4 .. + 3, one float4 of each of att, fx, fy, as loaded;
// decode hands them out, and every position counts as free (the caller's
// clamp masks the gradient).
struct PackedSrc {
  static constexpr bool kGrid = false;  // decode does not use the query's pixel
  const float *fx, *fy, *att;
  float *gfx, *gfy, *gatt;
  int H, L;
  struct Raw {
    float4 a, x, y;
  };

  __device__ __forceinline__ int64_t index(int64_t bq, int h, int l) const {
    return (bq * L + l) * H * 4 + h * 4;
  }
  __device__ __forceinline__ Raw fetch(int64_t bq, int h, int l) const {
    const int64_t i = index(bq, h, l);
    return Raw{__ldg(reinterpret_cast<const float4*>(att + i)),
               __ldg(reinterpret_cast<const float4*>(fx + i)),
               __ldg(reinterpret_cast<const float4*>(fy + i))};
  }
  __device__ __forceinline__ float2 centre(const GridPos&, float, float, const Levels&,
                                           int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ unsigned decode(const Raw& r, int, float2, const Levels&, float,
                                             float (&a)[4], float (&x)[4],
                                             float (&y)[4]) const {
    a[0] = r.a.x, a[1] = r.a.y, a[2] = r.a.z, a[3] = r.a.w;
    x[0] = r.x.x, x[1] = r.x.y, x[2] = r.x.z, x[3] = r.x.w;
    y[0] = r.y.x, y[1] = r.y.y, y[2] = r.y.z, y[3] = r.y.w;
    return 0xFFu;
  }
  // Point p's gradients, from the thread that holds them.
  __device__ __forceinline__ void store(int64_t bq, int h, int l, int p, const Levels&, float ga,
                                        float gx, float gy, unsigned) const {
    const int64_t i = index(bq, h, l) + p;
    gatt[i] = ga;
    gfx[i] = gx;
    gfy[i] = gy;
  }
};

// Kernel 6's operands.  fetch: the weights and normalised locations of the
// 4 points of (row bq, head h, level l), as loaded.  decode: weight, and
// the pixel position loc * (w, h) - 0.5 clamped to [c - lim, c + lim], c
// the query's centre in level l (win_centre; bounds rounded to f32 as the
// plain version's tables are); bit u
// (4 + u) of the result says whether point u's x (y) lay strictly inside
// the bounds.  store masks dloc by those bits and scales it by (w, h).
struct LocSrc {
  static constexpr bool kGrid = true;
  const float *loc, *attn;
  float *gloc, *gattn;
  int H, L;
  struct Raw {
    float4 a, p01, p23;
  };

  __device__ __forceinline__ int64_t index(int64_t bq, int h, int l) const {
    return ((bq * H + h) * L + l) * 4;
  }
  __device__ __forceinline__ Raw fetch(int64_t bq, int h, int l) const {
    const int64_t i = index(bq, h, l);
    return Raw{__ldg(reinterpret_cast<const float4*>(attn + i)),
               __ldg(reinterpret_cast<const float4*>(loc + 2 * i)),
               __ldg(reinterpret_cast<const float4*>(loc + 2 * i) + 1)};
  }
  __device__ __forceinline__ float2 centre(const GridPos& gp, float sx, float sy, const Levels&,
                                           int) const {
    return win_centre(gp, sx, sy);
  }
  __device__ __forceinline__ unsigned decode(const Raw& r, int l, float2 c, const Levels& lv,
                                             float lim, float (&a)[4], float (&x)[4],
                                             float (&y)[4]) const {
    a[0] = r.a.x, a[1] = r.a.y, a[2] = r.a.z, a[3] = r.a.w;
    const float w = (float)lv.w[l], h_ = (float)lv.h[l];
    const float rx[4] = {r.p01.x * w - 0.5f, r.p01.z * w - 0.5f, r.p23.x * w - 0.5f,
                         r.p23.z * w - 0.5f};
    const float ry[4] = {r.p01.y * h_ - 0.5f, r.p01.w * h_ - 0.5f, r.p23.y * h_ - 0.5f,
                         r.p23.w * h_ - 0.5f};
    const float lox = c.x - lim, hix = c.x + lim, loy = c.y - lim, hiy = c.y + lim;
    unsigned free = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = fminf(fmaxf(rx[u], lox), hix);
      y[u] = fminf(fmaxf(ry[u], loy), hiy);
      free |= (unsigned)(rx[u] > lox && rx[u] < hix) << u |
              (unsigned)(ry[u] > loy && ry[u] < hiy) << (4 + u);
    }
    return free;
  }
  __device__ __forceinline__ void store(int64_t bq, int h, int l, int p, const Levels& lv,
                                        float ga, float gx, float gy, unsigned free) const {
    const int64_t i = index(bq, h, l) + p;
    gattn[i] = ga;
    reinterpret_cast<float2*>(gloc)[i] = make_float2(
        (free >> p) & 1u ? gx * lv.w[l] : 0.f, (free >> (4 + p)) & 1u ? gy * lv.h[l] : 0.f);
  }
};

// Kernel 1's operands (msda.cu): off [B, S, 2*H*L*4] ([x-block | y-block],
// (h, l, p) order) in the input dtype, offsets in pixels of the sampled
// level, and w [B, S, H*L*4] f32, the softmaxed weights that
// msda_enc_fused_bwd_weights_kernel wrote (the bits of kernel 1's
// forward).  fetch: the 4 weights and the x and y offsets of level l's
// points.  decode: the position centre + clip(offset, -lim, lim), the
// centre kernel 1's forward's (common.cuh:grid_centre, rounded once from
// f64); bit u (4 + u) of the result says whether |x (y) offset| < lim
// (msda_enc_pallas.py:471).  store: the weight gradient over its weight in
// w, for the softmax kernel (only this quad reads the element, before its
// thread p writes it: win_add's __syncwarp orders them); doff, 0 where the
// offset was clamped.
template <typename T>
struct EncSrc {
  const T* off;
  float* w;
  T* goff;
  int H, L;
  bool vec;  // every 4 offsets one aligned vector (common.cuh:enc_vec)
  struct Raw {
    float4 a;
    float x[4], y[4];
  };

  __device__ __forceinline__ Raw fetch(int64_t bq, int h, int l) const {
    const int LP = L * 4;
    const int64_t nlog = (int64_t)H * LP;
    Raw r;
    r.a = *reinterpret_cast<const float4*>(w + bq * nlog + h * LP + 4 * l);
    const T* o = off + bq * 2 * nlog + h * LP + 4 * l;
    load4(o, r.x, 4, vec);
    load4(o + nlog, r.y, 4, vec);
    return r;
  }
  __device__ __forceinline__ float2 centre(const GridPos& gp, float, float, const Levels& lv,
                                           int l) const {
    return grid_centre(gp, lv, l);
  }
  __device__ __forceinline__ unsigned decode(const Raw& r, int, float2 c, const Levels&, float lim,
                                             float (&a)[4], float (&x)[4],
                                             float (&y)[4]) const {
    a[0] = r.a.x, a[1] = r.a.y, a[2] = r.a.z, a[3] = r.a.w;
    unsigned free = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = c.x + fminf(fmaxf(r.x[u], -lim), lim);
      y[u] = c.y + fminf(fmaxf(r.y[u], -lim), lim);
      free |= (unsigned)(fabsf(r.x[u]) < lim) << u | (unsigned)(fabsf(r.y[u]) < lim) << (4 + u);
    }
    return free;
  }
  __device__ __forceinline__ void store(int64_t bq, int h, int l, int p, const Levels&, float ga,
                                        float gx, float gy, unsigned free) const {
    const int LP = L * 4;
    const int64_t nlog = (int64_t)H * LP;
    w[bq * nlog + h * LP + 4 * l + p] = ga;
    T* o = goff + bq * 2 * nlog + h * LP + 4 * l + p;
    o[0] = from_f32<T>((free >> p) & 1u ? gx : 0.f);
    o[nlog] = from_f32<T>((free >> (4 + p)) & 1u ? gy : 0.f);
  }
};

// The forward of kernels 5 and 6: a quad per (b, q, h); thread s holds the 4
// points of level s, which are samples 4s .. 4s + 3 of quad_sample_sum.
template <typename T, typename Src>
__device__ __forceinline__ void win_forward(const T* __restrict__ value, T* __restrict__ out,
                                            const Src& src, int B, int S, int H,
                                            const Levels& lv, float lim) {
  const int64_t quad = ((int64_t)blockIdx.x * kWinThreads + threadIdx.x) >> 2;
  if (quad >= (int64_t)B * S * H) return;  // whole quads exit together
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const int h = (int)(quad % H);
  const int64_t bq = quad / H;  // b * S + q
  const int b = (int)(bq / S);
  float a[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
  if (sub < lv.n) {
    float2 c = make_float2(0.f, 0.f);
    if (Src::kGrid) {
      const GridPos gp = grid_pos((int)(bq % S), lv);
      c = win_centre(gp, (float)lv.w[sub] / (float)lv.w[gp.lq],
                     (float)lv.h[sub] / (float)lv.h[gp.lq]);
    }
    src.decode(src.fetch(bq, h, sub), sub, c, lv, lim, a, x, y);
  }
  constexpr int row = kWinRow;
  const T* vb = value + (int64_t)b * S * row + h * 32 + sub * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  quad_sample_sum(vb, row, lv, 4, a, x, y, lane, qmask, acc);
  store8(out + bq * row + h * 32 + sub * 8, acc);
}

// The backward of the three kernels.  The warp for (head, level l) of the block
// walks its tile's query slots 8 at a time, a quad per query: the quad's 4
// points are in level l; the next point's corner rows are loaded before
// the current point's value gradient is summed (win_add), so the loads are
// in flight during the shared-memory steps.  Thread s keeps point s's
// gradients and writes them.  Quads whose slot holds no query work on
// zeros and write nothing.
template <typename T, typename Src>
__device__ __forceinline__ void win_backward(const T* __restrict__ value,
                                             const T* __restrict__ gout,
                                             float* __restrict__ gvalue, const Src& src, int B,
                                             int S, int H, const Levels& lv, const WinPlan& plan,
                                             const WinTiles& tiles, float lim) {
  extern __shared__ float4 win_smem[];
  float* smem = reinterpret_cast<float*>(win_smem);
  const int lane = threadIdx.x & 31, quad = lane >> 2, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const WinWarp t = win_warp(smem, lv, plan, tiles, B, H);
  const int hl = lv.h[t.l], wl = lv.w[t.l];
  constexpr int row = kWinRow;
  // channel 0 of this head in token 0 of level l of the batch item
  const int64_t base = ((int64_t)t.b * S + lv.start[t.l]) * row + t.h * 32;
  const T* vb = value + base + sub * 8;
  float* gb = gvalue + base;
  win_zero(smem, t, lane);  // its __syncwarp also publishes the range row
  for (int p0 = 0; p0 < plan.queries; p0 += 8) {
    GridPos gp;
    float sx, sy;
    const bool active = win_query(smem, t, lv, plan, p0 + quad, gp, sx, sy);
    const int64_t bq = (int64_t)t.b * S + lv.start[gp.lq] + gp.gy * lv.w[gp.lq] + gp.gx;
    const T* gq = gout + bq * row + t.h * 32;  // this head's output gradient
    float a[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
    float g[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    unsigned free = 0u;
    if (active) {
      free = src.decode(src.fetch(bq, t.h, t.l), t.l, src.centre(gp, sx, sy, lv, t.l), lv, lim,
                        a, x, y);
      Row8<T> gr;
      gr.load(gq + sub * 8);
      gr.get(g);
    }
    win_keep_gradient(smem, t, g, lane);
    float oa = 0.f, ox = 0.f, oy = 0.f;
    Corners c = corners(x[0], y[0], hl, wl);
    Row8<T> v[4];
    load_corners(vb, row, c, v);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float pa, px, py;
      quad_sample_dots(v, g, c.lx, c.ly, qmask, pa, px, py);
      if (sub == p) {
        oa = pa;
        ox = a[p] * px;
        oy = a[p] * py;
      }
      const Corners cur = c;
      if (p + 1 < 4) {
        c = corners(x[p + 1], y[p + 1], hl, wl);
        load_corners(vb, row, c, v);
      }
      win_add(smem, t, cur, a[p], active && a[p] != 0.f, gq, gb, row, lane);
    }
    if (active) src.store(bq, t.h, t.l, sub, lv, oa, ox, oy, free);
  }
  win_flush(smem, t, lv, gvalue + base, row, lane);
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads, 3)
msda_pallas_kernel(const T* __restrict__ value, const float* __restrict__ fx,
                   const float* __restrict__ fy, const float* __restrict__ att,
                   T* __restrict__ out, int B, int S, int H, const __grid_constant__ Levels lv) {
  win_forward(value, out, PackedSrc{fx, fy, att, nullptr, nullptr, nullptr, H, lv.n}, B, S, H, lv,
              0.f);
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads, 2)
msda_pallas_bwd_kernel(const T* __restrict__ value, const float* __restrict__ fx,
                       const float* __restrict__ fy, const float* __restrict__ att,
                       const T* __restrict__ gout, float* __restrict__ gvalue,
                       float* __restrict__ gfx, float* __restrict__ gfy, float* __restrict__ gatt,
                       int B, int S, int H, const __grid_constant__ Levels lv,
                       const __grid_constant__ WinPlan plan, const int* __restrict__ tiles,
                       float lim) {
  win_backward(value, gout, gvalue, PackedSrc{fx, fy, att, gfx, gfy, gatt, H, lv.n}, B, S, H, lv,
               plan, WinTiles{tiles}, lim);
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads, 3)
msda_sepwin_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn, T* __restrict__ out, int B, int S, int H,
                   const __grid_constant__ Levels lv, float lim) {
  win_forward(value, out, LocSrc{loc, attn, nullptr, nullptr, H, lv.n}, B, S, H, lv, lim);
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads, 2)
msda_sepwin_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                       const float* __restrict__ attn, const T* __restrict__ gout,
                       float* __restrict__ gvalue, float* __restrict__ gloc,
                       float* __restrict__ gattn, int B, int S, int H,
                       const __grid_constant__ Levels lv, const __grid_constant__ WinPlan plan,
                       const int* __restrict__ tiles, float lim) {
  win_backward(value, gout, gvalue, LocSrc{loc, attn, gloc, gattn, H, lv.n}, B, S, H, lv, plan,
               WinTiles{tiles}, lim);
}

// Kernel 1's backward, first pass: the weights, a quad per (b, q, h), 64 a
// block, as kernel 1's forward; thread s softmaxes samples 4s .. 4s + 3
// with the head's (common.cuh:quad_softmax, the forward's bits) into w,
// and zeroes its 8 channels of the f32 value gradient's row (b, q, h).
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
msda_enc_fused_bwd_weights_kernel(const T* __restrict__ logits, float* __restrict__ w,
                                  float* __restrict__ gvalue, int64_t heads, int LP, bool vec) {
  const int64_t quad = ((int64_t)blockIdx.x * kWinThreads + threadIdx.x) >> 2;
  if (quad >= heads) return;  // whole quads exit together
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const int n = min(max(LP - 4 * sub, 0), 4);
  const int64_t i = quad * LP + 4 * sub;
  float att[4];
  load4(logits + i, att, n, vec);
  quad_softmax(att, n, 0xFu << (lane & ~3));
  if (n == 4)
    *reinterpret_cast<float4*>(w + i) = make_float4(att[0], att[1], att[2], att[3]);
  else
    store4(w + i, att, n);
  const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  store8(gvalue + quad * 32 + sub * 8, zero);
}

// Second pass: the tile sums (win_backward) on EncSrc.
template <typename T>
__global__ void __launch_bounds__(kWinThreads, 2)
msda_enc_fused_bwd_tiles_kernel(const T* __restrict__ value, const T* __restrict__ off,
                                const T* __restrict__ gout, float* __restrict__ gvalue,
                                float* __restrict__ w, T* __restrict__ goff, int B, int S, int H,
                                const __grid_constant__ Levels lv,
                                const __grid_constant__ WinPlan plan,
                                const int* __restrict__ tiles, float lim, bool vec) {
  win_backward(value, gout, gvalue, EncSrc<T>{off, w, goff, H, lv.n, vec}, B, S, H, lv,
               plan, WinTiles{tiles}, lim);
}

// Third pass, the softmax's backward: a quad per (b, q, h) as the first;
// thread s recomputes the weights of samples 4s .. 4s + 3 (the first pass's
// bits), reads their gradients from w and writes dlogits = att * (gatt -
// sum(att * gatt)), the sum over the head's samples by 2 quad shuffles;
// where dvalue is given (bf16), it rounds its 8 channels of the f32 value
// gradient's row (b, q, h) into it.
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
msda_enc_fused_bwd_softmax_kernel(const T* __restrict__ logits, const float* __restrict__ gatt,
                                  T* __restrict__ glogits, const float* __restrict__ gvalue,
                                  T* __restrict__ dvalue, int64_t heads, int LP, bool vec) {
  const int64_t quad = ((int64_t)blockIdx.x * kWinThreads + threadIdx.x) >> 2;
  if (quad >= heads) return;  // whole quads exit together
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const int n = min(max(LP - 4 * sub, 0), 4);
  const int64_t i = quad * LP + 4 * sub;
  float att[4], ga[4];
  load4(logits + i, att, n, vec);
  quad_softmax(att, n, qmask);
  load4(gatt + i, ga, n, true);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) s += att[u] * ga[u];  // att = 0 past n
  s += __shfl_xor_sync(qmask, s, 1);
  s += __shfl_xor_sync(qmask, s, 2);
  float gl[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) gl[u] = att[u] * (ga[u] - s);
  store4(glogits + i, gl, n);
  if (dvalue != nullptr) {
    Row8<float> g;
    g.load(gvalue + quad * 32 + sub * 8);
    float x[8];
    g.get(x);
    store8(dvalue + quad * 32 + sub * 8, x);
  }
}

// The quad layout needs D = 32 and P = 4 (a float4 of points); a forward
// thread holds one level, so L <= 4; H is the compile-time 8.
inline bool bad_shape(int S, int H, int D, int L, int P) {
  return H != kWinHeads || D != 32 || P != 4 || L < 1 || L > 4 || !fits_int32(S, H);
}

inline unsigned win_blocks(int64_t quads) {
  return (unsigned)((quads + kWinQuads - 1) / kWinQuads);
}

// The backward's launch shape for a plan: blocks, threads, shared bytes.
struct WinLaunch {
  unsigned grid, threads;
  size_t smem;
};

inline WinLaunch win_launch(const WinPlan& plan, int B, int H, int L) {
  return WinLaunch{(unsigned)((int64_t)plan.nx * plan.ny * B * (H / kWinBlockHeads)),
                   (unsigned)(kWinBlockHeads * L * 32), win_smem_bytes(plan, L)};
}

// Allows `kernel` its dynamic shared memory, then launches it.
template <typename K, typename... Args>
int launch_win_bwd(K kernel, const WinLaunch& w, cudaStream_t st, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w.smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<w.grid, w.threads, w.smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// Kernel 5.  value [B, S, H, 32] (dtype), fx, fy, att [B, S, H*L*P] f32
// (lane-packed), out [B, S, H*32] (dtype); hw: host int array
// (h0, w0, h1, w1, ...) of the L levels.
int mdt_msda_pallas(void* value, void* fx, void* fy, void* att, void* out, int dtype, int B,
                    int S, int H, int D, int L, int P, void* hw, void* stream) {
  if (bad_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, fx, fy, att, out})) return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = win_blocks((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(fx), *y = static_cast<const float*>(fy),
              *a = static_cast<const float*>(att);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_pallas_kernel<T><<<grid, kWinThreads, 0, st>>>(static_cast<const T*>(value), x, y, a,
                                                        static_cast<T*>(out), B, S, H, lv);
  } else if (dtype == kF32) {
    msda_pallas_kernel<float><<<grid, kWinThreads, 0, st>>>(
        static_cast<const float*>(value), x, y, a, static_cast<float*>(out), B, S, H, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 5 backward.  value, fx, fy, att as mdt_msda_pallas; gout
// [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller;
// gfx, gfy, gatt shaped as fx (f32); plan: the host's int table of the
// tiling (common.cuh:make_win_plan) for these levels and the window of
// `lim`; tiles: its per-tile table in device memory (common.cuh:WinTiles).
int mdt_msda_pallas_bwd(void* value, void* fx, void* fy, void* att, void* gout, void* gvalue,
                        void* gfx, void* gfy, void* gatt, int dtype, int B, int S, int H, int D,
                        int L, int P, void* hw, void* plan, void* tiles, float lim,
                        void* stream) {
  if (bad_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, fx, fy, att, gout, gvalue, gfx, gfy, gatt}))
    return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const WinPlan wp = make_win_plan(static_cast<const int*>(plan));
  const int* tl = static_cast<const int*>(tiles);
  if (!win_plan_ok(wp, L, H) || tl == nullptr) return (int)cudaErrorInvalidValue;
  const WinLaunch w = win_launch(wp, B, H, L);
  if (w.grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(fx), *y = static_cast<const float*>(fy),
              *a = static_cast<const float*>(att);
  float *gv = static_cast<float*>(gvalue), *gx = static_cast<float*>(gfx),
        *gy = static_cast<float*>(gfy), *ga = static_cast<float*>(gatt);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    return launch_win_bwd(msda_pallas_bwd_kernel<T>, w, st, static_cast<const T*>(value), x, y, a,
                          static_cast<const T*>(gout), gv, gx, gy, ga, B, S, H, lv, wp, tl, lim);
  }
  if (dtype == kF32)
    return launch_win_bwd(msda_pallas_bwd_kernel<float>, w, st, static_cast<const float*>(value),
                          x, y, a, static_cast<const float*>(gout), gv, gx, gy, ga, B, S, H, lv,
                          wp, tl, lim);
  return (int)cudaErrorInvalidValue;
}

// Kernel 6.  value [B, S, H, 32] (dtype), loc [B, S, H, L, P, 2] f32, attn
// [B, S, H, L, P] f32, out [B, S, H*32] (dtype); lim: the window's clamp.
int mdt_msda_sepwin(void* value, void* loc, void* attn, void* out, int dtype, int B, int S,
                    int H, int D, int L, int P, void* hw, float lim, void* stream) {
  if (bad_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, loc, attn, out})) return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const unsigned grid = win_blocks((int64_t)B * S * H);
  if (grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *a = static_cast<const float*>(attn);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    msda_sepwin_kernel<T><<<grid, kWinThreads, 0, st>>>(static_cast<const T*>(value), lc, a,
                                                        static_cast<T*>(out), B, S, H, lv, lim);
  } else if (dtype == kF32) {
    msda_sepwin_kernel<float><<<grid, kWinThreads, 0, st>>>(
        static_cast<const float*>(value), lc, a, static_cast<float*>(out), B, S, H, lv, lim);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel 6 backward.  value, loc, attn as mdt_msda_sepwin; gout
// [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller;
// gloc, gattn shaped as loc and attn (f32); plan and tiles as
// mdt_msda_pallas_bwd.
int mdt_msda_sepwin_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue,
                        void* gloc, void* gattn, int dtype, int B, int S, int H, int D, int L,
                        int P, void* hw, void* plan, void* tiles, float lim, void* stream) {
  if (bad_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, loc, attn, gout, gvalue, gloc, gattn}))
    return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const WinPlan wp = make_win_plan(static_cast<const int*>(plan));
  const int* tl = static_cast<const int*>(tiles);
  if (!win_plan_ok(wp, L, H) || tl == nullptr) return (int)cudaErrorInvalidValue;
  const WinLaunch w = win_launch(wp, B, H, L);
  if (w.grid == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *a = static_cast<const float*>(attn);
  float *gv = static_cast<float*>(gvalue), *gl = static_cast<float*>(gloc),
        *ga = static_cast<float*>(gattn);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    return launch_win_bwd(msda_sepwin_bwd_kernel<T>, w, st, static_cast<const T*>(value), lc, a,
                          static_cast<const T*>(gout), gv, gl, ga, B, S, H, lv, wp, tl, lim);
  }
  if (dtype == kF32)
    return launch_win_bwd(msda_sepwin_bwd_kernel<float>, w, st, static_cast<const float*>(value),
                          lc, a, static_cast<const float*>(gout), gv, gl, ga, B, S, H, lv, wp,
                          tl, lim);
  return (int)cudaErrorInvalidValue;
}

// Kernel 1 backward.  value, off, logits as msda.cu:mdt_msda_enc_fused, at
// H = 8 and P = 4; gout [B, S, H*32] (dtype); gvalue [B, S, H, 32] f32,
// scratch (the passes zero and sum it), and the value gradient itself in
// f32; dvalue: for bf16, the value gradient [B, S, H, 32] rounded from it;
// w [B, S, H*L*P] f32, scratch: the weights, then their gradients; goff,
// glogits shaped as off and logits (dtype); plan and tiles as
// mdt_msda_pallas_bwd.  Three launches: the weights (and the zeroing), the
// tile sums, the softmax's backward (and the rounding).
int mdt_msda_enc_fused_bwd_tiles(void* value, void* off, void* logits, void* gout, void* gvalue,
                                 void* dvalue, void* w, void* goff, void* glogits, int dtype,
                                 int B, int S, int H, int D, int L, int P, void* hw, void* plan,
                                 void* tiles, float lim, void* stream) {
  if (bad_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, gout, gvalue, w}) || (dtype == kBF16 && !aligned16({dvalue})))
    return (int)cudaErrorMisalignedAddress;
  if ((dtype == kBF16) != (dvalue != nullptr)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const WinPlan wp = make_win_plan(static_cast<const int*>(plan));
  const int* tl = static_cast<const int*>(tiles);
  if (!win_plan_ok(wp, L, H) || tl == nullptr) return (int)cudaErrorInvalidValue;
  const WinLaunch launch = win_launch(wp, B, H, L);
  if (launch.grid == 0) return 0;
  const bool vec = enc_vec(dtype, L * P, off, logits);
  const int64_t heads = (int64_t)B * S * H;
  float *wf = static_cast<float*>(w), *gv = static_cast<float*>(gvalue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const T* lg = static_cast<const T*>(logits);
    msda_enc_fused_bwd_weights_kernel<T><<<win_blocks(heads), kWinThreads, 0, st>>>(
        lg, wf, gv, heads, L * P, vec);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    rc = launch_win_bwd(msda_enc_fused_bwd_tiles_kernel<T>, launch, st,
                        static_cast<const T*>(value), static_cast<const T*>(off),
                        static_cast<const T*>(gout), gv, wf,
                        static_cast<T*>(goff), B, S, H, lv, wp, tl, lim, vec);
    if (rc != 0) return rc;
    msda_enc_fused_bwd_softmax_kernel<T><<<win_blocks(heads), kWinThreads, 0, st>>>(
        lg, wf, static_cast<T*>(glogits), gv, static_cast<T*>(dvalue), heads, L * P, vec);
    return (int)cudaGetLastError();
  };
  if (dtype == kBF16) return run(__nv_bfloat16{});
  if (dtype == kF32) return run(0.f);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of a backward's tile pass (kernel: 1, 5 or 6) an SM holds
// at the plan's launch shape, by cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// and the shared bytes a block asks for.
int mdt_msda_win_bwd_occupancy(int kernel, int dtype, int L, void* plan, int* blocks_per_sm,
                               int* smem_bytes) {
  const WinPlan wp = make_win_plan(static_cast<const int*>(plan));
  const int threads = kWinBlockHeads * L * 32;
  const size_t smem = win_smem_bytes(wp, L);
  *smem_bytes = (int)smem;
  auto ask = [&](auto k) {
    cudaError_t rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, threads, smem);
    return (int)rc;
  };
  if (kernel == 1 && dtype == kBF16) return ask(msda_enc_fused_bwd_tiles_kernel<__nv_bfloat16>);
  if (kernel == 1 && dtype == kF32) return ask(msda_enc_fused_bwd_tiles_kernel<float>);
  if (kernel == 5 && dtype == kBF16) return ask(msda_pallas_bwd_kernel<__nv_bfloat16>);
  if (kernel == 5 && dtype == kF32) return ask(msda_pallas_bwd_kernel<float>);
  if (kernel == 6 && dtype == kBF16) return ask(msda_sepwin_bwd_kernel<__nv_bfloat16>);
  if (kernel == 6 && dtype == kF32) return ask(msda_sepwin_bwd_kernel<float>);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
