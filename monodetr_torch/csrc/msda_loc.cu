// Exact multi-scale deformable attention from sampling locations, for
// Hopper (sm_90a), forward and backward: the decoder's cross-attention.
//
// Kernel 2 (replaces monodetr_tpu/ops/msda_sep_pallas.py:
// ms_deform_attn_sep, _fwd_kernel and _bwd_kernel).  For value [B, S, H, 32],
// f32 loc [B, Q, H, L, P, 2] and attn [B, Q, H, L, P]: the sum over the L*P
// samples of attn x bilinear(value, loc * (w, h) - 0.5), zero padding.
//
// Kernel 7 (replaces monodetr_tpu/ops/msda_dense_pallas.py:
// ms_deform_attn_dense_fused).  Kernel 2's function; what sets it apart is
// its backward, which scatters nothing: every row of the value gradient is
// written once, with every sum in a fixed order, so dvalue is the same bits
// from run to run.
//
// What bounds them on the H100 is not bytes (0.03-0.06 ms of traffic) but
// the gather's instructions and latency, and in the backward the adds into
// the value gradient.  The design:
//   Forward of both, and dloc / dattn of both backwards: the quad core of
// common.cuh, as kernels 1, 5 and 6: four threads per (b, q, h), 8 channels
// a thread, one 16-byte load per corner (bf16), 32-bit token offsets.
// Thread s of the quad reads its 4 samples' locations as two float4s and
// their weights as one (the 2 * L * P location floats of a (b, q, h) are
// contiguous), and writes dloc / dattn of those samples the same way;
// L*P > 16 takes a second round of 16 samples.  Decoder queries are no
// grid, so there is no window to stage.  A block is 32 quads (4 queries x
// 8 heads): 50 eval queries at batch 16 are still 200 blocks.
//   Kernel 2's dvalue: f32 vector atomics, atomicAdd(float4*), 2 per
// thread and corner that carries weight, into a zeroed f32 buffer (36 M a
// launch at 550 queries, batch 16, where one warp per (b, q, h) made 144 M
// scalar ones).
//   Kernel 7's dvalue: the samples are binned first.  The host's plan
// (ops/msda_dense.py:value_bins) cuts every level into tiles of tw x th
// pixels.  msda_dense_fused_bwd_bin_kernel, one block per (b, h, level),
// writes one entry per (sample, tile it touches): the four corner weights
// that fall in the tile (attention weight folded in, 0 elsewhere), the
// query, and the tile-local row of corner (x0, y0); a counting sort in
// shared memory whose order is a fixed function of the sample index puts
// the entries of a tile together.  msda_dense_fused_bwd_value_kernel then
// runs one block per (tile, b), warp = head: a warp walks its own list in
// order, lane d adding weight x g[q, d] to the tile's rows in shared memory
// (no other thread touches them), and writes the tile's rows once.  No
// atomics on device memory, no CTA reads a sample that cannot touch its
// rows.
//   Token offsets within a batch item are 32-bit, as in kernels 1, 5 and
// 6: the host refuses a batch item whose S * H * 64 elements pass INT32_MAX
// (common.cuh:fits_int32, ops/msda_sep.py:check_loc_shape).  Every kernel
// takes its corners from common.cuh:corners, which clamps floor(x, y) to
// [-2, w] x [-2, h]: any position, NaN and beyond int32 included, is
// defined.
#include "common.cuh"

namespace mdt {

constexpr int kLocQuads = 32;
constexpr int kLocThreads = 4 * kLocQuads;
constexpr int kMaxSamples = 32;  // L * P, ops/msda_sep.py:MAX_SAMPLES

// Thread s of the quad of (b, q, h), in the round that starts at sample
// j0: samples j = j0 + 4s + u (u < n), their weight and pixel position.
struct LocQuad {
  int n;
  float att[4], fx[4], fy[4];
};

__device__ __forceinline__ LocQuad loc_quad(const float* __restrict__ loc,
                                            const float* __restrict__ attn, int64_t quad,
                                            const Levels& lv, int P, int j0, int sub, bool vec) {
  const int LP = lv.n * P;
  const int j = j0 + 4 * sub;
  LocQuad e;
  e.n = min(max(LP - j, 0), 4);
  const int64_t i = quad * LP + j;  // [B, Q, H, L, P] index of the first sample
  float x[4], y[4];
  if (vec && e.n == 4) {
    const float4 a = *reinterpret_cast<const float4*>(attn + i);
    const float4 p0 = *reinterpret_cast<const float4*>(loc + 2 * i);
    const float4 p1 = *reinterpret_cast<const float4*>(loc + 2 * i + 4);
    e.att[0] = a.x, e.att[1] = a.y, e.att[2] = a.z, e.att[3] = a.w;
    x[0] = p0.x, y[0] = p0.y, x[1] = p0.z, y[1] = p0.w;
    x[2] = p1.x, y[2] = p1.y, x[3] = p1.z, y[3] = p1.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      e.att[u] = u < e.n ? attn[i + u] : 0.f;
      x[u] = u < e.n ? loc[2 * (i + u)] : 0.f;
      y[u] = u < e.n ? loc[2 * (i + u) + 1] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int l = min((j + u) / P, lv.n - 1);
    e.fx[u] = x[u] * lv.w[l] - 0.5f;
    e.fy[u] = y[u] * lv.h[l] - 0.5f;
  }
  return e;
}

// The forward of kernels 2 and 7, a quad per (b, q, h).
template <typename T>
__device__ __forceinline__ void loc_forward_quad(const T* __restrict__ value,
                                                 const float* __restrict__ loc,
                                                 const float* __restrict__ attn,
                                                 T* __restrict__ out, int B, int S, int Q, int H,
                                                 const Levels& lv, int P, bool vec) {
  const int64_t quad = ((int64_t)blockIdx.x * kLocThreads + threadIdx.x) >> 2;
  if (quad >= (int64_t)B * Q * H) return;  // whole quads exit together
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const int h = (int)(quad % H);
  const int64_t bq = quad / H;  // b * Q + q
  const int b = (int)(bq / Q);
  const int row = H * 32;
  const T* vb = value + (int64_t)b * S * row + h * 32 + sub * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int LP = lv.n * P;
  for (int j0 = 0; j0 < LP; j0 += 16) {
    const LocQuad e = loc_quad(loc, attn, quad, lv, P, j0, sub, vec);
    quad_sample_sum(vb, row, lv, P, e.att, e.fx, e.fy, lane, qmask, acc, j0);
  }
  store8(out + bq * row + h * 32 + sub * 8, acc);
}

template <typename T>
__global__ void __launch_bounds__(kLocThreads, 6)
msda_sep_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q, int H,
                const __grid_constant__ Levels lv, int P, bool vec) {
  loc_forward_quad(value, loc, attn, out, B, S, Q, H, lv, P, vec);
}

// Kernel 7's forward: kernel 2's, under its own name for the profiler.
template <typename T>
__global__ void __launch_bounds__(kLocThreads, 6)
msda_dense_fused_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                        const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q,
                        int H, const __grid_constant__ Levels lv, int P, bool vec) {
  loc_forward_quad(value, loc, attn, out, B, S, Q, H, lv, P, vec);
}

// Kernel 2 backward (replaces msda_sep_pallas.py _bwd_kernel), and with
// gvalue null the query side of kernel 7's.  Same quad layout.  dattn =
// <g, sample> and dloc = attn * <g, d sample / d(x, y)> * (w, h) come from
// common.cuh:quad_sample_dots (8-channel partial dots, 2 quad shuffles
// each); the thread that read a sample keeps its three numbers and writes
// its 4 samples' dattn as one float4 and dloc as two.  dvalue goes to the
// f32 gvalue (zeroed by the caller) by vector atomics: a corner's scalar
// weight is the same in the whole quad, so thread s adds to channels
// 4s .. 4s + 3 and 16 + 4s .. 16 + 4s + 3 and each atomic instruction of the
// quad covers 64 contiguous bytes; a corner whose weight is 0 adds nothing.
template <typename T>
__global__ void __launch_bounds__(kLocThreads, 4)
msda_sep_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, const T* __restrict__ gout,
                    float* __restrict__ gvalue, float* __restrict__ gloc,
                    float* __restrict__ gattn, int B, int S, int Q, int H,
                    const __grid_constant__ Levels lv, int P, bool vec) {
  const int64_t quad = ((int64_t)blockIdx.x * kLocThreads + threadIdx.x) >> 2;
  if (quad >= (int64_t)B * Q * H) return;
  const int lane = threadIdx.x & 31, sub = lane & 3;
  const unsigned qmask = 0xFu << (lane & ~3);
  const int h = (int)(quad % H);
  const int64_t bq = quad / H;
  const int b = (int)(bq / Q);
  const int row = H * 32;
  const T* vb = value + (int64_t)b * S * row + h * 32 + sub * 8;
  float* gb = gvalue == nullptr ? nullptr : gvalue + (int64_t)b * S * row + h * 32 + sub * 4;
  const T* gq = gout + bq * row + h * 32;
  float g[8], ga[8];  // channels 8s .. 8s + 7; 4s .. 4s + 3 and 16 + 4s .. 16 + 4s + 3
  {
    Row8<T> gr;
    gr.load(gq + sub * 8);
    gr.get(g);
    float lo[4], hi[4];
    load4(gq + sub * 4, lo, 4, true);
    load4(gq + 16 + sub * 4, hi, 4, true);
#pragma unroll
    for (int d = 0; d < 4; ++d) ga[d] = lo[d], ga[4 + d] = hi[d];
  }
  const int LP = lv.n * P;
  for (int j0 = 0; j0 < LP; j0 += 16) {
    const LocQuad e = loc_quad(loc, attn, quad, lv, P, j0, sub, vec);
    float gatt[4] = {0.f, 0.f, 0.f, 0.f}, gx[4] = {0.f, 0.f, 0.f, 0.f};
    float gy[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // sample j0 + j is held by thread j / 4 of the quad
      if (j0 + j >= LP) break;
      const int src = (lane & ~3) | (j >> 2);
      const float a = __shfl_sync(qmask, e.att[j & 3], src);
      const float x = __shfl_sync(qmask, e.fx[j & 3], src);
      const float y = __shfl_sync(qmask, e.fy[j & 3], src);
      const int l = (j0 + j) / P;
      const Corners c = corners(x, y, lv.h[l], lv.w[l]);
      const int start = lv.start[l];
      Row8<T> v[4];
      load_corners(vb + start * row, row, c, v);
      float pa, px, py;
      quad_sample_dots(v, g, c.lx, c.ly, qmask, pa, px, py);
      if (sub == (j >> 2)) {
        gatt[j & 3] = pa;
        gx[j & 3] = a * px * lv.w[l];
        gy[j & 3] = a * py * lv.h[l];
      }
      if (gb != nullptr && a != 0.f) {  // the same in the whole quad
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = a * c.weight(k);
          if (!((c.ok >> k) & 1u) || wk == 0.f) continue;
          float* p = gb + (start + c.index(k)) * row;
          atomicAdd(reinterpret_cast<float4*>(p),
                    make_float4(wk * ga[0], wk * ga[1], wk * ga[2], wk * ga[3]));
          atomicAdd(reinterpret_cast<float4*>(p + 16),
                    make_float4(wk * ga[4], wk * ga[5], wk * ga[6], wk * ga[7]));
        }
      }
    }
    const int64_t i = quad * LP + j0 + 4 * sub;
    if (vec && e.n == 4) {
      *reinterpret_cast<float4*>(gattn + i) = make_float4(gatt[0], gatt[1], gatt[2], gatt[3]);
      *reinterpret_cast<float4*>(gloc + 2 * i) = make_float4(gx[0], gy[0], gx[1], gy[1]);
      *reinterpret_cast<float4*>(gloc + 2 * i + 4) = make_float4(gx[2], gy[2], gx[3], gy[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u >= e.n) continue;
        gattn[i + u] = gatt[u];
        gloc[2 * (i + u)] = gx[u];
        gloc[2 * (i + u) + 1] = gy[u];
      }
    }
  }
}

// ---- kernel 7's value side: binned samples --------------------------------

// The host's plan (ops/msda_dense.py:ValueBins.packed): level l is cut into
// ntx[l] x nty[l] tiles of tw[l] x th[l] pixels (powers of two: a pixel's
// tile is a shift), numbered row-major from first[l] on; `bins` tiles in
// all, none of more than `rows` pixels.  The kernels compute none of it.
struct BinPlan {
  int bins, rows;
  int tw[kMaxLevels], th[kMaxLevels], ntx[kMaxLevels], nty[kMaxLevels], first[kMaxLevels];
};

inline BinPlan make_bin_plan(const int* table) {
  BinPlan plan;
  memcpy(&plan, table, sizeof(BinPlan));
  return plan;
}

constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kSlabBins = 1024;   // tiles the binning kernel sorts at a time
constexpr int kValueHeads = 8;    // heads (warps) of a value-side block
constexpr size_t kMaxSmem = 232448;

// Shared memory of a value-side block: per head the largest tile's rows and
// the spare row, 32 f32 channels each.
inline size_t value_smem_bytes(const BinPlan& plan) {
  return (size_t)kValueHeads * (plan.rows + 1) * 32 * sizeof(float);
}

// Whether the plan is one the kernels can index safely for these levels.
inline bool bin_plan_ok(const BinPlan& plan, const Levels& lv) {
  int first = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int tw = plan.tw[l], th = plan.th[l], ntx = plan.ntx[l], nty = plan.nty[l];
    if (tw < 1 || th < 1 || (tw & (tw - 1)) || (th & (th - 1)) || ntx < 1 || nty < 1 ||
        (int64_t)ntx * tw < lv.w[l] || (int64_t)nty * th < lv.h[l] ||
        (int64_t)tw * th > plan.rows || plan.first[l] != first)
      return false;
    first += ntx * nty;
  }
  return plan.bins == first && plan.rows >= 1 &&
         value_smem_bytes(plan) <= kMaxSmem;
}

// One entry of a tile's list: the corner weights that fall in the tile,
// the sample's query, the tile-local row of corner (x0, y0).  32 bytes, so
// that an entry is written as one whole sector of device memory.
struct alignas(32) BinEntry {
  float4 w;
  int q, r00, pad[2];
};

__device__ __forceinline__ void store_entry(BinEntry* e, const float4& w, int q, int r00) {
  *reinterpret_cast<float4*>(e) = w;
  *(reinterpret_cast<int4*>(e) + 1) = make_int4(q, r00, 0, 0);
}

// One sample of level l, as the binning kernel sees it.
struct BinSample {
  Corners c;
  float a;
  int q;
  int txc[2], tyc[2];  // tile column of corner columns x0, x0 + 1 (rows y0, y0 + 1); -1 outside
};

// A sample touches at most 2 x 2 tiles.  Slot (sy, sx) is the tile of
// corner row sy and corner column sx, and exists if it is not the tile of
// slot (sy, 0) or (0, sx) again, lies in the level, and holds a corner
// whose weight is not 0.  The entry: the four corner weights that fall in
// the tile (0 for the others), its index, and the tile-local row of corner
// (x0, y0), from which corner k lies (k & 1) + (k >> 1) * tw further.
__device__ __forceinline__ bool bin_entry(const BinSample& s, int slot, int tw, int th, int ntx,
                                          float4& w, int& bin, int& r00) {
  const int sx = slot & 1, sy = slot >> 1;
  if ((sx && s.txc[1] == s.txc[0]) || (sy && s.tyc[1] == s.tyc[0])) return false;
  const int tx = s.txc[sx], ty = s.tyc[sy];
  if (tx < 0 || ty < 0) return false;
  float wk[4];
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = s.txc[k & 1] == tx && s.tyc[k >> 1] == ty;
    wk[k] = in ? s.a * s.c.weight(k) : 0.f;
    any = any || wk[k] != 0.f;
  }
  if (!any) return false;
  w = make_float4(wk[0], wk[1], wk[2], wk[3]);
  bin = ty * ntx + tx;
  r00 = (s.c.y0 - ty * th) * tw + (s.c.x0 - tx * tw);
  return true;
}

__device__ __forceinline__ BinSample bin_sample(const float* __restrict__ loc,
                                                const float* __restrict__ attn, int b, int h,
                                                int l, int i, int Q, int H, int L, int P, int hl,
                                                int wl, int xshift, int yshift) {
  BinSample s;
  s.q = i / P;
  const int p = i - s.q * P;
  const int64_t at = ((((int64_t)b * Q + s.q) * H + h) * L + l) * P + p;
  s.a = attn[at];
  s.c = corners(loc[2 * at] * wl - 0.5f, loc[2 * at + 1] * hl - 0.5f, hl, wl);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int x = s.c.x0 + d, y = s.c.y0 + d;
    s.txc[d] = (x >= 0 && x < wl) ? x >> xshift : -1;
    s.tyc[d] = (y >= 0 && y < hl) ? y >> yshift : -1;
  }
  return s;
}

// Kernel 7 backward, step 1.  Block (b, h, l) sorts the level's Q * P
// samples by the tiles they touch, a slab of kSlabBins tiles at a time
// (the production levels are one slab each; a larger level takes several
// passes over its samples, each for the entries that fall in the slab's
// tiles).  Warp w takes samples 256 i + 32 w + lane, i = 0, 1, ...  Pass 1
// counts the slab's entries per (warp, tile) in shared memory; a scan turns
// the counts into each (warp, tile)'s first position (tile-major, then
// warp) and writes every tile's (first entry, entries) to `table` [B, H,
// bins]; pass 2 walks the same samples again and places each entry: within
// a warp's step the lanes that meet in one tile rank themselves by
// __match_any_sync, so an entry's place is a function of its sample's index
// alone.  Entries go to `entries` from position ((b * H + h) * L + l) * 4 *
// Q * P on, the most a group can hold, slab after slab.
__global__ void __launch_bounds__(kBinThreads)
msda_dense_fused_bwd_bin_kernel(const float* __restrict__ loc, const float* __restrict__ attn,
                                BinEntry* __restrict__ entries, int2* __restrict__ table,
                                int Q, int H,
                                const __grid_constant__ Levels lv,
                                const __grid_constant__ BinPlan plan, int P) {
  __shared__ int s_at[kBinWarps * kSlabBins];
  __shared__ int s_warp[kBinWarps];
  const int L = lv.n;
  const int l = blockIdx.x % L, h = (blockIdx.x / L) % H, b = blockIdx.x / (L * H);
  const int hl = lv.h[l], wl = lv.w[l];
  const int tw = plan.tw[l], th = plan.th[l], ntx = plan.ntx[l];
  const int xshift = __ffs(tw) - 1, yshift = __ffs(th) - 1;
  const int bins = ntx * plan.nty[l];
  const int NS = Q * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = (b * H + h) * L + l;
  int base = group * 4 * NS;  // where this slab's entries start
  int2* row = table + (int64_t)(b * H + h) * plan.bins + plan.first[l];

  for (int slab = 0; slab < bins; slab += kSlabBins) {
    const int nb = min(kSlabBins, bins - slab);  // tiles slab .. slab + nb - 1
    int* mine = s_at + warp * nb;
    __syncthreads();  // the slab before is done with s_at and s_warp
    for (int i = threadIdx.x; i < kBinWarps * nb; i += kBinThreads) s_at[i] = 0;
    __syncthreads();

    for (int i = threadIdx.x; i < NS; i += kBinThreads) {
      const BinSample s = bin_sample(loc, attn, b, h, l, i, Q, H, L, P, hl, wl, xshift, yshift);
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) {
        float4 w;
        int bin, r00;
        if (bin_entry(s, slot, tw, th, ntx, w, bin, r00) &&
            (unsigned)(bin - slab) < (unsigned)nb)
          atomicAdd(mine + bin - slab, 1);
      }
    }
    __syncthreads();

    // thread t scans the slab's tiles [t * per, t * per + per)
    const int per = (nb + kBinThreads - 1) / kBinThreads;
    const int bin0 = threadIdx.x * per;
    int sum = 0;
    for (int bin = bin0; bin < min(bin0 + per, nb); ++bin)
      for (int w = 0; w < kBinWarps; ++w) sum += s_at[w * nb + bin];
    int upto = sum;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int below = __shfl_up_sync(kFullMask, upto, o);
      if (lane >= o) upto += below;
    }
    if (lane == 31) s_warp[warp] = upto;
    __syncthreads();
    int at = upto - sum, total = 0;
    for (int w = 0; w < kBinWarps; ++w) {
      if (w < warp) at += s_warp[w];
      total += s_warp[w];
    }
    for (int bin = bin0; bin < min(bin0 + per, nb); ++bin) {
      const int first = at;
      for (int w = 0; w < kBinWarps; ++w) {
        const int n = s_at[w * nb + bin];
        s_at[w * nb + bin] = at;
        at += n;
      }
      row[slab + bin] = make_int2(base + first, at - first);
    }
    __syncthreads();

    for (int i0 = warp * 32; i0 < NS; i0 += kBinThreads) {  // the same in the whole warp
      const int i = i0 + lane;
      const bool live = i < NS;
      BinSample s;
      if (live) s = bin_sample(loc, attn, b, h, l, i, Q, H, L, P, hl, wl, xshift, yshift);
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) {
        float4 w;
        int bin = 0, r00 = 0;
        const bool has = live && bin_entry(s, slot, tw, th, ntx, w, bin, r00) &&
                         (unsigned)(bin - slab) < (unsigned)nb;
        if (!__any_sync(kFullMask, has)) continue;
        bin -= slab;
        const unsigned peers = __match_any_sync(kFullMask, has ? bin : -1 - lane);
        int place = 0;
        if (has) place = mine[bin] + __popc(peers & ((1u << lane) - 1u));
        __syncwarp();
        if (has && lane == 31 - __clz(peers)) mine[bin] += __popc(peers);
        __syncwarp();
        if (has) store_entry(entries + base + place, w, s.q, r00);
      }
    }
    base += total;
  }
}

// Kernel 7 backward, step 2.  Block (tile, b x group of 8 heads), tile the
// slow index of a flat grid, warp = head.  Each warp zeroes its tile's rows in shared memory and walks its
// own list of entries in order: lane i loads entry i of a chunk of 32 (one
// KB, coalesced) while the chunk before is walked, the entries reach the
// warp by shuffles, and the output-gradient rows of the 4 entries after the
// 4 being added are on their way.  For an entry, lane d adds weight x
// g[q, d] to the four corners' rows at once (they are four different rows;
// a corner that carries no weight goes to a spare row), so an entry is one
// round trip to shared memory, which no other thread touches.  Then the
// block writes the tile's rows that lie in the level, a warp a row of all 8
// heads at a time, 8 channels a thread.  Every dvalue row is written once.
template <typename T>
__global__ void __launch_bounds__(kValueHeads * 32)
msda_dense_fused_bwd_value_kernel(const BinEntry* __restrict__ entries,
                                  const int2* __restrict__ table, const T* __restrict__ gout,
                                  T* __restrict__ gvalue, int groups, int S, int Q, int H,
                                  const __grid_constant__ Levels lv,
                                  const __grid_constant__ BinPlan plan) {
  extern __shared__ float4 s_acc4[];  // per head plan.rows rows and the spare one
  float* s_acc = reinterpret_cast<float*>(s_acc4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_b = (H + kValueHeads - 1) / kValueHeads;
  const int bg = blockIdx.x % groups;  // groups = B * per_b
  const int b = bg / per_b, h0 = (bg % per_b) * kValueHeads;
  // the coarse levels' tiles, whose lists are the longest, start first
  const int gbin = plan.bins - 1 - (int)(blockIdx.x / groups);
  int l = 0;
  while (l + 1 < lv.n && gbin >= plan.first[l + 1]) ++l;
  const int bin = gbin - plan.first[l];
  const int tw = plan.tw[l], th = plan.th[l], ntx = plan.ntx[l];
  const int ty = bin / ntx, tx = bin - ty * ntx;
  const int rows = tw * th, spare = plan.rows;
  const int h = h0 + warp;
  int2 list = make_int2(0, 0);
  if (h < H) list = __ldg(table + (int64_t)(b * H + h) * plan.bins + gbin);
  const int n = list.y;
  // lane i holds entry c0 + i of the chunk of 32 being walked, and of the next
  const float4* pw = reinterpret_cast<const float4*>(entries + list.x) + 2 * lane;
  float4 w_at = make_float4(0.f, 0.f, 0.f, 0.f), w_next = w_at;
  int4 m_at = make_int4(0, 0, 0, 0), m_next = m_at;
  if (lane < n) {
    w_at = __ldg(pw);
    m_at = __ldg(reinterpret_cast<const int4*>(pw) + 1);
  }
  for (int i = lane; i < rows * 8; i += 32)  // the warp's own rows: no barrier
    s_acc4[warp * (plan.rows + 1) * 8 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  const int64_t grow = (int64_t)H * 32;
  const T* g0 = gout + ((int64_t)b * Q * H + h) * 32 + lane;
  float* acc = s_acc + warp * (plan.rows + 1) * 32 + lane;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cnt = min(32, n - c0);
    if (c0 + 32 + lane < n) {
      w_next = __ldg(pw + 2 * (c0 + 32));
      m_next = __ldg(reinterpret_cast<const int4*>(pw + 2 * (c0 + 32)) + 1);
    }
    float g[4], g_next[4];  // the output-gradient rows of 4 entries, and of the 4 after
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = __shfl_sync(kFullMask, m_at.x, u);
      if (u < cnt) g[u] = to_f32(g0[q * grow]);
    }
    for (int u0 = 0; u0 < cnt; u0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = __shfl_sync(kFullMask, m_at.x, (u0 + 4 + u) & 31);
        if (u0 + 4 + u < cnt) g_next[u] = to_f32(g0[q * grow]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int src = (u0 + u) & 31;
        const float wx = __shfl_sync(kFullMask, w_at.x, src);
        const float wy = __shfl_sync(kFullMask, w_at.y, src);
        const float wz = __shfl_sync(kFullMask, w_at.z, src);
        const float ww = __shfl_sync(kFullMask, w_at.w, src);
        const int r00 = __shfl_sync(kFullMask, m_at.y, src);
        if (u0 + u >= cnt) continue;
        float* c0p = acc + (wx != 0.f ? r00 : spare) * 32;
        float* c1p = acc + (wy != 0.f ? r00 + 1 : spare) * 32;
        float* c2p = acc + (wz != 0.f ? r00 + tw : spare) * 32;
        float* c3p = acc + (ww != 0.f ? r00 + tw + 1 : spare) * 32;
        const float a0 = *c0p, a1 = *c1p, a2 = *c2p, a3 = *c3p;
        *c0p = fmaf(wx, g[u], a0);
        *c1p = fmaf(wy, g[u], a1);
        *c2p = fmaf(wz, g[u], a2);
        *c3p = fmaf(ww, g[u], a3);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) g[u] = g_next[u];
    }
    w_at = w_next, m_at = m_next;
  }
  __syncthreads();

  const int hl = lv.h[l], wl = lv.w[l];
  const int head = lane >> 2, part = lane & 3;  // this thread's 8 channels of a row
  if (h0 + head >= H) return;
  T* gv = gvalue + ((int64_t)b * S + lv.start[l]) * H * 32 + (h0 + head) * 32 + part * 8;
  for (int r = warp; r < rows; r += kValueHeads) {
    const int dy = r / tw;
    const int x = tx * tw + r - dy * tw, y = ty * th + dy;
    if (x >= wl || y >= hl) continue;
    const float4* a = s_acc4 + (head * (plan.rows + 1) + r) * 8 + part * 2;
    const float4 lo = a[0], hi = a[1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(gv + (int64_t)(y * wl + x) * H * 32, v);
  }
}

// ---- hosts -----------------------------------------------------------------

inline bool bad_loc_shape(int S, int H, int D, int L, int P) {
  return D != 32 || L < 1 || L > kMaxLevels || P < 1 || L * P > kMaxSamples ||
         !fits_int32(S, H);
}

// Whether a thread's 4 weights and 8 location floats are aligned vectors.
inline bool loc_vec(int LP, std::initializer_list<const void*> ps) {
  return LP % 4 == 0 && aligned16(ps);
}

inline unsigned loc_blocks(int64_t quads) {
  return (unsigned)((quads + kLocQuads - 1) / kLocQuads);
}

// Calls f with a value of the element type that `dtype` names.
template <typename F>
int by_dtype(int dtype, F f) {
  if (dtype == kBF16) {
    f(__nv_bfloat16());
  } else if (dtype == kF32) {
    f(0.f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

enum Which : int { kSep = 0, kDenseFused = 1 };

// The forward of kernel 2 or 7.
int loc_forward_host(int which, void* value, void* loc, void* attn, void* out, int dtype, int B,
                     int S, int Q, int H, int D, int L, int P, void* hw, void* stream) {
  if (bad_loc_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, out})) return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const int64_t heads = (int64_t)B * Q * H;
  if (heads == 0) return 0;
  const bool vec = loc_vec(L * P, {loc, attn});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *at = static_cast<const float*>(attn);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* v = static_cast<const T*>(value);
    T* o = static_cast<T*>(out);
    if (which == kSep)
      msda_sep_kernel<T><<<loc_blocks(heads), kLocThreads, 0, st>>>(v, lc, at, o, B, S, Q, H, lv,
                                                                   P, vec);
    else
      msda_dense_fused_kernel<T><<<loc_blocks(heads), kLocThreads, 0, st>>>(v, lc, at, o, B, S, Q,
                                                                           H, lv, P, vec);
  });
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// Kernel 2.  value [B, S, H, 32] (dtype), loc [B, Q, H, L, P, 2] f32, attn
// [B, Q, H, L, P] f32, out [B, Q, H*32] (dtype); hw: host int array
// (h0, w0, h1, w1, ...) of the L levels.
int mdt_msda_sep(void* value, void* loc, void* attn, void* out, int dtype, int B, int S, int Q,
                 int H, int D, int L, int P, void* hw, void* stream) {
  return loc_forward_host(kSep, value, loc, attn, out, dtype, B, S, Q, H, D, L, P, hw, stream);
}

// Kernel 7.  Arguments as mdt_msda_sep.
int mdt_msda_dense_fused(void* value, void* loc, void* attn, void* out, int dtype, int B, int S,
                         int Q, int H, int D, int L, int P, void* hw, void* stream) {
  return loc_forward_host(kDenseFused, value, loc, attn, out, dtype, B, S, Q, H, D, L, P, hw,
                          stream);
}

// Kernel 2 backward.  value, loc, attn as mdt_msda_sep; gout [B, Q, H*32]
// (dtype); gvalue [B, S, H, 32] f32, zeroed by the caller, or null for
// kernel 7's query side (dloc and dattn only); gloc, gattn shaped as loc
// and attn (f32).
int mdt_msda_sep_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue, void* gloc,
                     void* gattn, int dtype, int B, int S, int Q, int H, int D, int L, int P,
                     void* hw, void* stream) {
  if (bad_loc_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  if (!aligned16({value, gout, gvalue})) return (int)cudaErrorMisalignedAddress;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const int64_t heads = (int64_t)B * Q * H;
  if (heads == 0) return 0;
  const bool vec = loc_vec(L * P, {loc, attn, gloc, gattn});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *lc = static_cast<const float*>(loc), *at = static_cast<const float*>(attn);
  float *gv = static_cast<float*>(gvalue), *gl = static_cast<float*>(gloc);
  float* ga = static_cast<float*>(gattn);
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T *v = static_cast<const T*>(value), *go = static_cast<const T*>(gout);
    msda_sep_bwd_kernel<T><<<loc_blocks(heads), kLocThreads, 0, st>>>(v, lc, at, go, gv, gl, ga,
                                                                     B, S, Q, H, lv, P, vec);
  });
}

// Kernel 7 backward: the query side (kernel 2's backward kernel without
// its value gradient), the binning and the value side, on one stream.
// Arguments as mdt_msda_sep_bwd, except that gvalue [B, S, H, 32] has
// value's dtype and needs no zeroing: every row is written once.  plan: the
// host int table of ops/msda_dense.py:ValueBins.packed; entries: scratch of
// 4 * B*H*L*Q*P entries of 32 bytes, 16-byte aligned; table: scratch, int2
// [B, H, bins].
int mdt_msda_dense_fused_bwd(void* value, void* loc, void* attn, void* gout, void* gvalue,
                             void* gloc, void* gattn, void* entries, void* table, int dtype,
                             int B, int S, int Q, int H, int D, int L, int P, void* hw,
                             void* plan, void* stream) {
  if (bad_loc_shape(S, H, D, L, P)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(L, static_cast<const int*>(hw));
  const BinPlan bp = make_bin_plan(static_cast<const int*>(plan));
  const int64_t slots = (int64_t)4 * B * H * L * Q * P;
  const int64_t groups = (int64_t)B * ((H + kValueHeads - 1) / kValueHeads);
  if (!bin_plan_ok(bp, lv) || slots > INT32_MAX || (int64_t)B * H * bp.bins > INT32_MAX ||
      groups * bp.bins > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({entries, gvalue})) return (int)cudaErrorMisalignedAddress;
  if (B * H == 0) return 0;  // Q == 0 still writes dvalue = 0
  const int rc = mdt_msda_sep_bwd(value, loc, attn, gout, nullptr, gloc, gattn, dtype, B, S, Q, H,
                                  D, L, P, hw, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BinEntry* list = static_cast<BinEntry*>(entries);
  msda_dense_fused_bwd_bin_kernel<<<(unsigned)(B * H * L), kBinThreads, 0, st>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn), list,
      static_cast<int2*>(table), Q, H, lv, bp, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = value_smem_bytes(bp);
  const int done = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    err = cudaFuncSetAttribute(msda_dense_fused_bwd_value_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return;
    msda_dense_fused_bwd_value_kernel<T><<<(unsigned)(groups * bp.bins), kValueHeads * 32, smem,
                                           st>>>(
        list, static_cast<const int2*>(table), static_cast<const T*>(gout),
        static_cast<T*>(gvalue), (int)groups, S, Q, H, lv, bp);
  });
  return err != cudaSuccess ? (int)err : done;
}

}  // extern "C"
