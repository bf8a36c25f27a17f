// Batched exact linear assignment for Hopper (sm_90a).
//
// Replaces monodetr_tpu/ops/lap_pallas.py:lap_solve_pallas (_lap_kernel),
// the Hungarian matcher's solver: for every problem, a square cost [N, N]
// f32 with row validity, the column assigned to each row (-1 for skipped
// rows).  The algorithm is models/matcher.py:lap_solve op for op: greedy
// row-reduction init (u = row minimum over valid rows, v = 0, each column
// taken by the lowest valid row whose argmin it is), then for every valid
// row the init left unmatched a shortest augmenting path (Dijkstra over
// columns with the reduced cost ((minVal + cost[i, j]) - u[i]) - v[j],
// argmin with the lowest index on ties), the dual updates and the
// augmentation.  The sums are taken in that order with round-to-nearest
// intrinsics and there are no products, so the result is bit-identical to
// lap_solve, to the Pallas kernel and to scipy's linear_sum_assignment on
// the same f32 costs.
//
// What bounds it: latency.  A problem is a chain of Dijkstra iterations
// (459 in the longest of a training step's 528 hard problems), each
// waiting for the last: the assigned row of the chosen column, that row's
// costs, the update of every column, the argmin.  The layout shortens
// each link:
//   - one warp per problem, 4 a block; the warp first copies its cost
//     matrix (10 KB at N = 50, 16 KB at 64) into shared memory with 16-byte
//     loads, so a row is a shared load, never an L2 round trip;
//   - lane c owns columns c and c + 32 (their duals, shortest-path lengths,
//     predecessor rows and scanned flags live in registers during a path's
//     search); the row arrays (duals, assigned columns) and the column ->
//     row map live in shared memory, the scanned rows in a 64-bit mask;
//   - after a search the lengths and predecessors go to shared memory: the
//     dual update reads them with one load a row, and one lane walks the
//     augmenting path there, with no shuffle and no warp sync a step;
//   - the argmin is one __reduce_min_sync on an order-preserving uint32 key
//     and two ballots (lap_argmin), not a 5-step shuffle tree;
//   - the greedy start runs in parallel, as the Pallas kernel's does: every
//     lane finds its rows' argmins, the lowest valid row claims a column by
//     a shared atomicMin, and no row waits for another.
// 528 problems are 132 blocks: one a SM, all resident at once.
#include "common.cuh"

namespace mdt {

constexpr int kLapMaxN = 64;
constexpr int kLapWarps = 4;  // problems per block
constexpr float kLapInf = 1e18f;

// An order-preserving uint32 key of a float (finite or +-inf): a < b iff
// key(a) < key(b).  -0.0 is first made +0.0 (x + 0 under round-to-nearest),
// so the two zeros, equal under <, share a key and tie.
__device__ __forceinline__ unsigned lap_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float lap_unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The argmin over the warp's 64 column slots (lane c holds columns c and
// c + 32), the lowest column on ties; kmin gets the minimum's key.  Lanes
// whose own winner is column `lane` (< 32) come before those whose winner
// is `lane + 32`.
__device__ __forceinline__ int lap_argmin(float lo, float hi, unsigned& kmin) {
  const unsigned klo = lap_key(lo), khi = lap_key(hi);
  const bool take_lo = klo <= khi;
  const unsigned k = take_lo ? klo : khi;
  kmin = __reduce_min_sync(kFullMask, k);
  const bool eq = k == kmin;
  const unsigned b_lo = __ballot_sync(kFullMask, eq && take_lo);
  const unsigned b_all = __ballot_sync(kFullMask, eq);
  return b_lo ? __ffs(b_lo) - 1 : __ffs(b_all) + 31;
}

// One column's relaxation from row i: the reduced cost, kept if shorter
// (scanned columns keep theirs); returns what the argmin sees.
__device__ __forceinline__ float lap_relax(float minVal, float c, float ui, float v, bool scanned,
                                           float& sh, int& pr, int i) {
  const float cand = __fsub_rn(__fsub_rn(__fadd_rn(minVal, c), ui), v);
  if (!scanned && cand < sh) {
    sh = cand;
    pr = i;
  }
  return scanned ? kLapInf : sh;
}

// The floats of one problem's cost matrix in shared memory, rounded up to
// whole float4s so that every warp's slice starts 16-byte aligned.
__host__ __device__ __forceinline__ int lap_slice_floats(int N) { return (N * N + 3) & ~3; }

__global__ void __launch_bounds__(kLapWarps * 32)
lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid,
           int* __restrict__ col4row_out, int n_problems, int N) {
  extern __shared__ float4 lap_cost_s[];  // kLapWarps slices of lap_slice_floats(N)
  __shared__ float u_s[kLapWarps][kLapMaxN];
  __shared__ int c4r_s[kLapWarps][kLapMaxN];
  __shared__ int r4c_s[kLapWarps][kLapMaxN];
  __shared__ int claim_s[kLapWarps][kLapMaxN];
  __shared__ float sh_s[kLapWarps][kLapMaxN];  // a path's lengths, per column
  __shared__ int pr_s[kLapWarps][kLapMaxN];    // and predecessor rows

  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * kLapWarps + wib;
  if (prob >= n_problems) return;  // whole warps exit together
  const int nn = N * N;
  const float* C = cost + (int64_t)prob * nn;
  float4* cs4 = lap_cost_s + wib * (lap_slice_floats(N) >> 2);
  float* Cs = reinterpret_cast<float*>(cs4);
  float* u = u_s[wib];
  int* c4r = c4r_s[wib];
  int* r4c = r4c_s[wib];
  int* claim = claim_s[wib];
  float* sh = sh_s[wib];
  int* pr = pr_s[wib];

  // ---- the cost matrix into shared memory: 16-byte loads where the
  // problem starts 16-byte aligned (N * N % 4 == 0 or an even problem)
  if ((reinterpret_cast<uintptr_t>(C) & 15u) == 0) {
    const float4* src = reinterpret_cast<const float4*>(C);
    const int n4 = nn >> 2;
#pragma unroll 8
    for (int k = lane; k < n4; k += 32) cs4[k] = __ldg(src + k);
    for (int k = (n4 << 2) + lane; k < nn; k += 32) Cs[k] = __ldg(C + k);
  } else {
#pragma unroll 8
    for (int k = lane; k < nn; k += 32) Cs[k] = __ldg(C + k);
  }
  const int ra = lane, rb = lane + 32;  // this lane's rows, and its columns
  const bool ina = ra < N, inb = rb < N;
  const bool valid_a = ina && row_valid[(int64_t)prob * N + ra] != 0;
  const bool valid_b = inb && row_valid[(int64_t)prob * N + rb] != 0;
  claim[ra] = N;
  claim[rb] = N;
  r4c[ra] = -1;
  r4c[rb] = -1;
  __syncwarp();

  // ---- greedy row-reduction init, every row at once: the row minimum
  // and its lowest column.  Lane r starts at column r and wraps, so the
  // warp's 32 loads of one step fall in 32 banks whatever N is.
  float ma = 0.f, mb = 0.f;
  int ja = 0, jb = 0;
  if (ina) {
    const float* Ra = Cs + ra * N;
    const float* Rb = Cs + (inb ? rb : ra) * N;
    ma = Ra[lane];
    mb = Rb[lane];
    ja = jb = lane;
    int c = lane;
    for (int t = 1; t < N; ++t) {
      c = c + 1 == N ? 0 : c + 1;
      const float xa = Ra[c], xb = Rb[c];
      if (xa < ma || (xa == ma && c < ja)) {
        ma = xa;
        ja = c;
      }
      if (xb < mb || (xb == mb && c < jb)) {
        mb = xb;
        jb = c;
      }
    }
  }
  // a column goes to the lowest valid row whose argmin it is
  if (valid_a) atomicMin(claim + ja, ra);
  if (valid_b) atomicMin(claim + jb, rb);
  __syncwarp();
  const bool has_a = valid_a && claim[ja] == ra;
  const bool has_b = valid_b && claim[jb] == rb;
  if (ina) {
    u[ra] = valid_a ? ma : 0.f;
    c4r[ra] = has_a ? ja : -1;
  }
  if (inb) {
    u[rb] = valid_b ? mb : 0.f;
    c4r[rb] = has_b ? jb : -1;
  }
  if (has_a) r4c[ja] = ra;
  if (has_b) r4c[jb] = rb;
  // the rows that need a path: valid and unmatched.  An augmentation
  // matches its own row and re-matches matched rows only, so the set is
  // known now; lap_solve visits them in ascending order
  uint64_t work = __ballot_sync(kFullMask, valid_a && !has_a) |
                  ((uint64_t)__ballot_sync(kFullMask, valid_b && !has_b) << 32);
  __syncwarp();

  // ---- shortest augmenting paths
  const int ca = lane, cb = lane + 32;  // this lane's columns
  float va = 0.f, vb = 0.f;             // column duals
  while (work) {
    const int cur = __ffsll((long long)work) - 1;
    work &= work - 1;
    float sha = kLapInf, shb = kLapInf;  // shortest path length per column
    int pra = -1, prb = -1;              // predecessor row per column
    bool sca = false, scb = false;       // scanned columns
    uint64_t scanned_rows = 0;
    int i = cur, sink;
    float minVal = 0.f;
    while (true) {
      scanned_rows |= 1ull << i;
      const float ui = u[i];
      const float* Ci = Cs + i * N;
      // both columns' loads and updates unconditionally, with no branch
      // (and no reconvergence) on the chain: a column past N reads column 0
      // and is then masked; +inf sorts above every scanned column's 1e18
      const float xa = Ci[ina ? ca : 0], xb = Ci[inb ? cb : 0];
      float la = lap_relax(minVal, xa, ui, va, sca || !ina, sha, pra, i);
      float lb = lap_relax(minVal, xb, ui, vb, scb || !inb, shb, prb, i);
      la = ina ? la : INFINITY;
      lb = inb ? lb : INFINITY;
      unsigned kmin;
      const int j = lap_argmin(la, lb, kmin);
      minVal = lap_unkey(kmin);  // a zero comes back as +0.0; no comparison sees the sign
      sca |= j == ca;
      scb |= j == cb;
      const int r = r4c[j];
      if (r < 0) {
        sink = j;
        break;
      }
      i = r;
    }

    // the path lengths and predecessors into shared memory, where any
    // lane reads them with one load (no shuffles, no divergence checks)
    sh[ca] = sha;
    sh[cb] = shb;
    pr[ca] = pra;
    pr[cb] = prb;
    __syncwarp();

    // dual updates with the pre-augmentation assignment
    for (int r = lane; r < N; r += 32) {  // rows lane and lane + 32
      const int c = c4r[r];
      if (r == cur) u[r] = __fadd_rn(u[r], minVal);
      else if (((scanned_rows >> r) & 1) && c >= 0) u[r] = __fadd_rn(u[r], __fsub_rn(minVal, sh[c]));
    }
    if (sca) va = __fsub_rn(va, __fsub_rn(minVal, sha));
    if (scb) vb = __fsub_rn(vb, __fsub_rn(minVal, shb));
    __syncwarp();

    // augment along the alternating path ending at sink: one lane walks it
    // in shared memory
    if (lane == 0) {
      int j = sink;
      while (true) {
        const int pi = pr[j];
        const int j_next = c4r[pi];
        r4c[j] = pi;
        c4r[pi] = j;
        if (pi == cur) break;
        j = j_next;
      }
    }
    __syncwarp();
  }

  for (int r = lane; r < N; r += 32) col4row_out[(int64_t)prob * N + r] = c4r[r];
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Latencies, in SM cycles, of the links of one Dijkstra step, each timed
// by clock64 over a chain of `iters` dependent repetitions on one warp:
// out[0] a shared-memory load (a pointer chase, lane l at word l + t), out[1]
// a column's relaxation (lap_relax, its result fed back as minVal), out[2]
// the argmin with the decode of its minimum (lap_argmin, the decoded
// minimum fed back); out[3] and out[4] the cycles and nanoseconds of a
// spin of ~2^24 cycles, for the SM clock; out[5] keeps the chains' results
// alive.
__global__ void lap_probe_kernel(long long* out, int iters) {
  __shared__ int chase[2 * kLapMaxN];
  const int lane = threadIdx.x;
  for (int k = lane; k < 2 * kLapMaxN; k += 32) chase[k] = (k + 1) & (2 * kLapMaxN - 1);
  __syncwarp();

  int idx = lane;
  long long t0 = clock64();
  for (int k = 0; k < iters; ++k) idx = chase[idx];
  long long t1 = clock64();
  if (lane == 0) out[0] = t1 - t0;

  float m = 0.25f * lane, sh = kLapInf;
  int pr = -1;
  const float c = 1.5f + lane, ui = 0.5f, v = -0.25f;
  t0 = clock64();
  for (int k = 0; k < iters; ++k) m = lap_relax(m, c, ui, v, false, sh, pr, k);
  t1 = clock64();
  if (lane == 0) out[1] = t1 - t0;

  unsigned kmin = lap_key(1.0f + lane);
  int jsum = 0;
  t0 = clock64();
  for (int k = 0; k < iters; ++k) {
    const float base = lap_unkey(kmin);
    jsum += lap_argmin(__uint_as_float(__float_as_uint(base) ^ lane),
                       __uint_as_float(__float_as_uint(base) ^ (lane + 32)), kmin);
  }
  t1 = clock64();
  if (lane == 0) out[2] = t1 - t0;

  const long long s0 = clock64();
  const uint64_t g0 = global_ns();
  while (clock64() - s0 < (1ll << 24)) {
  }
  const long long s1 = clock64();
  const uint64_t g1 = global_ns();
  if (lane == 0) {
    out[3] = s1 - s0;
    out[4] = (long long)(g1 - g0);
    out[5] = idx + pr + jsum + (long long)(m + sh);
  }
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// cost [n_problems, N, N] f32, row_valid [n_problems, N] uint8, col4row
// [n_problems, N] int32.  N <= 64.
int mdt_lap(void* cost, void* row_valid, void* col4row, int n_problems, int N, void* stream) {
  if (N < 1 || N > kLapMaxN || n_problems < 0) return (int)cudaErrorInvalidValue;
  if (n_problems == 0) return 0;
  const int smem = kLapWarps * lap_slice_floats(N) * (int)sizeof(float);
  static bool smem_raised = false;  // 64 KB at N = 64: above the default 48 KB
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kLapWarps * lap_slice_floats(kLapMaxN) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const unsigned grid = (unsigned)((n_problems + kLapWarps - 1) / kLapWarps);
  lap_kernel<<<grid, kLapWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(row_valid),
      static_cast<int*>(col4row), n_problems, N);
  return (int)cudaGetLastError();
}

// out: 6 int64 on the card (lap_probe_kernel).  One warp.
int mdt_lap_probe(void* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  lap_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
