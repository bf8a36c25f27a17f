// Batched exact linear assignment for Hopper (sm_90a).
//
// Replaces monodetr_tpu/ops/lap_pallas.py:lap_solve_pallas (_lap_kernel),
// the Hungarian matcher's solver: for every problem, a square cost [N, N]
// f32 with row validity, the column assigned to each row (-1 for skipped
// rows).  The algorithm is models/matcher.py:lap_solve op for op: greedy
// row-reduction init (u = row minimum over valid rows, v = 0, each column
// taken by the lowest valid row whose argmin it is), then for every valid
// unmatched row up to the last valid one a shortest augmenting path
// (Dijkstra over columns with the reduced cost ((minVal + cost[i, j]) -
// u[i]) - v[j], argmin with the lowest index on ties), the dual updates and
// the augmentation.  The sums are taken in that order with
// round-to-nearest intrinsics and there are no products, so the result is
// bit-identical to lap_solve, to the Pallas kernel and to scipy's
// linear_sum_assignment on the same f32 costs.
//
// One warp per problem, N <= 64: lane c owns columns c and c + 32 (their
// duals, shortest-path lengths, predecessor rows, scanned flags and
// assigned rows live in registers); the row arrays (duals, assigned
// columns, scanned flags) live in shared memory.  A row of the cost matrix
// is one coalesced load from global memory (L1/L2-resident: 10 KB per
// problem at N = 50).  All problems of a training step (layers x batch x
// groups, 528 at batch 16) go in one launch.
//
// What bounds it: latency.  Each Dijkstra iteration is a dependent chain of
// a row load, an update and a 5-step shuffle argmin; a problem takes a few
// hundred of them at most, and 528 warps fill only a fraction of the card.
#include "common.cuh"

namespace mdt {

constexpr int kLapMaxN = 64;
constexpr int kLapWarps = 4;  // problems per block
constexpr float kLapInf = 1e18f;

// (value, index) argmin across the warp, lowest index on ties.
__device__ __forceinline__ void warp_argmin(float& val, int& idx) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, val, s);
    const int oi = __shfl_xor_sync(kFullMask, idx, s);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
}

// Value of a column-indexed register pair (lo: column c, hi: column c + 32)
// at column j, for every lane.  Every lane of the warp must call it.
__device__ __forceinline__ float col_get(float lo, float hi, int j) {
  const float a = __shfl_sync(kFullMask, lo, j & 31);
  const float b = __shfl_sync(kFullMask, hi, j & 31);
  return j < 32 ? a : b;
}
__device__ __forceinline__ int col_get(int lo, int hi, int j) {
  const int a = __shfl_sync(kFullMask, lo, j & 31);
  const int b = __shfl_sync(kFullMask, hi, j & 31);
  return j < 32 ? a : b;
}

__global__ void __launch_bounds__(kLapWarps * 32)
lap_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ row_valid,
           int* __restrict__ col4row_out, int n_problems, int N) {
  __shared__ float u_s[kLapWarps][kLapMaxN];
  __shared__ int c4r_s[kLapWarps][kLapMaxN];
  __shared__ int sr_s[kLapWarps][kLapMaxN];

  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * kLapWarps + wib;
  if (prob >= n_problems) return;  // whole warps exit together
  const float* C = cost + (int64_t)prob * N * N;
  const uint8_t* rv = row_valid + (int64_t)prob * N;
  float* u = u_s[wib];
  int* c4r = c4r_s[wib];
  int* sr = sr_s[wib];

  const int ca = lane, cb = lane + 32;  // this lane's columns
  const bool ina = ca < N, inb = cb < N;

  // ---- greedy row-reduction init
  float va = 0.f, vb = 0.f;  // column duals
  int r4ca = -1, r4cb = -1;  // row assigned to each column
  int n_work = 0;
  for (int i = 0; i < N; ++i) {
    float mv = ina ? C[(int64_t)i * N + ca] : INFINITY;
    int mj = ca;
    if (inb) {
      const float x = C[(int64_t)i * N + cb];
      if (x < mv) {
        mv = x;
        mj = cb;
      }
    }
    warp_argmin(mv, mj);
    const bool valid = rv[i] != 0;
    int take = -1;
    if (valid) {
      n_work = i + 1;
      // the lowest valid row whose argmin is column mj takes it: rows go
      // in ascending order, so the column is taken iff it is still free
      if (col_get(r4ca, r4cb, mj) < 0) take = mj;
    }
    if (take >= 0) {
      if (take == ca) r4ca = i;
      if (take == cb) r4cb = i;
    }
    if (lane == 0) {
      u[i] = valid ? mv : 0.f;
      c4r[i] = take;
    }
  }
  __syncwarp();

  // ---- shortest augmenting paths
  for (int cur = 0; cur < n_work; ++cur) {
    if (rv[cur] == 0 || c4r[cur] >= 0) continue;  // skipped rows: no work
    for (int i = lane; i < N; i += 32) sr[i] = 0;
    __syncwarp();
    float sha = kLapInf, shb = kLapInf;  // shortest path length per column
    int pra = -1, prb = -1;              // predecessor row per column
    bool sca = false, scb = false;       // scanned columns
    int i = cur, sink = -1;
    float minVal = 0.f;
    while (sink < 0) {
      if (lane == 0) sr[i] = 1;
      const float ui = u[i];
      const float* Ci = C + (int64_t)i * N;
      if (ina && !sca) {
        const float cand = __fsub_rn(__fsub_rn(__fadd_rn(minVal, Ci[ca]), ui), va);
        if (cand < sha) {
          sha = cand;
          pra = i;
        }
      }
      if (inb && !scb) {
        const float cand = __fsub_rn(__fsub_rn(__fadd_rn(minVal, Ci[cb]), ui), vb);
        if (cand < shb) {
          shb = cand;
          prb = i;
        }
      }
      // argmin over unscanned columns (scanned ones count as kLapInf;
      // columns past N never win)
      float mv = ina ? (sca ? kLapInf : sha) : INFINITY;
      int mj = ca;
      const float mb = inb ? (scb ? kLapInf : shb) : INFINITY;
      if (mb < mv) {
        mv = mb;
        mj = cb;
      }
      warp_argmin(mv, mj);
      minVal = mv;
      if (mj == ca) sca = true;
      if (mj == cb) scb = true;
      const int r = col_get(r4ca, r4cb, mj);
      if (r < 0) {
        sink = mj;
      } else {
        i = r;
      }
      __syncwarp();
    }

    // dual updates with the pre-augmentation assignment
    for (int half = 0; half < 2; ++half) {  // rows lane and lane + 32
      const int r = lane + 32 * half;
      const bool in = r < N;
      const int c = in ? c4r[r] : -1;
      const bool upd = in && sr[r] != 0 && r != cur && c >= 0;
      // every lane takes part in the shuffles of col_get
      const float sh_c = col_get(sha, shb, c < 0 ? 0 : c);
      if (r == cur) u[r] = __fadd_rn(u[r], minVal);
      else if (upd) u[r] = __fadd_rn(u[r], __fsub_rn(minVal, sh_c));
    }
    if (sca) va = __fsub_rn(va, __fsub_rn(minVal, sha));
    if (scb) vb = __fsub_rn(vb, __fsub_rn(minVal, shb));
    __syncwarp();

    // augment along the alternating path ending at sink
    int j = sink;
    while (true) {
      const int pi = col_get(pra, prb, j);
      if (j == ca) r4ca = pi;
      if (j == cb) r4cb = pi;
      const int j_next = c4r[pi];
      __syncwarp();
      if (lane == 0) c4r[pi] = j;
      __syncwarp();
      if (pi == cur) break;
      j = j_next;
    }
  }

  for (int r = lane; r < N; r += 32) col4row_out[(int64_t)prob * N + r] = c4r[r];
}

}  // namespace mdt

using namespace mdt;

extern "C" {

// cost [n_problems, N, N] f32, row_valid [n_problems, N] uint8, col4row
// [n_problems, N] int32.  N <= 64.
int mdt_lap(void* cost, void* row_valid, void* col4row, int n_problems, int N, void* stream) {
  if (N < 1 || N > kLapMaxN || n_problems < 0) return (int)cudaErrorInvalidValue;
  if (n_problems == 0) return 0;
  const unsigned grid = (unsigned)((n_problems + kLapWarps - 1) / kLapWarps);
  lap_kernel<<<grid, kLapWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(row_valid),
      static_cast<int*>(col4row), n_problems, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
