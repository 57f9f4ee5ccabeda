// Affine score of one pair at max_shift 0 (K3).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_ms0_kernel with its slab
// update _make_update_ms0 and the tables of _ms0_live_tables, launched by
// _affine_pallas_ms0.  At max_shift 0 the shift band collapses to one
// position, so a column must advance both alignment copies in lockstep:
// only the three synchronised states (0,1,0,1), (1,0,1,0), (1,1,1,1) are
// reachable, and the half columns of groups B and C are dead.  What is
// left is a max over the three live source states of one predecessor cell,
// per live target state.  Equal to csrc/score_affine.cu at max_shift 0 in
// the score, not slab for slab: the six dead states are not computed.  A
// failed guard gives NEG_INF at once (there is no INVALID mask to merge
// with another group), and the origin gets 0 for the both-match state and
// NEG_INF for the other two.
//
// What bounds it: nothing on the card.  A thread does nine loads and three
// stores, a diagonal has at most n+1 threads, so a launch is over before
// the next one can be issued; the time is the n+m+1 launches themselves
// (PERF.md, Findings).  By bytes and operations the bound is microseconds
// (the two tables read once).
//
// Design: as csrc/affine_diag.cuh without the shift axes.  A ring of three
// slabs [3, 3, n+1] in device memory (diagonal d in slab d % 3), one launch
// per diagonal, one thread per live lattice row i; rows are the last axis,
// so a warp's accesses are coalesced.  A guard (i >= a, j >= b) makes its
// predecessor a live row of its own diagonal, so the stale rows of the ring
// are never read.  Not carried over from the TPU kernel: the chunk of
// diagonals per grid step, the bucketed diagonal count, the d_last scalar
// prefetch, the 128-lane padding, and the padding of the output back to
// nine states: the wrapper returns the max of the three states at row n.

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kBlock = 128;
constexpr int LIVE = 3;   // live states at max_shift 0

// One packed live target state (cuda_dp.ms0_case_table): its column's
// sequence advances (a, b), its mu1/mu2 multiplicities, and the constant of
// each live source state.
enum Ms0Field {
  MS0_A = 0, MS0_B, MS0_MU1C, MS0_MU2C, MS0_CST, MS0_REC = MS0_CST + LIVE
};

__global__ void affine_ms0_diag(int32_t* ring, const int32_t* __restrict__ mu1,
                                const int32_t* __restrict__ mu2,
                                const int32_t* __restrict__ cases, int n,
                                int m, int d, int lo, int hi) {
  __shared__ int32_t tab[LIVE * MS0_REC];
  if (threadIdx.x < LIVE * MS0_REC) tab[threadIdx.x] = cases[threadIdx.x];
  __syncthreads();

  const int i = lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (i > hi) return;
  const int j = d - i;
  const int P = n + 1;
  const long long at = (long long)i * (m + 1) + j;
  const int32_t m1 = mu1[at];
  const int32_t m2 = mu2[at];   // (k, l) = (i, j) at max_shift 0
  int32_t* here = ring + (long long)slab_of<true>(d) * LIVE * P;

  for (int t = 0; t < LIVE; ++t) {
    const int32_t* ct = tab + t * MS0_REC;
    const int a = ct[MS0_A], b = ct[MS0_B];
    int32_t val = NEG_INF;
    if (i >= a && j >= b) {
      const int32_t* pred =
          ring + (long long)slab_of<true>(d - a - b) * LIVE * P + (i - a);
      int32_t agg = pred[0] + ct[MS0_CST];
      for (int s = 1; s < LIVE; ++s)
        agg = max(agg, pred[(long long)s * P] + ct[MS0_CST + s]);
      val = agg + ct[MS0_MU1C] * m1 + ct[MS0_MU2C] * m2;
    }
    if (d == 0 && i == 0) val = (a & b) ? 0 : NEG_INF;   // the origin
    here[(long long)t * P + i] = val;
  }
}

}  // namespace
}  // namespace bialign

// Runs the recurrence over ring [3, 3, n+1] (any contents) on `stream`;
// the last diagonal is left in slab (n+m) % 3.  Returns 0, or the first
// launch error as a cudaError_t value.
extern "C" int bialign_score_affine_ms0(int32_t* ring, const int32_t* mu1,
                                        const int32_t* mu2,
                                        const int32_t* cases, int n, int m,
                                        int device, void* stream) {
  using namespace bialign;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int d = 0; d <= n + m; ++d) {
    const int lo = std::max(0, d - m);
    const int hi = std::min(n, d);
    const int blocks = (hi - lo + 1 + kBlock - 1) / kBlock;
    affine_ms0_diag<<<blocks, kBlock, 0, st>>>(ring, mu1, mu2, cases, n, m, d,
                                               lo, hi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
