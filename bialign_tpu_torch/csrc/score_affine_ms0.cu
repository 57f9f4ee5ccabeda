// Affine score of one pair at max_shift 0 (K3).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_ms0_kernel with its slab
// update _make_update_ms0, launched by _affine_pallas_ms0.  The recurrence
// (three live states, one predecessor cell each) is the device function of
// csrc/affine_ms0_diag.cuh, which csrc/cta_scores_ms0.cu (K7) shares.
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
// so a warp's accesses are coalesced.  Not carried over from the TPU
// kernel: the chunk of diagonals per grid step, the bucketed diagonal
// count, the d_last scalar prefetch, the 128-lane padding, and the padding
// of the output back to nine states: the wrapper returns the max of the
// three states at row n.

#include <algorithm>

#include "affine_ms0_diag.cuh"

namespace bialign {
namespace {

__global__ void affine_ms0_diag(int32_t* ring, const int32_t* __restrict__ mu1,
                                const int32_t* __restrict__ mu2,
                                const int32_t* __restrict__ cases, int n,
                                int m, int d, int lo, int hi) {
  __shared__ int32_t tab[AffineMs0::kTable];
  load_table(tab, cases, AffineMs0::kTable);
  const int i = lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (i > hi) return;
  AffineMs0::row<true>(ring, tab, mu1, mu2, n, m, m + 1, n + 1, 0, d, i);
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
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int d = 0; d <= n + m; ++d) {
    const int lo = std::max(0, d - m);
    const int hi = std::min(n, d);
    const int blocks = (hi - lo + kRowBlock) / kRowBlock;
    affine_ms0_diag<<<blocks, kRowBlock, 0, st>>>(ring, mu1, mu2, cases, n, m,
                                                  d, lo, hi);
    BIALIGN_TRY(cudaGetLastError());
  }
  return 0;
}
