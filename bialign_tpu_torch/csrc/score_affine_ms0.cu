// Affine score of one pair at max_shift 0 (K3), by two routes.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_ms0_kernel with its slab
// update _make_update_ms0, launched by _affine_pallas_ms0.  The recurrence
// (three live states, one predecessor cell each) is `AffineMs0` of
// csrc/affine_ms0_diag.cuh, which K7 (csrc/cta_scores_ms0.cu) shares.
//
// * One CTA (`bialign_score_affine_ms0`): K7's kernel `cta_ms0` of
//   csrc/cta_scores.cuh at B = 1 on the pair's own tables, the ring in
//   shared memory and the diagonal loop inside the kernel, one launch.  It
//   takes a pair of up to 4096 rows (n <= 4095), what one CTA holds.
// * One launch a diagonal (`bialign_score_affine_ms0_grid`), on the ring in
//   device memory, for the pairs beyond: one thread a (live state, row)
//   value, rows fastest, the tables read where a value needs them.  The
//   time is then the n+m+1 launches themselves, the host's launch rate.
// bialign_tpu_torch/ops/cuda_dp.py affine_ms0_last_slab picks the route by
// that size (cuda_dp.cta_fits) and raises for a forced one-CTA route that
// does not fit.  Either leaves the ring argument as the other does, the
// last diagonal in slab (n+m) % 3.  Not carried over from the TPU kernel:
// the chunk of diagonals per grid step, the bucketed diagonal count, the
// d_last scalar prefetch, the 128-lane padding, and the padding of the
// output back to nine states: the wrapper returns the max of the three
// states at row n.

#include <algorithm>
#include <cstring>

#include "affine_ms0_diag.cuh"
#include "cta_scores.cuh"

namespace bialign {
namespace {

constexpr int kMs0Block = 128;   // threads of a per-diagonal launch

// Diagonal d of the pair's ring [3, 3, n+1]: values t * L + r, live row
// lo + r of L.
__global__ void __launch_bounds__(kMs0Block)
    affine_ms0_diag(int32_t* ring, const int32_t* __restrict__ mu1,
                    const int32_t* __restrict__ mu2,
                    const __grid_constant__ AffineMs0Consts cs, int n, int m,
                    int d, int lo, int L) {
  const int x = blockIdx.x * kMs0Block + threadIdx.x;
  if (x >= AffineMs0::kStates * L) return;
  const int t = x / L, i = lo + x % L, j = d - i;
  const size_t slab = static_cast<size_t>(AffineMs0::kStates) * (n + 1);
  const long long at = static_cast<long long>(i) * (m + 1) + j;
  int32_t v = AffineMs0::outer(ring + slab_of<true>(d - 1) * slab,
                               ring + slab_of<true>(d - 2) * slab, n + 1, cs,
                               mu1[at], mu2[at], t, 0, 0, i, i, j, 0, 1);
  if (d == 0) v = AffineMs0::origin(t);          // the one row, i = 0
  ring[slab_of<true>(d) * slab + static_cast<size_t>(t) * (n + 1) + i] = v;
}

// Diagonals 0..n+m over the ring [3, 3, n+1] (any contents) on `stream`,
// one launch each; the last diagonal is left in slab (n+m) % 3.  `consts`
// (host memory) are the case constants.  Returns 0, or the first launch
// error as a cudaError_t value.
inline int run_ms0_diagonals(int32_t* ring, const int32_t* mu1,
                             const int32_t* mu2, const int32_t* consts,
                             int n, int m, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  AffineMs0Consts cs;
  std::memcpy(&cs, consts, sizeof cs);
  for (int d = 0; d <= n + m; ++d) {
    const int lo = std::max(0, d - m);
    const int L = std::min(n, d) - lo + 1;
    const int blocks = (AffineMs0::kStates * L + kMs0Block - 1) / kMs0Block;
    affine_ms0_diag<<<blocks, kMs0Block, 0, st>>>(ring, mu1, mu2, cs, n, m,
                                                  d, lo, L);
    BIALIGN_TRY(cudaGetLastError());
  }
  return 0;
}

}  // namespace
}  // namespace bialign

// Runs the recurrence on `stream` in one CTA, the ring [3, 3, n+1] (any
// contents) copied into shared memory and back; the last diagonal is left
// in slab (n+m) % 3.  `consts` (host memory): the constants [3, 3].
// Returns 0, or the first error as a cudaError_t value
// (cudaErrorInvalidValue for a pair of more than 4096 rows).
extern "C" int bialign_score_affine_ms0(int32_t* ring, const int32_t* mu1,
                                        const int32_t* mu2,
                                        const int32_t* consts, int n, int m,
                                        int device, void* stream) {
  return bialign::run_cta_ms0(ring, nullptr, mu1, mu2, nullptr, nullptr,
                              consts, 1, n, m, 0, device, stream);
}

// The same, one launch a diagonal over the ring in device memory.
extern "C" int bialign_score_affine_ms0_grid(int32_t* ring,
                                             const int32_t* mu1,
                                             const int32_t* mu2,
                                             const int32_t* consts, int n,
                                             int m, int device,
                                             void* stream) {
  return bialign::run_ms0_diagonals(ring, mu1, mu2, consts, n, m, device,
                                    stream);
}
