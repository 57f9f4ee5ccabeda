// Affine band fill of one pair (K1, band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_kernel (score_only=False)
// with its slab update _make_update, launched by _affine_pallas.  The
// kernel is csrc/affine_diag.cuh with band addressing (diagonal d is slab
// d of the band, which doubles as the carry); csrc/score_affine.cu is the
// same device function with ring addressing.  What bounds it and its
// design are written there.  The band writes do not bind (560 MB for the
// DNA-Pol-1 pair at max_shift 1, about 5 GB/s over the fill, on an H100
// 80GB HBM3 at 700 W), nor do the n+m+1 = 1862 launches (1.2 us apart, 2%
// of the fill).

#include "affine_diag.cuh"

// Fills band [n+m+1, 9, W, W, n+1] (pre-filled with INVALID) on `stream`.
// Returns 0, or the first launch error as a cudaError_t value.
extern "C" int bialign_fill_affine(int32_t* band, const int32_t* mu1,
                                   const int32_t* mu2, const int32_t* cases,
                                   int n, int m, int S, int device,
                                   void* stream) {
  return bialign::run_affine_diagonals<false>(band, mu1, mu2, cases, n, m, S,
                                              device, stream);
}
