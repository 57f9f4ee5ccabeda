// Affine band fill of one pair (K1, band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_kernel (score_only=False)
// with its slab update _make_update, launched by _affine_pallas.  The
// kernel is the tile kernel of csrc/tile_diag.cuh with band addressing
// (diagonal d is slab d of the band, which doubles as the carry);
// csrc/score_affine.cu is the same kernel with ring addressing.  What
// bounds it and its design are written there.  The band writes do not
// bind (560 MB for the DNA-Pol-1 pair at max_shift 1, 0.17 ms at the
// card's memory rate); one launch a diagonal, n+m+1 = 1862 there.

#include "tile_diag.cuh"

// Fills band [n+m+1, 9, W, W, n+1] (pre-filled with INVALID, or any
// contents: only a diagonal's live rows are written) on `stream`; `consts`
// are the int32 [9, 15] case constants in host memory.  Returns 0, or the
// first launch error as a cudaError_t value.
extern "C" int bialign_fill_affine(int32_t* band, const int32_t* mu1,
                                   const int32_t* mu2, const int32_t* consts,
                                   int n, int m, int S, int device,
                                   void* stream) {
  return bialign::run_diagonals<bialign::AffineTile, false>(
      band, mu1, mu2, consts, n, m, S, device, stream);
}
