// Non-affine band fill of one pair (K2, band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_kernel
// (score_only=False) with its slab update _make_nonaffine_update, launched
// by _nonaffine_pallas.  The kernel is the tile kernel of
// csrc/tile_diag.cuh (`NonaffineTile`) with band addressing (the band
// doubles as the carry); csrc/score_nonaffine.cu is the same kernel with
// ring addressing.  What bounds it and its design are written there.
// Neither the band writes (173 MB for the DNA-Pol-1 pair at the CLI's
// max_shift 2) nor the bytes of the tables bind.

#include "tile_diag.cuh"

// Fills band [n+m+1, W, W, n+1] (pre-filled with INVALID, or any contents)
// on `stream`; `consts`: the int32 [13] case constants in host memory.
// Returns 0, or the first launch error as a cudaError_t value.
extern "C" int bialign_fill_nonaffine(int32_t* band, const int32_t* mu1,
                                      const int32_t* mu2,
                                      const int32_t* consts, int n, int m,
                                      int S, int device, void* stream) {
  return bialign::run_diagonals<bialign::NonaffineTile, false>(
      band, mu1, mu2, consts, n, m, S, device, stream);
}
