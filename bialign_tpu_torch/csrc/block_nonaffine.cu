// Non-affine band of one block of C diagonals, from its checkpoint (K12).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_block_kernel, launched
// by _nonaffine_pallas_block.  The kernel is the tile kernel of
// csrc/tile_diag.cuh (`NonaffineTile`) with band addressing, as in
// csrc/fill_nonaffine.cu, on a window under the host loop of
// csrc/ckpt_diag.cuh, where its bound and design are written.

#include "ckpt_diag.cuh"

// As bialign_block_affine, on window [C+2, W, W, n+1] and ck
// [2, W, W, n+1], with the int32 [13] case constants.
extern "C" int bialign_block_nonaffine(int32_t* window, const int32_t* ck,
                                       const int32_t* mu1, const int32_t* mu2,
                                       const int32_t* consts, int n, int m,
                                       int S, int d0, int C, int device,
                                       void* stream) {
  return bialign::run_block_diagonals<bialign::NonaffineTile>(
      window, ck, mu1, mu2, consts, n, m, S, d0, C, device, stream);
}
