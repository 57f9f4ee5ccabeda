// Checkpointed non-affine score-only fill of one pair (K11).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_ckpt_kernel, launched
// by _nonaffine_pallas_ckpt.  The kernel is the tile kernel of
// csrc/tile_diag.cuh (`NonaffineTile`) with ring addressing, as in
// csrc/score_nonaffine.cu, under the host loop of csrc/ckpt_diag.cuh,
// where its bound and design are written.

#include "ckpt_diag.cuh"

// As bialign_ckpt_affine, on ring [3, W, W, n+1] and ckpts
// [NB, 2, W, W, n+1], with the int32 [13] case constants.
extern "C" int bialign_ckpt_nonaffine(int32_t* ring, int32_t* ckpts,
                                      const int32_t* mu1, const int32_t* mu2,
                                      const int32_t* consts, int n, int m,
                                      int S, int C, int device, void* stream) {
  return bialign::run_ckpt_diagonals<bialign::NonaffineTile>(
      ring, ckpts, mu1, mu2, consts, n, m, S, C, device, stream);
}
