// Checkpointed non-affine score-only fill of one pair (K11).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_ckpt_kernel, launched
// by _nonaffine_pallas_ckpt.  The kernel is csrc/nonaffine_diag.cuh with
// ring addressing, as in csrc/score_nonaffine.cu, under the host loop of
// csrc/ckpt_diag.cuh, where its bound and design are written.

#include "ckpt_diag.cuh"
#include "nonaffine_diag.cuh"

// As bialign_ckpt_affine, on ring [3, W, W, n+1] and ckpts
// [NB, 2, W, W, n+1].
extern "C" int bialign_ckpt_nonaffine(int32_t* ring, int32_t* ckpts,
                                      const int32_t* mu1, const int32_t* mu2,
                                      const int32_t* cases, int n, int m,
                                      int S, int C, int device, void* stream) {
  return bialign::run_ckpt_diagonals(
      bialign::nonaffine_diag<true>, bialign::Nonaffine::cells(S), ring,
      ckpts, mu1, mu2, cases, n, m, S, C, device, stream);
}
