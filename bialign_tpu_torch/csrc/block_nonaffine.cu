// Non-affine band of one block of C diagonals, from its checkpoint (K12).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_block_kernel, launched
// by _nonaffine_pallas_block.  The kernel is csrc/nonaffine_diag.cuh with
// band addressing, as in csrc/fill_nonaffine.cu, on a window under the
// host loop of csrc/ckpt_diag.cuh, where its bound and design are written.

#include "ckpt_diag.cuh"
#include "nonaffine_diag.cuh"

// As bialign_block_affine, on window [C+2, W, W, n+1] and ck
// [2, W, W, n+1].
extern "C" int bialign_block_nonaffine(int32_t* window, const int32_t* ck,
                                       const int32_t* mu1, const int32_t* mu2,
                                       const int32_t* cases, int n, int m,
                                       int S, int d0, int C, int device,
                                       void* stream) {
  return bialign::run_block_diagonals(
      bialign::nonaffine_diag<false>, bialign::Nonaffine::cells(S), window,
      ck, mu1, mu2, cases, n, m, S, d0, C, device, stream);
}
