// Affine band of one block of C diagonals, from its checkpoint (K10).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_block_kernel, launched by
// _affine_pallas_block: the band [C, 9, W, W, P] of diagonals d0..d0+C-1
// recomputed from the two slabs that entered the block.  The kernel is the
// tile kernel of csrc/tile_diag.cuh with band addressing, as in
// csrc/fill_affine.cu, on a window whose base the host loop of
// csrc/ckpt_diag.cuh moves back by d0-2 slabs; the checkpoint's slabs are
// copied into the window's first two, so the blockwise walk reads one
// array.  Bound and design: csrc/ckpt_diag.cuh.

#include "ckpt_diag.cuh"

// Fills slabs 2.. of window [C+2, 9, W, W, n+1] (any contents) with
// diagonals d0..min(d0+C-1, n+m) on `stream`; slabs 0 and 1 become ck[1]
// and ck[0] (diagonals d0-2, d0-1) unless d0 == 0.  `consts`: the int32
// [9, 15] case constants in host memory.  Returns 0, or the first CUDA
// error.
extern "C" int bialign_block_affine(int32_t* window, const int32_t* ck,
                                    const int32_t* mu1, const int32_t* mu2,
                                    const int32_t* consts, int n, int m,
                                    int S, int d0, int C, int device,
                                    void* stream) {
  return bialign::run_block_diagonals<bialign::AffineTile>(
      window, ck, mu1, mu2, consts, n, m, S, d0, C, device, stream);
}
