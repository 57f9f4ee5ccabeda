// Checkpointed affine score-only fill of one pair (K9).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_ckpt_kernel, launched by
// _affine_pallas_ckpt: the score-only fill that also writes, every C
// diagonals, the two slabs entering the next block.  The kernel is the
// tile kernel of csrc/tile_diag.cuh with ring addressing, as in
// csrc/score_affine.cu; the host loop of csrc/ckpt_diag.cuh adds the two
// device-to-device copies per block.  At max_shift 0 it runs the general
// recurrence too, as the TPU package does (there is no checkpointing form
// of K3).  What bounds it and what was not carried over are written in
// csrc/ckpt_diag.cuh.

#include "ckpt_diag.cuh"

// Runs the recurrence over ring [3, 9, W, W, n+1] (any contents) on
// `stream`, saving ckpts [NB, 2, 9, W, W, n+1], NB = (n+m)/C + 1: ckpts[b]
// = the slabs of diagonals (b*C-1, b*C-2) for b >= 1.  The last diagonal is
// left in slab (n+m) % 3.  `consts`: the int32 [9, 15] case constants in
// host memory.  Returns 0, or the first CUDA error.
extern "C" int bialign_ckpt_affine(int32_t* ring, int32_t* ckpts,
                                   const int32_t* mu1, const int32_t* mu2,
                                   const int32_t* consts, int n, int m, int S,
                                   int C, int device, void* stream) {
  return bialign::run_ckpt_diagonals<bialign::AffineTile>(
      ring, ckpts, mu1, mu2, consts, n, m, S, C, device, stream);
}
