// Affine score of one pair without a band (K1, score-only mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_kernel with
// score_only=True (out_ref[0] = val at d == d_last), launched by
// _affine_pallas.  The kernel is the tile kernel of csrc/tile_diag.cuh
// with ring addressing: diagonal d writes slab d % 3 of a ring
// [3, 9, W, W, n+1] in device memory and reads slabs (d-1) % 3 and
// (d-2) % 3, so the memory is three slabs whatever the length of the other
// sequence (902,988 B for the DNA-Pol-1 pair at max_shift 1, where the band
// is 560,454,552 B), and the ring stays in the 50 MB L2.
// csrc/fill_affine.cu is the same kernel with band addressing.  What bounds
// it and its design are written in csrc/tile_diag.cuh.
//
// Not carried over from the TPU kernel: the chunk of G diagonals per grid
// step, the bucketed diagonal count with its garbage tail, the d_last
// scalar prefetch and the padding of rows to 128 lanes.  The host loop
// stops at d = n+m, and the wrapper reads the score from slab (n+m) % 3:
// the max over the 9 states at (S, S, n).

#include "tile_diag.cuh"

// Runs the recurrence over ring [3, 9, W, W, n+1] (any contents) on
// `stream`; the last diagonal is left in slab (n+m) % 3.  `consts`: the
// int32 [9, 15] case constants in host memory.  Returns 0, or the first
// launch error as a cudaError_t value.
extern "C" int bialign_score_affine(int32_t* ring, const int32_t* mu1,
                                    const int32_t* mu2, const int32_t* consts,
                                    int n, int m, int S, int device,
                                    void* stream) {
  return bialign::run_diagonals<bialign::AffineTile, true>(
      ring, mu1, mu2, consts, n, m, S, device, stream);
}
