// Non-affine scores, or bands and scores, of a bucket of pairs, one launch
// per diagonal (K5, score mode and band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_batched_kernel, launched
// by _nonaffine_pallas_batched, with score_only=True (the scores) and with
// score_only=False (every pair's band, for the batched walk).  The
// recurrence is the tile of K2 (`NonaffineTile` of csrc/tile_diag.cuh)
// under the bucket kernel of csrc/batch_diag.cuh, which states the design.

#include "batch_diag.cuh"

// Scores of B >= 1 pairs into out [B], over rings [B, 3, W, W, N+1] (any
// contents), from the stacks mu1, mu2 [B, N+1, M+1] and the lengths ns, ms
// [B]; diagonals 0..d_max run.  `consts`: the int32 [13] case constants in
// host memory.  Returns 0, or the first CUDA error as a cudaError_t value.
extern "C" int bialign_batch_nonaffine(int32_t* rings, int32_t* out,
                                       const int32_t* mu1, const int32_t* mu2,
                                       const int32_t* ns, const int32_t* ms,
                                       const int32_t* consts, int B, int N,
                                       int M, int S, int d_max, int device,
                                       void* stream) {
  return bialign::run_batch_diagonals<bialign::NonaffineTile, true>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, d_max, device,
      stream);
}

// Band mode: fills bands [B, min(d_max, N+M) + 1, W, W, N+1] (any contents;
// only a pair's live rows of its own diagonals are written) and the scores
// out [B], from the same stacks, lengths and constants.
extern "C" int bialign_batch_fill_nonaffine(
    int32_t* bands, int32_t* out, const int32_t* mu1, const int32_t* mu2,
    const int32_t* ns, const int32_t* ms, const int32_t* consts, int B, int N,
    int M, int S, int d_max, int device, void* stream) {
  return bialign::run_batch_diagonals<bialign::NonaffineTile, false>(
      bands, out, mu1, mu2, ns, ms, consts, B, N, M, S, d_max, device,
      stream);
}
