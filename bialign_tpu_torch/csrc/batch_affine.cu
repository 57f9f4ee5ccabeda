// Affine scores, or bands and scores, of a bucket of pairs, one launch per
// diagonal (K4, score mode and band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_batched_kernel, launched by
// _affine_pallas_batched: grid (B, D/G) with each pair's n and m as
// scalars, the score captured at d = n_b + m_b, row n_b (score_only=True),
// or every diagonal's slab written to the pair's band for the batched walk
// (score_only=False).  Here the recurrence is the tile of K1
// (`AffineTile`, `fill_tile` of csrc/tile_diag.cuh), a pair's tile a CTA,
// under the bucket kernel of csrc/batch_diag.cuh, which states the design;
// at max_shift 0 it runs all nine states, as the TPU route does off the
// packed kernel.

#include "batch_diag.cuh"

// Scores of B >= 1 pairs into out [B], over rings [B, 3, 9, W, W, N+1] (any
// contents), from the stacks mu1, mu2 [B, N+1, M+1] and the lengths ns, ms
// [B]; diagonals 0..d_max run.  `consts`: the int32 [9, 15] case constants
// in host memory.  Returns 0, or the first CUDA error as a cudaError_t
// value.
extern "C" int bialign_batch_affine(int32_t* rings, int32_t* out,
                                    const int32_t* mu1, const int32_t* mu2,
                                    const int32_t* ns, const int32_t* ms,
                                    const int32_t* consts, int B, int N, int M,
                                    int S, int d_max, int device,
                                    void* stream) {
  return bialign::run_batch_diagonals<bialign::AffineTile, true>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, d_max, device,
      stream);
}

// Band mode: fills bands [B, min(d_max, N+M) + 1, 9, W, W, N+1] (any
// contents; only a pair's live rows of its own diagonals are written) and
// the scores out [B], from the same stacks, lengths and constants.
extern "C" int bialign_batch_fill_affine(int32_t* bands, int32_t* out,
                                         const int32_t* mu1,
                                         const int32_t* mu2, const int32_t* ns,
                                         const int32_t* ms,
                                         const int32_t* consts, int B, int N,
                                         int M, int S, int d_max, int device,
                                         void* stream) {
  return bialign::run_batch_diagonals<bialign::AffineTile, false>(
      bands, out, mu1, mu2, ns, ms, consts, B, N, M, S, d_max, device,
      stream);
}
