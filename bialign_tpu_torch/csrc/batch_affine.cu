// Affine scores, or bands and scores, of a bucket of pairs, one launch per
// diagonal (K4, score mode and band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_batched_kernel, launched by
// _affine_pallas_batched: grid (B, D/G) with each pair's n and m as
// scalars, the score captured at d = n_b + m_b, row n_b (score_only=True),
// or every diagonal's slab written to the pair's band for the batched walk
// (score_only=False).  Here the recurrence is `Affine::row` of csrc/affine_diag.cuh (the
// one K1 and K6 run) under the bucket kernel of csrc/batch_diag.cuh, which
// states the design; at max_shift 0 it runs all nine states, as the TPU
// route does off the packed kernel.

#include "affine_diag.cuh"
#include "batch_diag.cuh"

// Scores of B >= 1 pairs into out [B], over rings [B, 3, 9, W, W, N+1] (any
// contents), from the stacks mu1, mu2 [B, N+1, M+1] and the lengths ns, ms
// [B]; diagonals 0..d_max run.  Returns 0, or the first launch error as a
// cudaError_t value.
extern "C" int bialign_batch_affine(int32_t* rings, int32_t* out,
                                    const int32_t* mu1, const int32_t* mu2,
                                    const int32_t* ns, const int32_t* ms,
                                    const int32_t* cases, int B, int N, int M,
                                    int S, int d_max, int device,
                                    void* stream) {
  return bialign::run_batch_diagonals<bialign::Affine, true>(
      rings, out, mu1, mu2, ns, ms, cases, B, N, M, S, d_max, device, stream);
}

// Band mode: fills bands [B, min(d_max, N+M) + 1, 9, W, W, N+1] (any
// contents; only a pair's live rows of its own diagonals are written) and
// the scores out [B], from the same stacks and lengths.
extern "C" int bialign_batch_fill_affine(int32_t* bands, int32_t* out,
                                         const int32_t* mu1,
                                         const int32_t* mu2, const int32_t* ns,
                                         const int32_t* ms,
                                         const int32_t* cases, int B, int N,
                                         int M, int S, int d_max, int device,
                                         void* stream) {
  return bialign::run_batch_diagonals<bialign::Affine, false>(
      bands, out, mu1, mu2, ns, ms, cases, B, N, M, S, d_max, device, stream);
}
