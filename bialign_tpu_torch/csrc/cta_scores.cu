// Scores of a bucket of pairs, one CTA a pair with the carry in shared
// memory (K6), affine and non-affine.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_packed_batched_kernel, launched by
// _pallas_batched_packed (both recurrences, scores only).  The two forms
// are the kernel of csrc/cta_scores.cuh, which states the design and what
// was not carried over, instantiated with the tile kernels' per-value
// functions (`AffineTile`, `NonaffineTile` of csrc/tile_diag.cuh, the
// recurrence of K1/K4 and K2/K5).  Affine buckets at max_shift 0 go to
// csrc/cta_scores_ms0.cu (K7) instead.

#include "cta_scores.cuh"

// Scores of B >= 1 pairs into out [B], from the stacks mu1, mu2
// [B, N+1, M+1] and the lengths ns, ms [B]; `rings` is null or
// [B, 3, 9, W, W, N+1], any contents; `consts` (host memory) the case
// constants [9, 15]; `threads` a CTA's, 0 for the default.  Returns 0 or a
// cudaError_t value.
extern "C" int bialign_cta_affine(int32_t* rings, int32_t* out,
                                  const int32_t* mu1, const int32_t* mu2,
                                  const int32_t* ns, const int32_t* ms,
                                  const int32_t* consts, int B, int N, int M,
                                  int S, int threads, int device,
                                  void* stream) {
  return bialign::run_cta_scores<bialign::AffineTile>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, threads, device,
      stream);
}

// As bialign_cta_affine, `rings` being null or [B, 3, W, W, N+1] and
// `consts` [13].
extern "C" int bialign_cta_nonaffine(int32_t* rings, int32_t* out,
                                     const int32_t* mu1, const int32_t* mu2,
                                     const int32_t* ns, const int32_t* ms,
                                     const int32_t* consts, int B, int N,
                                     int M, int S, int threads, int device,
                                     void* stream) {
  return bialign::run_cta_scores<bialign::NonaffineTile>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, threads, device,
      stream);
}
