// Scores of a bucket of pairs, one CTA per pair with the carry in shared
// memory (K6), affine and non-affine.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_packed_batched_kernel, launched by
// _pallas_batched_packed (both recurrences, scores only).  The two forms
// are the kernel of csrc/cta_scores.cuh, which states the design and what
// was not carried over, instantiated with `Affine::row` of
// csrc/affine_diag.cuh (the recurrence of K1 and K4) and `Nonaffine::row`
// of csrc/nonaffine_diag.cuh (K2 and K5).  Affine buckets at max_shift 0
// go to csrc/cta_scores_ms0.cu (K7) instead.

#include "affine_diag.cuh"
#include "cta_scores.cuh"
#include "nonaffine_diag.cuh"

// Scores of B >= 1 pairs into out [B], from the stacks mu1, mu2
// [B, N+1, M+1] and the lengths ns, ms [B]; `rings` is null or
// [B, 3, 9, W, W, N+1], any contents.  Returns 0 or a cudaError_t value.
extern "C" int bialign_cta_affine(const int32_t* rings, int32_t* out,
                                  const int32_t* mu1, const int32_t* mu2,
                                  const int32_t* ns, const int32_t* ms,
                                  const int32_t* cases, int B, int N, int M,
                                  int S, int device, void* stream) {
  return bialign::run_cta_scores<bialign::Affine>(
      rings, out, mu1, mu2, ns, ms, cases, B, N, M, S, device, stream);
}

// As bialign_cta_affine, `rings` being null or [B, 3, W, W, N+1].
extern "C" int bialign_cta_nonaffine(const int32_t* rings, int32_t* out,
                                     const int32_t* mu1, const int32_t* mu2,
                                     const int32_t* ns, const int32_t* ms,
                                     const int32_t* cases, int B, int N,
                                     int M, int S, int device, void* stream) {
  return bialign::run_cta_scores<bialign::Nonaffine>(
      rings, out, mu1, mu2, ns, ms, cases, B, N, M, S, device, stream);
}
