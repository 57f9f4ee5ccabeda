// Affine scores of a bucket of pairs at max_shift 0, one CTA a pair with
// the carry in shared memory (K7).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_packed_ms0_kernel, launched by
// _pallas_batched_packed (the packed form of K3, slab [3, 8, 128]).  It is
// the kernel `cta_ms0` of csrc/cta_scores.cuh, which states the design,
// over the three live states of csrc/affine_ms0_diag.cuh: a ring of
// [3, 3, N+1], 36 bytes a row, a thread up to four rows.  K3
// (csrc/score_affine_ms0.cu) launches the same kernel for one pair.

#include "cta_scores.cuh"

// Scores of B >= 1 pairs into out [B], from the stacks mu1, mu2
// [B, N+1, M+1] and the lengths ns, ms [B]; `rings` is null or
// [B, 3, 3, N+1], any contents; `consts` (host memory) the constants
// [3, 3]; `threads` a CTA's, 0 for one a row up to 1024, at least a
// quarter of N+1.  Returns 0 or a cudaError_t value.
extern "C" int bialign_cta_affine_ms0(int32_t* rings, int32_t* out,
                                      const int32_t* mu1, const int32_t* mu2,
                                      const int32_t* ns, const int32_t* ms,
                                      const int32_t* consts, int B, int N,
                                      int M, int threads, int device,
                                      void* stream) {
  return bialign::run_cta_ms0(rings, out, mu1, mu2, ns, ms, consts, B, N, M,
                              threads, device, stream);
}
