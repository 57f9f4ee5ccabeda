// Scores of a bucket of pairs streamed through a few rings, one launch per
// step (K8), affine and non-affine.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_conveyor_kernel, launched by
// _conveyor_run under _pallas_batched_conveyor (both recurrences, scores
// only).  The two forms are the kernel of csrc/conveyor.cuh, which states
// the design and what was not carried over, instantiated with `Affine::row`
// of csrc/affine_diag.cuh (the recurrence of K1, K4 and K6) and
// `Nonaffine::row` of csrc/nonaffine_diag.cuh (K2, K5 and K6).

#include "affine_diag.cuh"
#include "conveyor.cuh"
#include "nonaffine_diag.cuh"

// Scores of B >= 1 pairs into out [B], over rings [lanes, 3, 9, W, W, N+1]
// (any contents), from the stacks mu1, mu2 [B, N+1, M+1] and the lengths
// ns, ms [B]; T0 steps between the pairs of a lane, no diagonal beyond
// d_max.  Returns 0, or the first launch error as a cudaError_t value.
extern "C" int bialign_conveyor_affine(int32_t* rings, int32_t* out,
                                       const int32_t* mu1, const int32_t* mu2,
                                       const int32_t* ns, const int32_t* ms,
                                       const int32_t* cases, int B, int N,
                                       int M, int S, int lanes, int T0,
                                       int d_max, int device, void* stream) {
  return bialign::run_conveyor<bialign::Affine>(rings, out, mu1, mu2, ns, ms,
                                                cases, B, N, M, S, lanes, T0,
                                                d_max, device, stream);
}

// As bialign_conveyor_affine, `rings` being [lanes, 3, W, W, N+1].
extern "C" int bialign_conveyor_nonaffine(int32_t* rings, int32_t* out,
                                          const int32_t* mu1,
                                          const int32_t* mu2,
                                          const int32_t* ns, const int32_t* ms,
                                          const int32_t* cases, int B, int N,
                                          int M, int S, int lanes, int T0,
                                          int d_max, int device,
                                          void* stream) {
  return bialign::run_conveyor<bialign::Nonaffine>(
      rings, out, mu1, mu2, ns, ms, cases, B, N, M, S, lanes, T0, d_max,
      device, stream);
}
