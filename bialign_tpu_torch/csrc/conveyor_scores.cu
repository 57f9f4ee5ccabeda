// Scores of a bucket of pairs streamed through a few rings, one launch per
// step (K8), affine and non-affine.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_conveyor_kernel, launched by
// _conveyor_run under _pallas_batched_conveyor (both recurrences, scores
// only).  The two forms are the kernel of csrc/conveyor.cuh, which states
// the design and what was not carried over, instantiated with the tiles of
// csrc/tile_diag.cuh (`AffineTile`, the recurrence of K1 and K4;
// `NonaffineTile`, that of K2 and K5).

#include "conveyor.cuh"

// Scores of B >= 1 pairs into out [B], over rings [lanes, 3, 9, W, W, N+1]
// (any contents), from the stacks mu1, mu2 [B, N+1, M+1] and the lengths
// ns, ms [B]; T0 steps between the pairs of a lane, no diagonal beyond
// d_max.  `consts`: the int32 [9, 15] case constants in host memory.
// Returns 0, or the first CUDA error as a cudaError_t value.
extern "C" int bialign_conveyor_affine(int32_t* rings, int32_t* out,
                                       const int32_t* mu1, const int32_t* mu2,
                                       const int32_t* ns, const int32_t* ms,
                                       const int32_t* consts, int B, int N,
                                       int M, int S, int lanes, int T0,
                                       int d_max, int device, void* stream) {
  return bialign::run_conveyor<bialign::AffineTile>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, lanes, T0, d_max,
      device, stream);
}

// As bialign_conveyor_affine, `rings` being [lanes, 3, W, W, N+1] and
// `consts` the int32 [13] non-affine constants.
extern "C" int bialign_conveyor_nonaffine(int32_t* rings, int32_t* out,
                                          const int32_t* mu1,
                                          const int32_t* mu2,
                                          const int32_t* ns, const int32_t* ms,
                                          const int32_t* consts, int B, int N,
                                          int M, int S, int lanes, int T0,
                                          int d_max, int device,
                                          void* stream) {
  return bialign::run_conveyor<bialign::NonaffineTile>(
      rings, out, mu1, mu2, ns, ms, consts, B, N, M, S, lanes, T0, d_max,
      device, stream);
}
