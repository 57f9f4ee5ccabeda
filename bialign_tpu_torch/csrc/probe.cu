// A pointer-chase probe: the latency of one dependent load from device
// memory or from the L2, the floor under a chain of dependent steps such as
// the traceback walks' (csrc/walk.cu), where each step's address is known
// only once the step before it has read its cell.  Launched only by
// chip_smoke.py (the walks' chain floor, PERF.md §6); no path of the
// package calls it.

#include "common.cuh"

namespace bialign {
namespace {

// One thread follows `next` from index 0 for `hops` loads, each through the
// L2 (not the L1), and leaves the last index in `sink`, so that no load is
// dropped.
__global__ void chase(const int32_t* next, int hops, int32_t* sink) {
  int32_t at = 0;
  for (int h = 0; h < hops; ++h) at = __ldcg(next + at);
  *sink = at;
}

}  // namespace
}  // namespace bialign

// `hops` dependent loads through `next` (a cycle of indices) on `stream`.
extern "C" int bialign_probe_chase(const int32_t* next, int hops,
                                   int32_t* sink, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  bialign::chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, hops,
                                                                 sink);
  return static_cast<int>(cudaGetLastError());
}
