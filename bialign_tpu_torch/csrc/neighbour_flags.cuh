// Progress flags between the CTAs of one resident launch (routes
// "resident" of csrc/seqsplit.cu, csrc/triplet.cu and K3's
// csrc/score_affine_ms0.cu), and between launches on cards that reach
// each other's memory.  A CTA publishes, with a release store, how far it
// has come; a neighbour acquires it before it reads what that CTA wrote or
// overwrites what that CTA still reads.  The scope is the card (.gpu) when
// both CTAs are on one card, the system (.sys) when the flag or the data
// lies on a peer card.  In the split the release is one thread's, after a
// __syncthreads() of its CTA, and the acquire one thread's, before one:
// the pattern of CUTLASS's semaphore, under which the other threads' stores
// before the barrier are ordered before the release, and their loads after
// the barrier after the acquire (whose load also drops the SM's stale L1
// lines).  In the triplet's and K3's routes the thread that stored the
// data releases it itself, and the thread that reads it acquires it itself:
// no barrier is needed on either side.
//
// Every wait has a budget on the global timer: a flag that never comes
// (a neighbour that faulted, a launch that never started) writes the fault
// word, which lies in host memory mapped for the card, and traps, so that
// the next synchronisation fails instead of the card hanging.  Included as
// <neighbour_flags.cuh>, so that tests/cuda_host supplies its own for the
// host build.
#pragma once

#include <cstdint>

namespace bialign {
namespace {  // one copy a source: several sources include this header

// nanoseconds a CTA waits for one flag before it traps
constexpr uint64_t kSpinBudgetNs = 5000000000ull;

__device__ __forceinline__ int32_t flag_acquire(const int32_t* p, bool sys) {
  int32_t v;
  if (sys)
    asm volatile("ld.global.acquire.sys.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void flag_release(int32_t* p, int32_t v,
                                             bool sys) {
  if (sys)
    asm volatile("st.global.release.sys.b32 [%0], %1;\n"
                 :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("st.global.release.gpu.b32 [%0], %1;\n"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t flag_clock_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// The fault word [4]: 1, the CTA, the diagonal, which wait (1 the CTA
// above, 2 the one below); then the trap.
__device__ __noinline__ void flag_fault(int32_t* fault, int d, int which) {
  if (fault != nullptr) {
    volatile int32_t* f = fault;
    f[1] = static_cast<int32_t>(blockIdx.x);
    f[2] = d;
    f[3] = which;
    __threadfence_system();
    f[0] = 1;
    __threadfence_system();
  }
  __trap();
}

// Until *flag >= want, within the budget; returns the value acquired last.
__device__ __forceinline__ int32_t flag_wait(const int32_t* flag,
                                             int32_t want, bool sys,
                                             int32_t* fault, int d,
                                             int which) {
  int32_t v = flag_acquire(flag, sys);
  if (v >= want) return v;
  const uint64_t t0 = flag_clock_ns();
  while ((v = flag_acquire(flag, sys)) < want)
    if (flag_clock_ns() - t0 > kSpinBudgetNs) flag_fault(fault, d, which);
  return v;
}

}  // namespace
}  // namespace bialign
