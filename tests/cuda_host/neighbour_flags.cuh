// Host stand-in for csrc/neighbour_flags.cuh: a flag's acquire load and
// release store are std::atomic_ref operations of those memory orders on
// the flag (the scope, card or system, is one here), the global timer the
// host's steady clock, the trap host_trap() (cuda_runtime.h here).
//
// Three test hooks.  host_flag_delays(p, seed): a thread that waits for a
// flag or publishes one first sleeps, with probability p percent, for
// 0-200 us, drawn from a generator of the seed and its CTA, so that CTAs
// run ahead of and behind each other in ever other orders.
// host_flag_drop(cta, level): CTA `cta` of every launch publishes nothing
// from progress `level` on (a flag that never comes).  host_spin_budget_ms:
// the wait's budget (default the card's).
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <random>
#include <thread>

#include "cuda_runtime.h"

namespace bialign {

inline std::atomic<int> host_delay_percent{0};
inline std::atomic<unsigned> host_delay_seed{0};
inline std::atomic<int> host_drop_cta{-1}, host_drop_level{0};
inline std::atomic<uint64_t> host_budget_ns{5000000000ull};

extern "C" __attribute__((used, visibility("default"))) inline void
host_flag_delays(int percent, unsigned seed) {
  host_delay_percent = percent;
  host_delay_seed = seed;
}
extern "C" __attribute__((used, visibility("default"))) inline void
host_flag_drop(int cta, int level) {
  host_drop_cta = cta;
  host_drop_level = level;
}
extern "C" __attribute__((used, visibility("default"))) inline void
host_spin_budget_ms(int ms) {
  host_budget_ns = static_cast<uint64_t>(ms) * 1000000ull;
}

inline void host_flag_delay() {
  const int percent = host_delay_percent.load();
  if (percent <= 0) return;
  thread_local std::mt19937 rng;
  thread_local unsigned seeded = 0;
  const unsigned want = host_delay_seed.load() * 7919u + blockIdx.x + 1;
  if (seeded != want) {
    rng.seed(want);
    seeded = want;
  }
  if (static_cast<int>(rng() % 100) < percent)
    std::this_thread::sleep_for(std::chrono::microseconds(rng() % 200));
}

inline int32_t flag_acquire(const int32_t* p, bool) {
  return std::atomic_ref<int32_t>(*const_cast<int32_t*>(p))
      .load(std::memory_order_acquire);
}

inline void flag_release(int32_t* p, int32_t v, bool) {
  host_flag_delay();
  if (static_cast<int>(blockIdx.x) == host_drop_cta.load() &&
      v >= host_drop_level.load())
    return;
  std::atomic_ref<int32_t>(*p).store(v, std::memory_order_release);
}

inline uint64_t flag_clock_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

inline void flag_fault(int32_t* fault, int d, int which) {
  if (fault != nullptr) {
    fault[1] = static_cast<int32_t>(blockIdx.x);
    fault[2] = d;
    fault[3] = which;
    std::atomic_ref<int32_t>(fault[0]).store(1, std::memory_order_release);
  }
  host_trap();
}

inline int32_t flag_wait(const int32_t* flag, int32_t want, bool sys,
                         int32_t* fault, int d, int which) {
  host_flag_delay();
  int32_t v = flag_acquire(flag, sys);
  if (v >= want) return v;
  const uint64_t t0 = flag_clock_ns();
  while ((v = flag_acquire(flag, sys)) < want) {
    if (flag_clock_ns() - t0 > host_budget_ns.load())
      flag_fault(fault, d, which);
    std::this_thread::yield();
  }
  return v;
}

}  // namespace bialign
