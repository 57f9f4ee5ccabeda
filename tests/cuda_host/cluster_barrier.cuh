// Host stand-in for csrc/cluster_barrier.cuh: the cluster barrier's arrive
// and wait on the std::barrier of the calling thread's cluster (see
// cuda_runtime.h here), whose arrive already orders what came before it;
// the fence a fence.  A thread that waits without having arrived, or
// arrives twice, breaks the barrier: the kernels must not.
#pragma once

#include <atomic>
#include <optional>

#include "cuda_runtime.h"

namespace bialign {

inline thread_local std::optional<std::barrier<>::arrival_token>
    host_cluster_token;

inline void cluster_fence() {
  std::atomic_thread_fence(std::memory_order_acq_rel);
}

inline void cluster_arrive_relaxed() {
  host_cluster_token.emplace(host_cluster_barrier->arrive());
}

inline void cluster_wait() {
  host_cluster_barrier->wait(std::move(*host_cluster_token));
  host_cluster_token.reset();
}

}  // namespace bialign
