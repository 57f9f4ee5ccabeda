// Host stand-in for the thread-block cluster of <cooperative_groups.h>
// (csrc/triplet.cu, route "cluster": a CTA's rank and the shared memory of
// another CTA): the CTAs of a cluster run at once as std::threads, each CTA
// with a shared buffer of its own (see cuda_runtime.h here; the cluster
// barrier is cluster_barrier.cuh's).
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  static unsigned block_rank() { return host_cluster_rank; }
  // `addr` in the calling CTA's shared memory -> the same place in that of
  // CTA `rank`
  template <class T>
  static T* map_shared_rank(T* addr, unsigned rank) {
    if (rank >= host_cluster_dims) return nullptr;
    const auto offset = reinterpret_cast<char*>(addr) -
                        reinterpret_cast<char*>(host_cta_shared);
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(host_cluster_shared[rank]) + offset);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
