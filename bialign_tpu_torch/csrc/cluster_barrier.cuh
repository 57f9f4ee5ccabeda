// The cluster barrier of a thread-block cluster, for csrc/triplet.cu
// (route "cluster"), in pieces: a fence at cluster scope (what the calling
// thread stored before it, into any CTA's shared memory, is seen by a
// thread of the cluster that acquires after it), the barrier's arrive with
// no ordering of its own, and its wait with acquire semantics.  Between
// the arrive and the wait a thread may work on what the barrier does not
// guard.  Included as <cluster_barrier.cuh>, so that tests/cuda_host
// supplies its own for the host build.
#pragma once

namespace bialign {

__device__ __forceinline__ void cluster_fence() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

}  // namespace bialign
