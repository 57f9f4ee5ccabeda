// Scores of the B pairs of one bucket in one launch, one CTA per pair: the
// kernel that csrc/cta_scores.cu (K6, affine and non-affine) and
// csrc/cta_scores_ms0.cu (K7) instantiate with their recurrence.
//
// This is the GPU form of the TPU's packed kernels for small buckets with
// many pairs (_packed_batched_kernel, _packed_ms0_kernel): the carry never
// leaves the chip, and there is no launch per diagonal.  A CTA holds its
// pair's ring of three slabs [3, cells, N+1] and the case table in dynamic
// shared memory, loops over the pair's own diagonals 0..n_b+m_b with a
// __syncthreads() between them, and thread 0 writes the score from the last
// slab (the TPU kernel's snapshot at the pair's d_last).  Inside a diagonal
// a thread reads only its own earlier writes of that diagonal, so no
// barrier is needed there; every thread of the CTA reaches every barrier
// (the loop bounds depend on the pair alone).  Rows are walked in strides
// of the block, so a bucket may have more rows than a block has threads.
//
// Shared memory decides whether a bucket can take this kernel, not a row
// count: (table + 3 * cells * (N+1)) * 4 bytes must fit the 227 KB a CTA
// can have (cuda_dp.cta_shared_bytes): 65 rows affine fit up to max_shift
// 2, 129 rows at max_shift 1.  Three slabs, as everywhere: diagonal d
// writes slab d % 3 while its neighbours still read d-1 and d-2.
//
// `rings` is a hook for the checks and null on every path of
// parallel/batch.py.  If not null it is [B, 3, cells, N+1] in device memory:
// the CTA copies its pair's ring into shared memory first.  The result does
// not depend on it (stale rows are never read); the checks pass garbage to
// prove that.  Without it the slabs start as whatever shared memory held.
//
// Not carried over from the TPU kernels: eight pairs per vector register,
// the padding of rows to 128 lanes, the diagonal tables, the chunks of G
// diagonals, the accumulator of snapshots.
//
// What bounds it: one thread's serial chain per diagonal, now on shared
// memory instead of L2; the pairs of a bucket run side by side on the 132
// SMs, as many CTAs per SM as shared memory allows.  On an H100 80GB HBM3 at
// 700 W (measured; PERF.md, Findings) an affine diagonal at max_shift 1
// takes 25.6 us in a CTA, alone on its SM or with two neighbours: half the
// 50-60 us of the per-diagonal kernels, so the chain is instructions as
// much as load latency.  512 pairs of 42x42 in a 64x64 bucket (63 KB a CTA,
// 396 at once, two waves) take 4.3 ms, non-affine at max_shift 2 2.9 ms,
// and K7 0.16 ms; the bound by operations is 0.14 ms for the affine bucket.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kCtaMaxThreads = 512;

template <class Rec>
__global__ void cta_scores(const int32_t* __restrict__ rings, int32_t* out,
                           const int32_t* __restrict__ mu1,
                           const int32_t* __restrict__ mu2,
                           const int32_t* __restrict__ ns,
                           const int32_t* __restrict__ ms,
                           const int32_t* __restrict__ cases, int N, int M,
                           int S) {
  extern __shared__ int32_t shared[];
  int32_t* tab = shared;
  int32_t* slabs = shared + Rec::kTable;

  const int b = blockIdx.x;
  const int n = ns[b], m = ms[b];
  if (n < 0 || n > N || m < 0 || m > M) return;   // the whole CTA
  const int P = N + 1;
  const int slab = Rec::cells(S) * P;
  if (rings != nullptr) {
    const int32_t* mine = rings + (long long)b * RING * slab;
    for (int x = threadIdx.x; x < RING * slab; x += blockDim.x)
      slabs[x] = mine[x];
  }
  load_table(tab, cases, Rec::kTable);

  const long long plane = (long long)(N + 1) * (M + 1);
  const int32_t* mu1b = mu1 + b * plane;
  const int32_t* mu2b = mu2 + b * plane;
  for (int d = 0; d <= n + m; ++d) {
    const int hi = min(n, d);
    for (int i = max(0, d - m) + threadIdx.x; i <= hi; i += blockDim.x)
      Rec::template row<true>(slabs, tab, mu1b, mu2b, n, m, M + 1, P, S, d, i);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    out[b] = Rec::score(slabs + slab_of<true>(n + m) * slab, P, S, n);
}

// Bytes of dynamic shared memory of one CTA; cuda_dp.cta_shared_bytes is
// the same sum.
template <class Rec>
size_t cta_shared_bytes(int N, int S) {
  return (Rec::kTable + (size_t)RING * Rec::cells(S) * (N + 1)) *
         sizeof(int32_t);
}

// Scores B >= 1 pairs on `stream` in one launch.  Returns 0, or the first
// error (of the attribute or of the launch) as a cudaError_t value.
template <class Rec>
int run_cta_scores(const int32_t* rings, int32_t* out, const int32_t* mu1,
                   const int32_t* mu2, const int32_t* ns, const int32_t* ms,
                   const int32_t* cases, int B, int N, int M, int S,
                   int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const size_t bytes = cta_shared_bytes<Rec>(N, S);
  BIALIGN_TRY(cudaFuncSetAttribute(
      cta_scores<Rec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  const int threads = std::min(kCtaMaxThreads, (N + 1 + 31) / 32 * 32);
  cta_scores<Rec><<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      rings, out, mu1, mu2, ns, ms, cases, N, M, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace bialign
