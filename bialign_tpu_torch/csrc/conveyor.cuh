// Scores of the B pairs of one bucket on a conveyor: the kernel and host
// loop that csrc/conveyor_scores.cu (K8) instantiates with its recurrence
// (`Affine` of csrc/affine_diag.cuh, `Nonaffine` of csrc/nonaffine_diag.cuh).
//
// The bucket is the zero-padded stack [B, N+1, M+1] of csrc/batch_diag.cuh.
// Its pairs do not get a ring each: `lanes` rings [lanes, 3, cells, N+1] in
// device memory carry them all.  Through lane x stream the pairs x,
// x + lanes, x + 2 lanes, ... one behind the other, T0 steps apart: at step
// t stripe k of a lane, which is pair b = lane + k * lanes, is on its own
// diagonal d = t - k * T0, so row i of the lane serves stripe (t - i) / T0
// at column (t - i) % T0.  While a pair's live window drains towards its
// row n_b, the next pair's already climbs from row 0 underneath it.  So
// the rows that a pair's diagonal leaves dead do the next pair's work, and
// the carry is lanes rings, not B.
//
// Step t is one launch over (lanes x stripes in flight x row blocks)
// blocks.  A block serves one stripe: its pair and that pair's diagonal
// follow from the block's index, the same for all its threads, and the
// block covers 128 of that diagonal's rows, as a block of
// csrc/batch_diag.cuh does.  (A first form gave every thread a row of the
// lane and let it find its own stripe; a diagonal index that differs from
// thread to thread cost a fifth more time a step: PERF.md, Findings.)
//
// Why the pairs of a lane do not disturb each other: T0 > M gives every
// (step, row) one owner.  A pair reads only what it wrote itself (the
// guards of `Rec::row`), from its live rows of its diagonals d-1 and d-2,
// rows >= d - m_b - 2.  The pair behind it is on diagonal d - T0 and has
// written rows <= d - T0 only.  With T0 = M + 3 (cuda_dp.conveyor_T0) these
// never meet, so each pair may keep its own numbering of the ring's slabs
// (d % 3, as `Rec::row` has it) and the recurrence is the one of the other
// kernels, unchanged.  The ring may hold anything at the start.  The thread
// of row n_b writes the pair's score to out[b] at d = n_b + m_b, from the
// values it has just stored.  A pair whose lengths lie outside the bucket
// touches nothing.
//
// Not carried over from the TPU kernel (_conveyor_kernel, _conveyor_tables,
// _conveyor_run): the spliced per-step tables and the DL/NV planes built by
// gathers (a block works out its pair and reads the dense stack), the
// diagonal index per row, the accumulator of snapshots and its
// capture-collision term in T0, the garbage stripes and the drift bound
// that certifies them (_conveyor_safe_T: here a dead cell is not computed
// at all), and the one slab for the whole bucket: a card with 132 SMs wants
// many lanes.
//
// What bounds it: as the per-diagonal kernels, one thread's serial chain per
// launch (csrc/affine_diag.cuh), so a bucket's time follows its number of
// steps, (ceil(B / lanes) - 1) * T0 + d_max + 1.  On an H100 80GB HBM3 at
// 700 W (measured; PERF.md, Findings) an affine step at max_shift 1 takes
// 59 us with 17 to 28 pairs of 128-508 residues on a lane each (64 such
// pairs in 135 ms, 2251 steps; the per-diagonal kernel of
// csrc/batch_diag.cuh takes 67 us a launch on the same buckets); with half
// the lanes the same pairs take 204 ms, with one lane per bucket 1.58 s.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

template <class Rec>
__global__ void conveyor_step(int32_t* rings, int32_t* out,
                              const int32_t* __restrict__ mu1,
                              const int32_t* __restrict__ mu2,
                              const int32_t* __restrict__ ns,
                              const int32_t* __restrict__ ms,
                              const int32_t* __restrict__ cases, int B, int N,
                              int M, int S, int lanes, int T0, int t, int k_lo,
                              int stripes, int row_blocks) {
  const int lane = blockIdx.x / (stripes * row_blocks);
  const int k = k_lo + blockIdx.x / row_blocks % stripes;
  const long long b = lane + (long long)k * lanes;
  if (b >= B) return;
  const int d = t - k * T0;
  const int n = ns[b], m = ms[b];
  if (n < 0 || n > N || m < 0 || m > M) return;
  // this pair's live rows on its diagonal d; a block with none of them
  // leaves as a whole, before the barrier of load_table
  const int plo = max(0, d - m), phi = min(n, d);
  const int first = max(0, d - M) + (blockIdx.x % row_blocks) * blockDim.x;
  if (first > phi || first + (int)blockDim.x <= plo) return;

  __shared__ int32_t tab[Rec::kTable];
  load_table(tab, cases, Rec::kTable);
  const int i = first + threadIdx.x;
  if (i < plo || i > phi) return;

  const int P = N + 1;
  const long long plane = (long long)(N + 1) * (M + 1);
  const long long slab = (long long)Rec::cells(S) * P;
  int32_t* ring = rings + lane * RING * slab;
  Rec::template row<true>(ring, tab, mu1 + b * plane, mu2 + b * plane, n, m,
                          M + 1, P, S, d, i);
  if (d == n + m && i == n)
    out[b] = Rec::score(ring + slab_of<true>(d) * slab, P, S, n);
}

// Runs the conveyor's steps on `stream`, one launch each: B >= 1 pairs over
// 1 <= lanes <= B rings, T0 > M + 2 steps apart, no pair having a diagonal
// beyond d_max.  Returns 0, or the first launch error as a cudaError_t value.
template <class Rec>
int run_conveyor(int32_t* rings, int32_t* out, const int32_t* mu1,
                 const int32_t* mu2, const int32_t* ns, const int32_t* ms,
                 const int32_t* cases, int B, int N, int M, int S, int lanes,
                 int T0, int d_max, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  d_max = std::min(d_max, N + M);
  const int per_lane = (B + lanes - 1) / lanes;
  const long long steps = (long long)(per_lane - 1) * T0 + d_max + 1;
  for (long long t = 0; t < steps; ++t) {
    // the stripes whose diagonal t - k * T0 lies in 0..d_max
    const int k_hi = (int)std::min<long long>(per_lane - 1, t / T0);
    const int k_lo = t > d_max ? (int)((t - d_max + T0 - 1) / T0) : 0;
    if (k_lo > k_hi) continue;       // between two pairs' diagonals
    int rows = 0;                    // of the longest diagonal in flight
    for (int k = k_lo; k <= k_hi; ++k) {
      const int d = (int)(t - (long long)k * T0);
      rows = std::max(rows, std::min(N, d) - std::max(0, d - M) + 1);
    }
    const int row_blocks = (rows + kRowBlock - 1) / kRowBlock;
    const int stripes = k_hi - k_lo + 1;
    conveyor_step<Rec>
        <<<(unsigned)lanes * stripes * row_blocks, kRowBlock, 0, st>>>(
            rings, out, mu1, mu2, ns, ms, cases, B, N, M, S, lanes, T0, (int)t,
            k_lo, stripes, row_blocks);
    BIALIGN_TRY(cudaGetLastError());
  }
  return 0;
}

}  // namespace
}  // namespace bialign
