// Scores, or bands and scores, of the B pairs of one bucket, one launch per
// bucket diagonal: the kernel and host loop that csrc/batch_affine.cu (K4)
// and csrc/batch_nonaffine.cu (K5) instantiate with their recurrence
// (`Affine` of csrc/affine_diag.cuh, `Nonaffine` of
// csrc/nonaffine_diag.cuh), in score mode (kRing = true) and in band mode
// (kRing = false).
//
// A bucket is a zero-padded stack of dense tables [B, N+1, M+1] with each
// pair's own lengths n_b <= N, m_b <= M in device memory.  Diagonal d of
// the bucket (0 <= d <= d_max, the largest n_b + m_b as far as the host
// knows it, at most N+M) is one launch over (row blocks x B) blocks:
// block x belongs to pair x / row_blocks.  In score mode the carry is the
// single-pair score kernels' ring of three slabs, one ring per pair:
// [B, 3, cells, N+1] in device memory, any contents.  In band mode pair b
// writes every diagonal into its own band [D, cells, N+1] of the chunk band
// [B, D, cells, N+1] (D = d_max + 1, any contents), which doubles as the
// carry, exactly as the single-pair band fills do (csrc/fill_affine.cu);
// the batched walks of csrc/walk.cu read it there, so no band crosses to
// the host.  The offset of a pair's band is 64-bit: a chunk band may hold
// more than 2^31 values.  A thread works only
// inside its own pair's live range max(0, d - m_b) <= i <= min(n_b, d),
// which is empty once d > n_b + m_b: so a pair's last slab is never
// overwritten after its own last diagonal, and the thread of row n_b writes
// the pair's score to out[b] at d = n_b + m_b, from the values it has just
// stored.  A pair whose lengths lie outside the bucket touches nothing, and
// out[b] keeps what the wrapper put there.  Cells of a band outside a
// pair's live rows, and its diagonals past n_b + m_b, are never written and
// never read: not by the fill (the guards make every predecessor a live
// row of the same pair) and not by the walk, which starts at (n_b, m_b) and
// follows guarded predecessors.
//
// Not carried over from the TPU kernels (_affine_batched_kernel,
// _nonaffine_batched_kernel): the chunk of G diagonals per grid step, the
// diagonal tables built on the device, the folded [SUB, 128] row layout,
// and the garbage diagonals past a pair's last one.
//
// What bounds it: as the per-diagonal single-pair kernels, one thread's
// serial chain per launch (csrc/affine_diag.cuh); the batch puts B pairs'
// rows under each launch's chain.  On an H100 80GB HBM3 at 700 W (measured;
// PERF.md, Findings) an affine launch at max_shift 1 takes 66 us with 17 to
// 28 pairs of 128-508 residues under it (64 such pairs in 154 ms, against
// 2.4 s one pair at a time), a non-affine one at max_shift 2 43 us; the
// launches are 1.3 us apart.  By bytes and operations the bound is 1.2 ms
// for those 64 pairs.  Band mode writes 7.2 GB for the same pairs, 2.2 ms at
// the card's memory rate: the chain still binds, not the band's bytes.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

template <class Rec, bool kRing>
__global__ void batch_diag(int32_t* slabs, int32_t* out,
                           const int32_t* __restrict__ mu1,
                           const int32_t* __restrict__ mu2,
                           const int32_t* __restrict__ ns,
                           const int32_t* __restrict__ ms,
                           const int32_t* __restrict__ cases, int N, int M,
                           int S, int d, int lo, int row_blocks, int D) {
  const int b = blockIdx.x / row_blocks;
  const int first = lo + (blockIdx.x % row_blocks) * blockDim.x;
  const int n = ns[b], m = ms[b];
  if (n < 0 || n > N || m < 0 || m > M) return;
  // this pair's live rows on diagonal d; a block with none of them leaves
  // as a whole, before the barrier of load_table
  const int plo = max(0, d - m), phi = min(n, d);
  if (first > phi || first + (int)blockDim.x <= plo) return;

  __shared__ int32_t tab[Rec::kTable];
  load_table(tab, cases, Rec::kTable);
  const int i = first + threadIdx.x;
  if (i < plo || i > phi) return;

  const int P = N + 1;
  const long long plane = (long long)(N + 1) * (M + 1);
  const long long slab = (long long)Rec::cells(S) * P;
  // slab 0 of this pair: of its ring, or of its band of D diagonals
  int32_t* own = slabs + (long long)b * (kRing ? RING : D) * slab;
  Rec::template row<kRing>(own, tab, mu1 + b * plane, mu2 + b * plane, n, m,
                           M + 1, P, S, d, i);
  if (d == n + m && i == n)
    out[b] = Rec::score(own + slab_of<kRing>(d) * slab, P, S, n);
}

// Runs the bucket's diagonals 0..d_max on `stream`, one launch each, B >= 1,
// over rings [B, 3, cells, N+1] (kRing) or bands [B, d_max + 1, cells, N+1].
// Returns 0, or the first launch error as a cudaError_t value.
template <class Rec, bool kRing>
int run_batch_diagonals(int32_t* slabs, int32_t* out, const int32_t* mu1,
                        const int32_t* mu2, const int32_t* ns,
                        const int32_t* ms, const int32_t* cases, int B, int N,
                        int M, int S, int d_max, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int last = std::min(d_max, N + M);
  for (int d = 0; d <= last; ++d) {
    const int lo = std::max(0, d - M);
    const int hi = std::min(N, d);
    const int row_blocks = (hi - lo + kRowBlock) / kRowBlock;
    batch_diag<Rec, kRing><<<(unsigned)row_blocks * B, kRowBlock, 0, st>>>(
        slabs, out, mu1, mu2, ns, ms, cases, N, M, S, d, lo, row_blocks,
        last + 1);
    BIALIGN_TRY(cudaGetLastError());
  }
  return 0;
}

}  // namespace
}  // namespace bialign
