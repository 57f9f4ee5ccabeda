// Scores, or bands and scores, of the B pairs of one bucket, one launch per
// bucket diagonal: the kernel and host loop that csrc/batch_affine.cu (K4)
// and csrc/batch_nonaffine.cu (K5) instantiate with the tile of their
// recurrence (`AffineTile`, `NonaffineTile` of csrc/tile_diag.cuh), in score
// mode (kRing = true) and in band mode (kRing = false); and `pair_tile`, a
// pair's tile of a bucket diagonal, which the conveyor K8
// (csrc/conveyor.cuh) runs too.
//
// A bucket is a zero-padded stack of dense tables [B, N+1, M+1] with each
// pair's own lengths n_b <= N, m_b <= M in device memory.  Diagonal d of
// the bucket (0 <= d <= d_max, the largest n_b + m_b as far as the host
// knows it, at most N+M) is one launch of B x tiles CTAs, `tiles` the tiles
// of R rows (Tile::rows) in the widest live range any pair of the bucket
// can have on d, min(N, d) - max(0, d - M) + 1 rows.  CTA x serves pair
// b = x / tiles: its tile x % tiles of the pair's own live range
// max(0, d - m_b) <= i <= min(n_b, d), so that no tile is half dead because
// a shorter pair sits in a long bucket, filled by `fill_tile` of
// csrc/tile_diag.cuh on the pair's slabs and tables (rows M+1 apart, slabs
// N+1 rows a line).  A CTA whose pair has no such rows (past its last
// diagonal n_b + m_b, or past the end of its range) or whose lengths lie
// outside the bucket returns as a whole before the first barrier; out[b]
// then keeps what the wrapper put there.  In score mode the carry is the
// single-pair score kernels' ring of three slabs, one ring per pair:
// [B, 3, cells, N+1] in device memory, any contents.  In band mode pair b
// writes every diagonal into its own band [D, cells, N+1] of the chunk band
// [B, D, cells, N+1] (D = d_max + 1, any contents), which doubles as the
// carry, exactly as the single-pair band fills do (csrc/fill_affine.cu);
// the batched walks of csrc/walk.cu read it there, so no band crosses to
// the host.  The offset of a pair's band is 64-bit: a chunk band may hold
// more than 2^31 values.  At d = n_b + m_b the one CTA that holds row n_b
// writes the pair's score to out[b] after a barrier, from the values it has
// just stored; a pair's last slab is never overwritten after its own last
// diagonal.  Cells of a band outside a pair's live rows, and its diagonals
// past n_b + m_b, are never written; those the tile stages off the live
// rows are never used (the guards make every predecessor a live row of the
// same pair), and the walk starts at (n_b, m_b) and follows guarded
// predecessors.  The case constants come by value, the rest of a case is
// compiled in, as in the single-pair kernels; max_shift 0-3 are compiled
// instantiations, larger ones take S at run time with one row a tile, up to
// the tile's shared-memory limit (17 affine, 48 non-affine), beyond which
// the host loop refuses before the first launch.
//
// Not carried over from the TPU kernels (_affine_batched_kernel,
// _nonaffine_batched_kernel): the chunk of G diagonals per grid step, the
// diagonal tables built on the device, the folded [SUB, 128] row layout,
// and the garbage diagonals past a pair's last one.
//
// What bounds it: as the single-pair tile kernels (csrc/tile_diag.cuh), one
// launch's chain from the staged loads through 4S + 2 barriers to the
// store, times the waves of CTAs a diagonal of the bucket needs; the
// launches of a bucket are d_max + 1.  On an H100 80GB HBM3 at 700 W
// (measured; PERF.md, Findings) an affine launch at max_shift 1 takes 9.3
// us on the device with 17 to 28 pairs of 128-508 residues under it (64
// such pairs in 23.8 ms in score mode, 24.3 ms in band mode, which writes
// 7.0 GB; 154 and 168 ms in an earlier design, a thread a row), 5.8 us
// with one pair of 929 rows, within 7% of the single-pair tile kernel.
// The bound by bytes and operations is 1.2 ms for those 64 pairs.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "tile_diag.cuh"

namespace bialign {
namespace {

// Tile `tile` of the live rows of pair (n, m) on its diagonal d, by the
// whole CTA: `own` is slab 0 of the pair's ring or band, mu1 and mu2 its
// planes of the bucket's stacks [N+1, M+1].  At d = n + m the CTA of row n
// writes the score to *out.  The CTA returns at once, as a whole, when the
// pair lies outside the bucket or has no rows in that tile.
template <class Tile, int kS, bool kRing>
__device__ __forceinline__ void pair_tile(
    int32_t* smem, int32_t* own, int32_t* out, const int32_t* mu1,
    const int32_t* mu2, const typename Tile::Consts& cs, int n, int m, int N,
    int M, int S, int d, int tile) {
  if (n < 0 || n > N || m < 0 || m > M) return;
  constexpr int R = Tile::rows(kS);
  const int i0 = max(0, d - m) + tile * R;
  const int i1 = min(min(n, d), i0 + R - 1);
  if (i0 > i1) return;
  fill_tile<Tile, kS, kRing>(smem, own, mu1, mu2, cs, n, m, M + 1, N + 1, 0,
                             S, d, i0, i1);
  if (d == n + m) {                 // the one tile, rows n..n
    __syncthreads();
    if (threadIdx.x == 0)
      *out = Tile::score(own + slab_of<kRing>(d) * slab_values<Tile>(N + 1, S),
                         N + 1, S, n);
  }
}

template <class Tile, int kS, bool kRing>
__global__ void __launch_bounds__(Tile::kThreads)
    batch_tile(int32_t* slabs, int32_t* out, const int32_t* __restrict__ mu1,
               const int32_t* __restrict__ mu2,
               const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
               const __grid_constant__ typename Tile::Consts cs, int N, int M,
               int S, int d, int tiles, int D) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x / tiles;
  const size_t plane = static_cast<size_t>(N + 1) * (M + 1);
  // slab 0 of this pair: of its ring, or of its band of D diagonals
  int32_t* own = slabs + static_cast<size_t>(b) * (kRing ? RING : D) *
                             slab_values<Tile>(N + 1, S);
  pair_tile<Tile, kS, kRing>(smem, own, out + b, mu1 + b * plane,
                             mu2 + b * plane, cs, ns[b], ms[b], N, M, S, d,
                             blockIdx.x % tiles);
}

// Tiles of R rows that cover the widest live range a pair of an (N, M)
// bucket can have on diagonal d.
inline int bucket_tiles(int N, int M, int d, int R) {
  const int rows = std::min(N, d) - std::max(0, d - M) + 1;
  return (rows + R - 1) / R;
}

// Runs the bucket's diagonals 0..min(d_max, N+M) on `stream`, one launch
// each, B >= 1, over rings [B, 3, cells, N+1] (kRing) or bands
// [B, min(d_max, N+M) + 1, cells, N+1]; `consts` (host memory) are the case
// constants.  Returns 0, or the first CUDA error as a cudaError_t value.
template <class Tile, bool kRing>
int run_batch_diagonals(int32_t* slabs, int32_t* out, const int32_t* mu1,
                        const int32_t* mu2, const int32_t* ns,
                        const int32_t* ms, const int32_t* consts, int B, int N,
                        int M, int S, int d_max, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const int last = std::min(d_max, N + M);
  return with_shift(S, [&](auto shift) {
    const auto kernel = batch_tile<Tile, decltype(shift)::value, kRing>;
    const TileGeometry g = tile_geometry<Tile>(S);
    BIALIGN_TRY(tile_ready(kernel, g, slab_values<Tile>(N + 1, S)));
    for (int d = 0; d <= last; ++d) {
      const int tiles = bucket_tiles(N, M, d, g.rows);
      kernel<<<static_cast<unsigned>(B) * tiles, g.threads, g.bytes, st>>>(
          slabs, out, mu1, mu2, ns, ms, cs, N, M, S, d, tiles, last + 1);
      BIALIGN_TRY(cudaGetLastError());
    }
    return 0;
  });
}

}  // namespace
}  // namespace bialign
