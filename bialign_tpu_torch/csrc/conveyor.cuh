// Scores of the B pairs of one bucket on a conveyor: the kernel and host
// loop that csrc/conveyor_scores.cu (K8) instantiates with the tile of its
// recurrence (`AffineTile`, `NonaffineTile` of csrc/tile_diag.cuh).
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
// Step t is one launch of lanes x (stripes in flight) x tiles CTAs,
// `tiles` the tiles of R rows that cover the widest live range a stripe in
// flight can have on its diagonal.  A CTA serves one stripe: its lane,
// stripe k, pair b and that pair's diagonal d follow from the CTA's index,
// and it fills its tile of the pair's own live rows on the lane's ring with
// `pair_tile` of csrc/batch_diag.cuh (`fill_tile` of csrc/tile_diag.cuh,
// ring addressing), as a CTA of the bucket kernels K4/K5 does.
//
// Why the pairs of a lane do not disturb each other.  On its diagonal d a
// CTA of pair b stages rows max(0, i0 - 1) .. i1 of the slabs of d-1 and
// d-2, which the pair wrote itself one and two steps before, and writes
// rows i0 .. i1 of the slab of d, where i0 >= max(0, d - m_b) and
// i1 <= min(n_b, d): the pair stages rows >= d - M - 1 and writes rows
// >= d - M - 2 over these three steps, all of them <= d.  The pair behind
// it on the lane is on diagonal d - T0: it writes and stages rows
// <= d - T0 only, now and before.  The pair ahead is on d + T0: over the
// same three steps it writes rows >= d + T0 - M - 2 and stages rows
// >= d + T0 - M - 1.  With T0 = M + 3 (cuda_dp.conveyor_T0) the pair behind
// stays at rows <= d - M - 3 and the pair ahead writes rows >= d + 1 and
// stages rows >= d + 2: no pair overwrites a row that another still has
// to stage.  So each pair may keep its own numbering of the ring's slabs
// (d % 3) and the recurrence is the one of the other kernels, unchanged.
// The ring may hold anything at the start.  At d = n_b + m_b the CTA of
// row n_b writes the pair's score to out[b] from the values it has just
// stored (no other pair writes row n_b then).  A pair whose lengths lie
// outside the bucket touches nothing.
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
// What bounds it: as the bucket kernels (csrc/batch_diag.cuh), one
// launch's chain of staged loads and 4S + 2 barriers, times the waves of
// CTAs a step needs; a bucket's steps are (ceil(B / lanes) - 1) * T0 +
// d_max + 1, and cuda_dp.conveyor_lanes sizes the lanes so that a step's
// launch is about two waves of the card's threads.  On an H100 80GB HBM3
// at 700 W (measured; PERF.md, Findings), 64 pairs of 128-508 residues in
// buckets of 17 to 28, affine at max_shift 1: a lane a pair, 2251 steps,
// 25.4 ms (136 ms in an earlier design, a thread a row); 16 lanes for the
// 28 pairs, 2766 steps of 9.2 us on the device, 28.7 ms; one lane a bucket
// 164 ms.
#pragma once

#include <algorithm>

#include "batch_diag.cuh"
#include "common.cuh"

namespace bialign {
namespace {

template <class Tile, int kS>
__global__ void __launch_bounds__(Tile::kThreads)
    conveyor_tile(int32_t* rings, int32_t* out,
                  const int32_t* __restrict__ mu1,
                  const int32_t* __restrict__ mu2,
                  const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ ms,
                  const __grid_constant__ typename Tile::Consts cs, int B,
                  int N, int M, int S, int lanes, int T0, int t, int k_lo,
                  int stripes, int tiles) {
  extern __shared__ int32_t smem[];
  const int lane = blockIdx.x / (stripes * tiles);
  const int k = k_lo + blockIdx.x / tiles % stripes;
  const long long b = lane + static_cast<long long>(k) * lanes;
  if (b >= B) return;
  const size_t plane = static_cast<size_t>(N + 1) * (M + 1);
  int32_t* ring = rings + static_cast<size_t>(lane) * RING *
                              slab_values<Tile>(N + 1, S);
  pair_tile<Tile, kS, true>(smem, ring, out + b, mu1 + b * plane,
                            mu2 + b * plane, cs, ns[b], ms[b], N, M, S,
                            t - k * T0, blockIdx.x % tiles);
}

// Runs the conveyor's steps on `stream`, one launch each: B >= 1 pairs over
// 1 <= lanes <= B rings, T0 > M + 2 steps apart, no pair having a diagonal
// beyond d_max; `consts` (host memory) are the case constants.  Returns 0,
// or the first CUDA error as a cudaError_t value.
template <class Tile>
int run_conveyor(int32_t* rings, int32_t* out, const int32_t* mu1,
                 const int32_t* mu2, const int32_t* ns, const int32_t* ms,
                 const int32_t* consts, int B, int N, int M, int S, int lanes,
                 int T0, int d_max, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  d_max = std::min(d_max, N + M);
  const int per_lane = (B + lanes - 1) / lanes;
  const long long steps = static_cast<long long>(per_lane - 1) * T0 + d_max + 1;
  return with_shift(S, [&](auto shift) {
    const auto kernel = conveyor_tile<Tile, decltype(shift)::value>;
    const TileGeometry g = tile_geometry<Tile>(S);
    BIALIGN_TRY(tile_ready(kernel, g, slab_values<Tile>(N + 1, S)));
    for (long long t = 0; t < steps; ++t) {
      // the stripes whose diagonal t - k * T0 lies in 0..d_max
      const int k_hi = static_cast<int>(std::min<long long>(per_lane - 1,
                                                            t / T0));
      const int k_lo =
          t > d_max ? static_cast<int>((t - d_max + T0 - 1) / T0) : 0;
      if (k_lo > k_hi) continue;     // between two pairs' diagonals
      int tiles = 0;                 // of the widest diagonal in flight
      for (int k = k_lo; k <= k_hi; ++k)
        tiles = std::max(tiles, bucket_tiles(N, M,
                                             static_cast<int>(t - k * T0),
                                             g.rows));
      const int stripes = k_hi - k_lo + 1;
      kernel<<<static_cast<unsigned>(lanes) * stripes * tiles, g.threads,
               g.bytes, st>>>(rings, out, mu1, mu2, ns, ms, cs, B, N, M, S,
                              lanes, T0, static_cast<int>(t), k_lo, stripes,
                              tiles);
      BIALIGN_TRY(cudaGetLastError());
    }
    return 0;
  });
}

}  // namespace
}  // namespace bialign
