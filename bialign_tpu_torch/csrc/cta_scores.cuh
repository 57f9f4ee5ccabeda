// Scores of the B pairs of one bucket in one launch, one CTA a pair, the
// carry in shared memory: the kernels that csrc/cta_scores.cu (K6,
// `cta_scores` with the tile kernels' `AffineTile` and `NonaffineTile`),
// csrc/cta_scores_ms0.cu (K7, `cta_ms0`) and csrc/score_affine_ms0.cu (K3:
// `cta_ms0` for one pair, B = 1) instantiate.
//
// This is the GPU form of the TPU's packed kernels for small buckets with
// many pairs (_packed_batched_kernel, _packed_ms0_kernel) and of its
// max_shift 0 score (_affine_ms0_kernel): the carry never leaves the SM,
// and there is one launch a bucket.  A CTA holds its pair's ring of three
// slabs [3, cells, N+1] in dynamic shared memory and loops over the pair's
// own diagonals 0..n_b+m_b; every thread reaches every barrier (the loop
// bounds depend on the pair alone), and a pair whose lengths lie outside
// the bucket leaves as a whole before the first.  Rows off a diagonal's
// live range are never written, and never read: a case's guard makes its
// predecessor a live row of its own diagonal; a table value outside the
// pair's [0, n] x [0, m] is 0 and is not read.  The case constants come by
// value, the columns are compiled in (csrc/recurrence.cuh).
//
// K6 (`cta_scores`).  A diagonal is computed by the whole CTA over all of
// the pair's live rows at once, with the per-value functions of the tile
// kernels (csrc/tile_diag.cuh: `outer` for groups A and C, `inner` for
// group B), which read the ring's slabs in place:
//  1. Groups A and C.  One thread a (state, shift position, row) value, in
//     strides of the CTA, rows fastest; slabs d-1 and d-2 are read where
//     they lie in the ring, and the raw maximum (INVALID where every case
//     was guarded out) goes to slab d % 3.  The values of t = sk + sl = 0
//     have no group B case and are unmasked (INVALID -> NEG_INF) at once.
//  2. Group B by t-levels.  For t = 1 .. 4S, after a barrier, each value of
//     level t takes the max with its str-only cases, whose sources are
//     values of the same row at lower t in slab d (read through the unmask),
//     and is stored unmasked.  So every value of slab d is final and
//     unmasked before the barrier that ends the diagonal: 4S + 1 barriers a
//     diagonal, and diagonals d+1 and d+2 never see INVALID.  Slab d
//     overwrites diagonal d-3's rows, which no one reads any more.
// The tables' values a diagonal needs are in shared memory before it
// starts: mu2's window of diagonal d is anti-diagonals d-2S .. d+2S of the
// table (k + l = d + sk + sl - 2S), so a ring of 4S+2 anti-diagonals, each
// by row k, holds them, and each diagonal copies one more (d+1+2S) into the
// slot that the anti-diagonal d-2S-1 left, and mu1's anti-diagonal d+1
// into the other half of a double buffer, by cp.async issued before the
// diagonal is computed and waited for before its last barrier.
// max_shift 0-3 are compiled instantiations, larger ones read S at run
// time.  Shared memory decides whether a bucket can take K6: (3 cells +
// 4S + 4) (N+1) int32 values must fit the 227 KB a CTA can have
// (`cta_shared_bytes`; cuda_dp.cta_shared_bytes is the same sum): affine,
// 231 rows at max_shift 1 and 84 at 2; non-affine 667 at 2.
//
// K3 and K7 (`cta_ms0`, the three live states of csrc/affine_ms0_diag.cuh).
// A thread owns rows by absolute index, i = threadIdx.x + r * blockDim.x
// for r < kRows, and computes the three states of each of its live rows;
// one barrier a diagonal.  Its rows' table values come from registers: for
// each row and table the thread holds the aligned 16-byte chunk of the
// row that holds this diagonal's value, and loads the next chunk on the
// diagonal that takes the last value of the current one, one diagonal
// ahead of its use.  A row's values lie one after another along the row,
// so a chunk serves four diagonals: a quarter of the table reads that one
// read a diagonal would make, each of them scattered over the table's rows
// (on an H100 80GB HBM3 at 700 W: 4000x3990 at max_shift 0 in 16.5 ms,
// against 25.3 with a read a diagonal and 72 with the anti-diagonals of
// K6's design; PERF.md, Findings).  A CTA of up to 1024 threads holds up to
// kMs0RowsPerThread rows a thread, so 4096 rows: the ring, 36 bytes a row,
// fits shared memory up to there, and the registers hold no more
// (cuda_dp.cta_fits).  K3 takes one CTA up to n = 4095 and launches a
// diagonal at a time beyond (csrc/score_affine_ms0.cu).
//
// `rings` is null on every path of parallel/batch.py, and K3's ring
// argument.  If not null it is [B, 3, cells, N+1] in device memory: the CTA
// copies its pair's ring into shared memory first, before a barrier, and
// back at the end, so the ring is left as the per-diagonal kernels leave
// theirs (a row's slab holds its last live diagonal of that residue class,
// or what the ring held).  The score does not depend on what it held
// (stale rows are never read): the checks pass garbage to prove that, and
// hold every cell that comes back to the plain twins'.  `out` null (K3)
// writes no score.
//
// Not carried over from the TPU kernels: eight pairs per vector register,
// the padding of rows to 128 lanes, the diagonal tables, the chunks of G
// diagonals, the accumulator of snapshots.
//
// What bounds them (NVIDIA H100 80GB HBM3, 700 W; PERF.md, Findings): K6, a
// diagonal's 4S + 1 barriers with the work of its values spread over the
// CTA's threads, the pairs of a bucket side by side on the 132 SMs as many
// CTAs an SM as shared memory allows; K3 on one SM, its scattered table
// reads and a barrier a diagonal.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>

#include <cuda_pipeline.h>
#include <neighbour_flags.cuh>

#include "affine_ms0_diag.cuh"
#include "common.cuh"
#include "tile_diag.cuh"

namespace bialign {
namespace {

// Threads of a CTA at most (the kernels' launch bound); rows a thread of
// cta_ms0; K6's threads by default, one a value of the widest diagonal up
// to kCtaThreads: the fastest of 256, 512 and 1024 on a bucket of 512 toy
// pairs (NVIDIA H100 80GB HBM3, 700 W; PERF.md, Findings).
constexpr int kCtaMaxThreads = 1024;
constexpr int kMs0RowsPerThread = 4;
template <class Tile>
constexpr int kCtaThreads = 512;
template <>
constexpr int kCtaThreads<NonaffineTile> = 256;

// Rows k of anti-diagonal `kappa` of a pair's table (0 <= kappa <= n+m)
// into `dst` (by row), asynchronously, by the whole CTA.
__device__ __forceinline__ void copy_antidiagonal(
    int32_t* dst, const int32_t* __restrict__ mu, int kappa, int n, int m,
    int ld) {
  for (int k = max(0, kappa - m) + threadIdx.x; k <= min(n, kappa);
       k += blockDim.x)
    __pipeline_memcpy_async(dst + k, mu + static_cast<long long>(k) * ld +
                                         kappa - k, sizeof(int32_t));
}

template <class Tile, int kS>
__global__ void __launch_bounds__(kCtaMaxThreads)
    cta_scores(int32_t* rings, int32_t* out, const int32_t* __restrict__ mu1,
               const int32_t* __restrict__ mu2,
               const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
               const __grid_constant__ typename Tile::Consts cs, int N, int M,
               int S_arg) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int n = ns[b], m = ms[b];
  if (n < 0 || n > N || m < 0 || m > M) return;   // the whole CTA
  const int S = kS >= 0 ? kS : S_arg;
  const int W = 2 * S + 1, W2 = W * W, cells = Tile::kStates * W2;
  const int P = N + 1, ld = M + 1, K2 = 4 * S + 2;
  const int slab = cells * P;
  int32_t* ring = smem;                    // [3][cells][P]
  int32_t* m2s = ring + RING * slab;       // [K2][P]: slot kappa % K2
  int32_t* m1s = m2s + K2 * P;             // [2][P]: slot d % 2
  const size_t plane = static_cast<size_t>(N + 1) * (M + 1);
  mu1 += b * plane;
  mu2 += b * plane;
  int32_t* mine = rings != nullptr
                      ? rings + static_cast<size_t>(b) * RING * slab
                      : nullptr;
  if (mine != nullptr)
    for (int x = threadIdx.x; x < RING * slab; x += blockDim.x)
      ring[x] = mine[x];
  for (int kappa = 0; kappa <= min(2 * S, n + m); ++kappa)
    copy_antidiagonal(m2s + kappa % K2 * P, mu2, kappa, n, m, ld);
  copy_antidiagonal(m1s, mu1, 0, n, m, ld);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // mu2 at (k, l), 0 outside the pair's table
  auto mu2_at = [&](int k, int l) -> int32_t {
    return k >= 0 && k <= n && l >= 0 && l <= m ? m2s[(k + l) % K2 * P + k]
                                                : 0;
  };
  for (int d = 0; d <= n + m; ++d) {
    // the next diagonal's anti-diagonals, in flight during this one
    if (d + 1 <= n + m)
      copy_antidiagonal(m1s + (d + 1) % 2 * P, mu1, d + 1, n, m, ld);
    if (d + 1 + 2 * S <= n + m)
      copy_antidiagonal(m2s + (d + 1 + 2 * S) % K2 * P, mu2, d + 1 + 2 * S,
                        n, m, ld);
    __pipeline_commit();

    const int lo = max(0, d - m), L = min(n, d) - lo + 1;
    const int32_t* d1 = ring + slab_of<true>(d - 1) * slab;
    const int32_t* d2 = ring + slab_of<true>(d - 2) * slab;
    int32_t* here = ring + slab_of<true>(d) * slab;
    const int32_t* m1d = m1s + d % 2 * P;
    // 1. groups A and C (and the origin's values)
    for (int x = threadIdx.x; x < cells * L; x += blockDim.x) {
      const int i = lo + x % L, cell = x / L, j = d - i;
      const int q = cell / W2, pos = cell - q * W2;
      const int sk = pos / W, sl = pos - sk * W;
      int32_t v = Tile::outer(d1, d2, P, cs, m1d[i],
                              mu2_at(i + sk - S, j + sl - S), q, sk, sl, i, i,
                              j, S, W);
      if (d == 0 && i == 0 && sk == S && sl == S) v = Tile::origin(q);
      here[cell * P + i] = pos == 0 ? unmask(v) : v;
    }
    // 2. group B, level by level (at the origin every str-only case is
    //    guarded out: k = l = 0 there, so its values stand)
    for (int t = 1; t <= 4 * S; ++t) {
      __syncthreads();
      const int sk0 = max(0, t - 2 * S);
      const int level = (min(2 * S, t) - sk0 + 1) * Tile::kStates * L;
      for (int x = threadIdx.x; x < level; x += blockDim.x) {
        const int i = lo + x % L, y = x / L, j = d - i;
        const int q = y % Tile::kStates;
        const int sk = sk0 + y / Tile::kStates, sl = t - sk;
        const int k = i + sk - S, l = j + sl - S;
        const int32_t v = Tile::inner(here + i, W2 * P, P, cs, mu2_at(k, l),
                                      q, sk, sl, k, l, W);
        int32_t& at = here[(q * W2 + sk * W + sl) * P + i];
        at = unmask(max(at, v));
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  if (threadIdx.x == 0)
    out[b] = Tile::score(ring + slab_of<true>(n + m) * slab, P, S, n);
  if (mine != nullptr)
    for (int x = threadIdx.x; x < RING * slab; x += blockDim.x)
      mine[x] = ring[x];
}

// The aligned 16-byte chunk of a table that holds its value g (an index
// from `base`, which holds `total` values; `lead` is base's offset in
// values from the alignment below it).  Values of the chunk outside
// [0, total) are read as 0 and never used.
__device__ __forceinline__ int4 table_chunk(const int32_t* __restrict__ base,
                                            long long total, int lead,
                                            long long g) {
  const long long g0 = g - ((lead + g) & 3);
  if (g0 >= 0 && g0 + 3 < total)
    return __ldg(reinterpret_cast<const int4*>(base + g0));
  int32_t v[4];
  for (int x = 0; x < 4; ++x)
    v[x] = g0 + x >= 0 && g0 + x < total ? base[g0 + x] : 0;
  return int4{v[0], v[1], v[2], v[3]};
}

__device__ __forceinline__ int32_t chunk_value(const int4& c, int at) {
  return at == 0 ? c.x : at == 1 ? c.y : at == 2 ? c.z : c.w;
}

// K3's route "resident" (csrc/score_affine_ms0.cu): CTA g of a cooperative
// grid takes the rows [g rows, (g+1) rows) of the pair; `halo` [G-1,
// n+m+1, 3] holds each CTA's last row, diagonal by diagonal (block g CTA
// g's), `flags` [G] each CTA's progress (zeroed before the launch; d+1
// once block g holds diagonal d), `fault` the fault word as the card sees
// it, or null (csrc/neighbour_flags.cuh).  Unused on the other routes.
struct Ms0Link {
  int rows;
  int32_t* halo;
  int32_t* flags;
  int32_t* fault;
};

// K3 and K7: the max_shift 0 recurrence, a thread its kRows rows.  `ns`
// and `ms` null: one pair of N x M (K3).  The stacks hold B planes.
// kResident (K3's route "resident", B = 1): the CTA's rows [r0, r1) of the
// pair, in a ring [3][3][rows+1] whose local row 0 is the halo, row r0-1
// of the CTA above; the thread of its last row stores that row's three
// states of each diagonal into its block of `link.halo`, one thread
// publishes the diagonal with a release store of the CTA's flag after the
// barrier that ends it, and one acquires the flag of the CTA above before
// it copies that CTA's row into local row 0, a diagonal ahead (below).  No
// barrier beyond the CTA: a CTA waits only for the one above, whose halo
// is never overwritten, and walks only the diagonals of its own rows.
template <int kRows, bool kResident = false>
__global__ void __launch_bounds__(kCtaMaxThreads)
    cta_ms0(int32_t* rings, int32_t* out, const int32_t* __restrict__ mu1,
            const int32_t* __restrict__ mu2, const int32_t* __restrict__ ns,
            const int32_t* __restrict__ ms,
            const __grid_constant__ AffineMs0Consts cs, int B, int N,
            int M, const __grid_constant__ Ms0Link link) {
  extern __shared__ int32_t smem[];
  const int b = kResident ? 0 : blockIdx.x;
  const int n = ns != nullptr ? ns[b] : N, m = ms != nullptr ? ms[b] : M;
  if (n < 0 || n > N || m < 0 || m > M) return;   // the whole CTA
  const int P = N + 1, ld = M + 1;
  // the CTA's rows [r0, r1), at local rows i - r0 + kHalo of lines of L
  // values (all of the pair's rows, L = P, but on route "resident")
  constexpr int kHalo = kResident ? 1 : 0;
  const int cta = static_cast<int>(blockIdx.x);
  const int r0 = kResident ? min(n + 1, cta * link.rows) : 0;
  const int r1 = kResident ? min(n + 1, r0 + link.rows) : n + 1;
  if (kResident && r0 >= r1) return;                // a CTA without rows
  const int L = kResident ? link.rows + 1 : P;
  const int slab = AffineMs0::kStates * L;
  int32_t* ring = smem;                             // [3][3][L]
  int32_t* mine = rings != nullptr
                      ? rings + static_cast<size_t>(b) * RING *
                                    AffineMs0::kStates * P
                      : nullptr;
  // the ring's lines, or on route "resident" its own rows of them
  const int width = r1 - r0;
  auto lines = [&](const auto& copy) {
    if constexpr (kResident) {
      for (int x = threadIdx.x; x < RING * AffineMs0::kStates * width;
           x += blockDim.x) {
        const int line = x / width, l = x - line * width;
        copy(ring[line * L + kHalo + l],
             mine[static_cast<size_t>(line) * P + r0 + l]);
      }
    } else {
      for (int x = threadIdx.x; x < RING * slab; x += blockDim.x)
        copy(ring[x], mine[x]);
    }
  };
  if (mine != nullptr)
    lines([](int32_t& cell, int32_t& arg) { cell = arg; });
  // value (i, j) of this pair's tables is value first + i * ld + j of the
  // stacks
  const long long total = static_cast<long long>(B) * P * ld;
  const long long first = static_cast<long long>(b) * P * ld;
  const int lead1 = static_cast<int>(reinterpret_cast<uintptr_t>(mu1) / 4 & 3);
  const int lead2 = static_cast<int>(reinterpret_cast<uintptr_t>(mu2) / 4 & 3);
  int4 c1[kRows] = {}, c2[kRows] = {};
  // the chunks of the rows live on diagonal d whose value there opens one
  auto fetch = [&](int d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r0 + threadIdx.x + r * blockDim.x, j = d - i;
      if (i >= r1 || j < 0 || j > m) continue;
      const long long g = first + static_cast<long long>(i) * ld + j;
      if (j == 0 || ((lead1 + g) & 3) == 0)
        c1[r] = table_chunk(mu1, total, lead1, g);
      if (j == 0 || ((lead2 + g) & 3) == 0)
        c2[r] = table_chunk(mu2, total, lead2, g);
    }
  };
  // the diagonals this CTA walks: every one, but on route "resident" those
  // of its own rows
  const int d_first = kResident ? r0 : 0;
  const int d_last = kResident ? min(n + m, r1 - 1 + m) : n + m;
  // Route "resident": this CTA's block of the halo, where its last row
  // goes, and the block above, which its first row reads.  Thread
  // `publisher` publishes the one, after the barrier that ends a diagonal
  // (which orders the last row's stores before the release); thread
  // `copier` copies the other into local row 0 of the ring's slot of e
  // during diagonal e (before the first, e = r0 - 1), for the first row's
  // diagonals e+1 and e+2, once the flag of the CTA above shows it: by
  // cp.async into one of two staging rows after the ring, then into the
  // ring, and e+1's on its way already where the flag shows it.  It keeps
  // the flag's value as it read it (`seen` > e: e's halo is in memory) and
  // polls again only for a diagonal beyond.  The two are the last threads
  // of the last two warps with no rows, where the CTA has two (the host
  // gives two warps more; else both the last thread of the one, else the
  // first row's), so that no row's chain waits for a flag, a store's
  // acknowledgement or a copy, and the release of `publisher` (a fence)
  // does not wait for the copies of `copier` in flight.
  const long long block = static_cast<long long>(n + m + 1) *
                          AffineMs0::kStates;
  int32_t* halo_out = kResident && r1 <= n ? link.halo + cta * block
                                           : nullptr;
  const int T = blockDim.x;
  const int spare = width < T ? (T - (width + 31) / 32 * 32) / 32 : 0;
  const int copier_t = spare >= 1 ? T - 1 : 0;
  const bool copier = kResident && threadIdx.x == copier_t;
  const bool publisher =
      kResident && threadIdx.x == (spare >= 2 ? T - 33 : copier_t);
  const int32_t* halo_in = copier && r0 > 0 ? link.halo + (cta - 1) * block
                                       : nullptr;
  int32_t* hbuf = ring + RING * slab;               // [2][3]: e % 2
  int seen = 0, staged_e = -1;
  const auto stage = [&](int e) {
    for (int t = 0; t < AffineMs0::kStates; ++t)
      __pipeline_memcpy_async(
          hbuf + (e & 1) * AffineMs0::kStates + t,
          halo_in + static_cast<long long>(e) * AffineMs0::kStates + t,
          sizeof(int32_t));
    __pipeline_commit();
  };
  const auto pull = [&](int e) {
    if (staged_e != e) {
      if (seen <= e)
        seen = flag_wait(link.flags + cta - 1, e + 1, false, link.fault,
                         e + 1, 1);
      stage(e);
    }
    __pipeline_wait_prior(0);
    int32_t* to = ring + slab_of<true>(e) * slab;
    for (int t = 0; t < AffineMs0::kStates; ++t)
      to[t * L] = hbuf[(e & 1) * AffineMs0::kStates + t];
    staged_e = -1;
    if (e + 2 <= r0 + m) {                  // e+1's, read from e+2 on
      if (seen <= e + 1) seen = flag_acquire(link.flags + cta - 1, false);
      if (seen > e + 1) {
        stage(e + 1);
        staged_e = e + 1;
      }
    }
  };
  // whether the CTA's last row, live on diagonal e, goes to the next CTA
  const auto publishes = [&](int e) {
    return publisher && halo_out != nullptr && e >= r1 - 1 &&
           e - (r1 - 1) <= m;
  };
  fetch(d_first);
  if (halo_in != nullptr) pull(r0 - 1);
  __syncthreads();

  for (int d = d_first; d <= d_last; ++d) {
    int32_t v1[kRows], v2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {   // this diagonal's values, then the
      const int i = r0 + threadIdx.x + r * blockDim.x;  // next one's chunks
      const unsigned g = static_cast<unsigned>(first) +
                         static_cast<unsigned>(i) * ld + (d - i);
      v1[r] = chunk_value(c1[r], (lead1 + g) & 3);
      v2[r] = chunk_value(c2[r], (lead2 + g) & 3);
    }
    fetch(d + 1);
    const int32_t* d1 = ring + slab_of<true>(d - 1) * slab;
    const int32_t* d2 = ring + slab_of<true>(d - 2) * slab;
    int32_t* here = ring + slab_of<true>(d) * slab;
    const int lo = max(r0, d - m), hi = min(r1 - 1, d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r0 + threadIdx.x + r * blockDim.x, j = d - i;
      if (i < lo || i > hi) continue;
      const int at = i - r0 + kHalo;
#pragma unroll
      for (int t = 0; t < AffineMs0::kStates; ++t) {
        int32_t v = AffineMs0::outer(d1, d2, L, cs, v1[r], v2[r], t, 0, 0,
                                     at, i, j, 0, 1);
        if (d == 0) v = AffineMs0::origin(t);      // the one row, i = 0
        here[t * L + at] = v;
        if (kResident && i == r1 - 1 && halo_out != nullptr)
          halo_out[static_cast<long long>(d) * 3 + t] = v;
      }
    }
    if (halo_in != nullptr && d + 1 <= r0 + m) pull(d);   // for d+1
    __syncthreads();
    if (publishes(d)) flag_release(link.flags + cta, d + 1, false);
  }

  if (out != nullptr && threadIdx.x == 0)
    out[b] = AffineMs0::score(ring + slab_of<true>(n + m) * slab, P, 0, n);
  if (mine != nullptr)
    lines([](int32_t& cell, int32_t& arg) { arg = cell; });
}

// Bytes of dynamic shared memory of one CTA of K6 on a bucket of N+1 rows:
// the ring [3, cells, N+1], mu2's anti-diagonals [4S+2, N+1] and mu1's
// double buffer [2, N+1]; cuda_dp.cta_shared_bytes is the same sum.
template <class Tile>
size_t cta_shared_bytes(int N, int S) {
  const int cells = Tile::kStates * (2 * S + 1) * (2 * S + 1);
  return static_cast<size_t>(N + 1) * (RING * cells + 4 * S + 4) *
         sizeof(int32_t);
}

// Scores B >= 1 pairs on `stream` in one launch of K6 at any max_shift S,
// on `threads` threads a CTA (0: one a value of the widest diagonal, in
// whole warps, up to kCtaThreads<Tile>); `consts` (host memory) are the
// case constants.  Returns 0, or the first error (of the shared-memory opt-in,
// a CTA beyond its limits, or the launch) as a cudaError_t value.
template <class Tile>
int run_cta_scores(int32_t* rings, int32_t* out, const int32_t* mu1,
                   const int32_t* mu2, const int32_t* ns, const int32_t* ms,
                   const int32_t* consts, int B, int N, int M, int S,
                   int threads, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const int values = Tile::kStates * (2 * S + 1) * (2 * S + 1) * (N + 1);
  if (threads <= 0)
    threads = std::min(kCtaThreads<Tile>, (values + 31) / 32 * 32);
  if (threads > kCtaMaxThreads) return cudaErrorInvalidValue;
  const size_t bytes = cta_shared_bytes<Tile>(N, S);
  return with_shift(S, [&](auto shift) {
    const auto kernel = cta_scores<Tile, decltype(shift)::value>;
    BIALIGN_TRY(tile_ready(kernel, TileGeometry{1, threads, bytes}, 0));
    kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
        rings, out, mu1, mu2, ns, ms, cs, N, M, S);
    return static_cast<int>(cudaGetLastError());
  });
}

// K3/K7: B >= 1 pairs (`ns`, `ms` null: one pair of N x M) on `stream` in
// one launch, `threads` a CTA (0: one a row up to kCtaMaxThreads); a
// thread takes up to kMs0RowsPerThread rows.  `consts` (host memory): the
// constants [3, 3].  Returns 0, or the first error as a cudaError_t value
// (cudaErrorInvalidValue for rows beyond one CTA).
inline int run_cta_ms0(int32_t* rings, int32_t* out, const int32_t* mu1,
                       const int32_t* mu2, const int32_t* ns,
                       const int32_t* ms, const int32_t* consts, int B, int N,
                       int M, int threads, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  AffineMs0Consts cs;
  std::memcpy(&cs, consts, sizeof cs);
  if (threads <= 0)
    threads = std::min(kCtaMaxThreads, (N + 1 + 31) / 32 * 32);
  const int rows = (N + threads) / threads;        // a thread's, at most
  if (threads > kCtaMaxThreads || rows > kMs0RowsPerThread)
    return cudaErrorInvalidValue;
  const size_t bytes =                              // the ring [3, 3, N+1]
      static_cast<size_t>(RING) * AffineMs0::kStates * (N + 1) *
      sizeof(int32_t);
  auto launch = [&](auto kernel) {
    BIALIGN_TRY(tile_ready(kernel, TileGeometry{1, threads, bytes}, 0));
    kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
        rings, out, mu1, mu2, ns, ms, cs, B, N, M, Ms0Link{});
    return static_cast<int>(cudaGetLastError());
  };
  static_assert(kMs0RowsPerThread == 4, "one instantiation a row count");
  return rows == 1 ? launch(cta_ms0<1>)
                   : rows == 2 ? launch(cta_ms0<2>) : launch(cta_ms0<4>);
}

}  // namespace
}  // namespace bialign
