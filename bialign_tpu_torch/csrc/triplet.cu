// The triplet aligner's fill: a 3-D banded max-plus wavefront over one copy
// of A and two copies of B (bialign_tpu_torch/models/triplet.py), one CTA
// for the pair.
//
// Replaces bialign_tpu/models/triplet.py:fill_xla, the XLA scan over the
// anti-diagonals d = i + j (jit at :188).  Both routes leave what the plain
// twin fill_slabs leaves: the slabs ys[d, i, sk] int32 [n+m+1, n+1, 2S+1],
// the band offset sk = k - j + S, on every cell of the domain (rows
// max(0, d-m) <= i <= min(n, d), 0 <= k <= m) and nowhere else: a cell off
// the domain is never written, and by the guards never read.  The host
// (models/triplet.py triplet_route) picks the route before the launch.
//
// Route "shared" (`triplet_fill_shared`, bialign_triplet_fill_shared).  One
// CTA runs every diagonal, one __syncthreads() between two; a thread takes
// the rows i = threadIdx.x (mod blockDim.x) and, for each, the band offsets
// sk in increasing order.  The working set stays on the SM:
//  - the last three diagonals, a ring [3, n+1, W] of int32 in dynamic
//    shared memory: diagonal d goes to slot d % 3, and the six cases that
//    advance i or j read diagonals d-1 and d-2 there.  The kernel reads no
//    value of ys: each value is stored to ys as it is made, and nothing
//    waits on that store.  Rows off a diagonal's live range and offsets off
//    the domain are never written, and no value of theirs enters a maximum
//    (the cases' guards mask them), so the ring needs no initialisation;
//  - the seventh case, (0,0,1), advances k within the diagonal and reads
//    the row's value at sk-1, which the same thread has just made and keeps
//    in a register (`prev`), so no barrier falls inside a diagonal;
//  - the tables, off the chain.  Along row i each diagonal moves the values
//    it needs, mu1[i, d-i] and mu2[i, d-i-S .. d-i+S], by one column, so
//    they are fetched ahead.  With one row a thread and W compiled
//    (`kStaged` false) they sit in registers: a window of W values of mu2
//    and one of mu1.  The host skews the tables (models/triplet.py
//    shared_tables: value (i, k) at row i + k), so that the values a
//    diagonal brings to a warp's rows lie side by side, and each row
//    loads those of four diagonals at once, four diagonals before the
//    first is used; the loads alternate between two sets of registers
//    whose roles the code fixes, so that no instruction reads a load in
//    flight.  (A warp waits for a register as a whole: rows that loaded on
//    different diagonals, or a load copied out of the registers it landed
//    in, made every lane wait for a load each diagonal.  And from the
//    tables in their own layout each lane's row was a cache line of its
//    own: a quarter of the kernel's time at DNA-Pol-1.)  With several rows
//    a thread, or W read at run time (`kStaged` true), the registers
//    cannot hold them: the CTA stages the tables' anti-diagonals kappa =
//    i + k (rows of the skewed tables) in shared memory, mu2 in a ring of
//    W+1 (diagonal d reads kappa = d-S .. d+S) and mu1 in a double buffer,
//    by cp.async of anti-diagonals d+1+S and d+1 issued before diagonal d
//    is computed and waited for before its barrier.
//    Either way no table load stands between a barrier and the maxima it
//    feeds;
//  - no branch on a row's chain.  A row loads its 3W predecessors at once
//    and takes the six cases that advance i or j as a tree of maxima, so
//    only (0,0,1) waits for the value at sk-1.  A warp whose live rows all
//    lie inside the domain (i >= 1, j-S >= 1, j+S <= m; decided from the
//    warp's rows, the same on every lane) runs the cases unguarded; the
//    others mask each case's guard into its term (row_values): guards as
//    branches would put a chain of divergent branches, each waiting on a
//    shared load, on the edge rows that every barrier waits for.
// Shared memory: (n+1) W 12 bytes for the ring, (n+1) (W+3) 4 bytes more
// when staged (triplet_shared_bytes; the host's shared_bytes is the same
// sum), at most the 227 KB a CTA can have: one row a thread up to 1023
// rows at max_shift 0-8; staged up to 3873 rows at max_shift 1 and 817 at 8.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/triplet_probe.py,
// PERF.md, Findings): one SM issues every live row's ~100 instructions a
// diagonal and its shared and global accesses (9 loads, 3 + 3 stores); at
// DNA-Pol-1 a diagonal takes ~1,240 cycles, a warp waits ~40 of them at
// the barrier, and a pair of one row still takes ~800 a diagonal, its
// chain's.
//
// Route "global" (`triplet_fill`, bialign_triplet_fill), for pairs whose
// ring does not fit one CTA.  The same CTA and rows, but the six cases read
// diagonals d-1 and d-2 back from ys, which the kernel wrote before the
// barrier (the last two diagonals stay in the L1 and the L2), and the
// tables are read where a cell needs them.
//
// Not carried over from the XLA scan: its diagonal tables MU1D/MU2D (the
// TPU's gather-free skew), the padded shifts of whole slabs, and the
// unrolled sweep of the (0,0,1) case over all W offsets.
//
// Arithmetic: int32 that wraps as torch's and XLA's int32 do.  The adds run
// in uint32_t (signed overflow is undefined in C++), so that the kernel
// equals the twin also on tables whose sums leave int32.  The sentinels are
// the twin's: INVALID for an empty maximum, NEG_INF for an unreachable
// cell (csrc/common.cuh).

#include <algorithm>

#include <cuda_pipeline.h>

#include "common.cuh"

namespace bialign {
namespace {

// Band widths W = 2S+1 compiled as constants (S = 0..kTripletStaticShifts);
// a larger S runs the same code with W read at run time.
constexpr int kTripletStaticShifts = 8;
constexpr int kTripletMaxThreads = 1024;
// Dynamic shared memory of one CTA on an H100: at most, and without the
// opt-in attribute
constexpr size_t kTripletSharedLimit = 232448;
constexpr size_t kTripletSharedDefault = 48 * 1024;

// a + b (+ c), wrapping as int32 does
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b, int32_t c) {
  return wrap_add(wrap_add(a, b), c);
}

// The fill of ys [n+m+1, n+1, W] from mu1, mu2 [n+1, m+1]; two_gamma =
// 2 gamma and gamma_delta = gamma + Delta, each reduced to int32.  kW = W,
// or 0 for W = 2S+1 at run time.
template <int kW>
__global__ void __launch_bounds__(kTripletMaxThreads)
    triplet_fill(int32_t* ys, const int32_t* __restrict__ mu1,
                 const int32_t* __restrict__ mu2, int n, int m, int S,
                 int32_t two_gamma, int32_t gamma_delta) {
  const int W = kW > 0 ? kW : 2 * S + 1;
  const long long P = n + 1;
  const long long ld = m + 1;
  const int T = blockDim.x, t = threadIdx.x;
  for (int d = 0; d <= n + m; ++d) {
    const int lo = max(0, d - m), hi = min(n, d);
    // the first live row i = t (mod T)
    for (int i = lo + (t + T - lo % T) % T; i <= hi; i += T) {
      const int j = d - i;
      const bool up = i >= 1, left = j >= 1;
      // the rows read: (d-1, i), (d-1, i-1), (d-2, i-1); and written
      const long long here = (static_cast<long long>(d) * P + i) * W;
      const long long a = here - P * W;             // d-1, row i
      const long long b = a - W;                    // d-1, row i-1
      const long long c = here - 2 * P * W - W;     // d-2, row i-1
      const int32_t* mu2_row = mu2 + i * ld;
      const int32_t m1 = mu1[i * ld + j];
      int32_t prev = NEG_INF;                       // the value at sk-1
#pragma unroll
      for (int sk = 0; sk < W; ++sk) {
        const int k = j + sk - S;
        if (k < 0) continue;
        if (k > m) break;
        const bool deep = k >= 1, wide = sk + 1 < W;
        const int32_t m2 = mu2_row[k];
        int32_t best = INVALID;
        if (up && left && deep)                               // (1,1,1)
          best = max(best, wrap_add(ys[c + sk], m1, m2));
        if (up)                                               // (1,0,0)
          best = max(best, wrap_add(ys[b + sk], two_gamma));
        if (left && deep)                                     // (0,1,1)
          best = max(best, wrap_add(ys[a + sk], two_gamma));
        if (up && left && wide)                               // (1,1,0)
          best = max(best, wrap_add(ys[c + sk + 1], gamma_delta, m1));
        if (up && deep && sk >= 1)                            // (1,0,1)
          best = max(best, wrap_add(ys[b + sk - 1], gamma_delta, m2));
        if (left && wide)                                     // (0,1,0)
          best = max(best, wrap_add(ys[a + sk + 1], gamma_delta));
        if (deep && sk >= 1)                                  // (0,0,1)
          best = max(best, wrap_add(prev, gamma_delta));
        int32_t v = best == INVALID ? NEG_INF : best;
        if (d == 0 && sk == S) v = 0;                         // the origin
        ys[here + sk] = v;
        prev = v;
      }
    }
    __syncthreads();
  }
}

template <int kW>
cudaError_t launch(int32_t* ys, const int32_t* mu1, const int32_t* mu2, int n,
                   int m, int S, int32_t two_gamma, int32_t gamma_delta,
                   int threads, cudaStream_t st) {
  const auto kernel = triplet_fill<kW>;
  kernel<<<1, threads, 0, st>>>(ys, mu1, mu2, n, m, S, two_gamma,
                                gamma_delta);
  return cudaGetLastError();
}

// -- route "shared" ----------------------------------------------------------

// Whether route "shared" stages the tables in shared memory: several rows a
// thread, or W at run time.
inline bool triplet_staged(int n, int S, int threads) {
  return S > kTripletStaticShifts || n + 1 > threads;
}

// Bytes of route "shared"'s dynamic shared memory: the ring [3, n+1, W],
// and when staged mu2's anti-diagonals [W+1, n+1] and mu1's [2, n+1].
inline size_t triplet_shared_bytes(int n, int S, bool staged) {
  const size_t W = 2 * static_cast<size_t>(S) + 1;
  return static_cast<size_t>(n + 1) * (3 * W + (staged ? W + 3 : 0)) *
         sizeof(int32_t);
}

// One row's W values of diagonal d (route "shared"): the ring's rows `a`
// (d-1, i), `b` (d-1, i-1) and `c` (d-2, i-1), mu1[i, j] `m1` and
// mu2[i, j+sk-S] as `m2_at(sk)`; each value of the domain goes to the
// ring's row `here` and to ys at `out`.  No branch: with W compiled the
// 3W predecessors are loaded at once, before any maximum (at i = 0 `b` and
// `c` are row i's own, in the ring and never taken), and every case the
// guards exclude gives INVALID to the maximum, so that a value off the
// domain may be loaded with its row but never enters a maximum; the six
// cases that advance i or j meet in a tree of maxima, and only (0,0,1)
// waits for the value at sk-1.  With W at run time each predecessor is
// read under its case's guard.
template <int kW, class M2At>
__device__ __forceinline__ void row_values(
    int32_t* here, int32_t* out, const int32_t* a, const int32_t* b,
    const int32_t* c, int32_t m1, const M2At& m2_at, int d, int i, int j,
    int m, int S, int32_t two_gamma, int32_t gamma_delta) {
  const int W = kW > 0 ? kW : 2 * S + 1;
  int32_t A[kW > 0 ? kW : 1], B[kW > 0 ? kW : 1], C[kW > 0 ? kW : 1];
  if constexpr (kW > 0) {
#pragma unroll
    for (int x = 0; x < kW; ++x) {
      A[x] = a[x];
      B[x] = b[x];
      C[x] = c[x];
    }
  }
  const auto at = [&](const int32_t* row, const int32_t* held, int x) {
    if constexpr (kW > 0)
      return held[x];
    else
      return row[x];
  };
  const bool up = i >= 1, left = j >= 1;
  int32_t prev = NEG_INF;                           // the value at sk-1
#pragma unroll
  for (int sk = 0; sk < W; ++sk) {
    const int k = j + sk - S;
    const bool live = k >= 0 && k <= m;
    const bool deep = live && k >= 1, wide = live && sk + 1 < W;
    const int32_t m2 = m2_at(sk);
    const int32_t t111 = up && left && deep                   // (1,1,1)
        ? wrap_add(at(c, C, sk), m1, m2) : INVALID;
    const int32_t t100 = up && live                           // (1,0,0)
        ? wrap_add(at(b, B, sk), two_gamma) : INVALID;
    const int32_t t011 = left && deep                         // (0,1,1)
        ? wrap_add(at(a, A, sk), two_gamma) : INVALID;
    const int32_t t110 = up && left && wide                   // (1,1,0)
        ? wrap_add(at(c, C, sk + 1), gamma_delta, m1) : INVALID;
    const int32_t t101 = up && deep && sk >= 1                // (1,0,1)
        ? wrap_add(at(b, B, sk - 1), gamma_delta, m2) : INVALID;
    const int32_t t010 = left && wide                         // (0,1,0)
        ? wrap_add(at(a, A, sk + 1), gamma_delta) : INVALID;
    int32_t best = max(max(max(t111, t100), max(t011, t110)),
                       max(max(t101, t010), INVALID));
    if (deep && sk >= 1)                                      // (0,0,1)
      best = max(best, wrap_add(prev, gamma_delta));
    int32_t v = best == INVALID ? NEG_INF : best;
    if (d == 0 && sk == S) v = 0;                             // the origin
    if (live) {
      here[sk] = v;
      out[sk] = v;
      prev = v;
    }
  }
}

// The same for a row whose band lies inside the domain (i >= 1, j - S >=
// 1, j + S <= m; so not the origin), W compiled: every guard but those of
// sk holds, so no case is masked.  Taken by a warp whose live rows all lie
// inside (the rows of the domain's edges are one or two warps a diagonal).
template <int kW, class M2At>
__device__ __forceinline__ void row_inside(
    int32_t* __restrict__ here, int32_t* __restrict__ out,
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ c, int32_t m1, const M2At& m2_at,
    int32_t two_gamma, int32_t gamma_delta) {
  int32_t A[kW], B[kW], C[kW];
#pragma unroll
  for (int x = 0; x < kW; ++x) {
    A[x] = a[x];
    B[x] = b[x];
    C[x] = c[x];
  }
  int32_t prev = NEG_INF;
#pragma unroll
  for (int sk = 0; sk < kW; ++sk) {
    const int32_t m2 = m2_at(sk);
    int32_t best = max(max(INVALID, wrap_add(C[sk], m1, m2)),    // (1,1,1)
                       max(wrap_add(B[sk], two_gamma),           // (1,0,0)
                           wrap_add(A[sk], two_gamma)));         // (0,1,1)
    if (sk + 1 < kW)
      best = max(best, max(wrap_add(C[sk + 1], gamma_delta, m1), // (1,1,0)
                           wrap_add(A[sk + 1], gamma_delta)));   // (0,1,0)
    if (sk >= 1)
      best = max(max(best, wrap_add(B[sk - 1], gamma_delta, m2)),  // (1,0,1)
                 wrap_add(prev, gamma_delta));                     // (0,0,1)
    const int32_t v = best == INVALID ? NEG_INF : best;
    here[sk] = v;
    out[sk] = v;
    prev = v;
  }
}

// The tables of route "shared" (models/triplet.py shared_tables), each
// skewed: value (i, k) at X[(i + k) (n+1) + i], rows e = i + k from 0 to
// triplet_skew_rows - 1, zero where k lies outside [0, m].  Row e of mu1
// holds the values mu1[i, e-i] that diagonal e brings to each row i, and
// row d+S of mu2 the values mu2[i, d-i+S]: a warp's rows read them from
// one or two cache lines, where rows of the tables' own layout lie in as
// many lines as the warp has lanes.  Row kappa is also the anti-diagonal
// that kStaged copies.
__host__ __device__ __forceinline__ int triplet_skew_rows(int n, int m,
                                                          int S) {
  return n + m + S + 8;
}

// The four values of rows e, e+1, e+2, e+3 of a skewed table at column i.
__device__ __forceinline__ int4 skewed_quad(const int32_t* __restrict__ x,
                                            int e, int P, int i) {
  const int32_t* at = x + static_cast<long long>(e) * P + i;
  return int4{__ldg(at), __ldg(at + P), __ldg(at + 2 * P),
              __ldg(at + 3 * P)};
}

// Row kappa of a skewed table (the rows i of anti-diagonal kappa) into
// dst[i], asynchronously, by the whole CTA (kStaged true).
__device__ __forceinline__ void stage_antidiagonal(
    int32_t* dst, const int32_t* __restrict__ x, int kappa, int n, int m) {
  const int32_t* row = x + static_cast<long long>(kappa) * (n + 1);
  for (int i = max(0, kappa - m) + threadIdx.x; i <= min(n, kappa);
       i += blockDim.x)
    __pipeline_memcpy_async(dst + i, row + i, sizeof(int32_t));
}

// Route "shared": the fill of ys [n+m+1, n+1, W] (only the domain's cells
// written), the last three diagonals in shared memory; kW = W, or 0 for W
// at run time (then kStaged).  kStaged false needs n+1 <= blockDim.x.  The
// tables skewed, as above.
template <int kW, bool kStaged>
__global__ void __launch_bounds__(kTripletMaxThreads)
    triplet_fill_shared(int32_t* ys, const int32_t* __restrict__ mu1,
                        const int32_t* __restrict__ mu2, int n, int m, int S,
                        int32_t two_gamma, int32_t gamma_delta) {
  static_assert(kStaged || kW > 0, "registers hold compiled widths only");
  extern __shared__ int32_t smem[];
  const int W = kW > 0 ? kW : 2 * S + 1;
  const int P = n + 1;
  const int slab = P * W;
  const int T = blockDim.x, t = threadIdx.x;
  int32_t* ring = smem;                     // [3][P][W]: slot d % 3
  int32_t* m2s = ring + 3 * slab;           // [W+1][P]: slot kappa % (W+1)
  int32_t* m1s = m2s + (W + 1) * P;         // [2][P]: slot d % 2

  // One diagonal: each of this thread's live rows, its W values from the
  // ring's diagonals d-1 and d-2 and the tables' values `m1` and
  // `m2_at(sk)` (of the row i), to the ring and to ys.
  int r0 = 0, r1 = 2, r2 = 1;               // slots of d, d-1, d-2
  // (`inside`: every live row of this thread's warp lies inside)
  auto diagonal_rows = [&](int d, int i, const auto& m1_of,
                           const auto& m2_of, bool inside) {
    int32_t* here = ring + r0 * slab + i * W;
    int32_t* out = ys + (static_cast<long long>(d) * P + i) * W;
    const int32_t* a = ring + r1 * slab + i * W;   // d-1, row i
    const int up = i >= 1 ? W : 0;
    const int32_t* b = a - up;                     // d-1, row i-1
    const int32_t* c = ring + r2 * slab + i * W - up;   // d-2, row i-1
    const auto m2_at = [&](int sk) { return m2_of(i, sk); };
    if constexpr (kW > 0) {
      if (inside) {
        row_inside<kW>(here, out, a, b, c, m1_of(i), m2_at, two_gamma,
                       gamma_delta);
        return;
      }
    }
    row_values<kW>(here, out, a, b, c, m1_of(i), m2_at, d, i, d - i, m, S,
                   two_gamma, gamma_delta);
  };
  // the barrier that ends diagonal d
  auto end_diagonal = [&] {
    __syncthreads();
    const int r = r2;
    r2 = r1;
    r1 = r0;
    r0 = r;
  };

  if constexpr (kStaged) {
    // The tables' anti-diagonals: diagonal d reads mu2's kappa = d-S ..
    // d+S and mu1's kappa = d, staged a diagonal ahead.
    for (int kappa = 0; kappa <= S; ++kappa)
      stage_antidiagonal(m2s + kappa % (W + 1) * P, mu2, kappa, n, m);
    stage_antidiagonal(m1s, mu1, 0, n, m);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int d = 0; d <= n + m; ++d) {
      stage_antidiagonal(m2s + (d + 1 + S) % (W + 1) * P, mu2, d + 1 + S, n,
                         m);
      stage_antidiagonal(m1s + (d + 1) % 2 * P, mu1, d + 1, n, m);
      __pipeline_commit();
      const int lo = max(0, d - m), hi = min(n, d);
      const int32_t* m1d = m1s + d % 2 * P;
      const int kslot = (d - S + S * (W + 1)) % (W + 1);   // kappa = d - S
      for (int i = lo + (t + T - lo % T) % T; i <= hi; i += T)
        diagonal_rows(
            d, i, [&](int row) { return m1d[row]; },
            [&](int row, int sk) {
              const int s = kslot + sk;
              return m2s[(s >= W + 1 ? s - (W + 1) : s) * P + row];
            },
            false);
      __pipeline_wait_prior(0);
      end_diagonal();
    }
  } else {
    // Row i = t in registers: mu1[t, d-t] and a window of mu2[t, d-t-S ..
    // d-t+S] on diagonal d, from rows of the skewed tables four at a time:
    // on the diagonals d = 4g .. 4g+3 of group g, mu1's rows d and mu2's
    // rows d+1+S (the value the window takes after diagonal d).  Even
    // groups read (qa1, qa2) and load (qb1, qb2) for the next group, odd
    // ones the other way round; the four steps of a group name their
    // registers, so nothing selects among them at run time.
    const bool mine = t <= n;
    int32_t w2[kW];
    int4 qa1{}, qa2{}, qb1{}, qb2{};
    if (mine) {     // diagonal 0: mu2[t, -t-S .. -t+S]; rows e < 0 unused
#pragma unroll
      for (int sk = 0; sk < kW; ++sk)
        w2[sk] = sk < S ? 0 : mu2[static_cast<long long>(sk - S) * P + t];
      qa1 = skewed_quad(mu1, 0, P, t);
      qa2 = skewed_quad(mu2, 1 + S, P, t);
    }
    __syncthreads();
    int d = 0;
    // diagonal d with mu1[t, d-t] = m1; then the window takes v2
    const auto step = [&](int32_t m1, int32_t v2) {
      if (mine && d >= t && d - t <= m) {
        // this warp's live rows, all inside the domain or not (the same
        // answer on every lane: no divergence)
        const int w0 = t & ~31;
        const bool inside = max(max(0, d - m), w0) >= max(1, d - m + S) &&
                            min(min(n, d), w0 + 31) <= d - S - 1;
        diagonal_rows(
            d, t, [&](int) { return m1; },
            [&](int, int sk) { return w2[sk]; }, inside);
      }
#pragma unroll
      for (int sk = 0; sk + 1 < kW; ++sk) w2[sk] = w2[sk + 1];
      w2[kW - 1] = v2;
      end_diagonal();
      return ++d <= n + m;
    };
    const auto group = [&](const int4& use1, const int4& use2, int4& next1,
                           int4& next2) {
      // the next group, if the window is still to meet row t's diagonals
      const int e = d + 4;
      if (mine && e + 3 >= t - kW - 1 && e <= t + m) {
        next1 = skewed_quad(mu1, e, P, t);
        next2 = skewed_quad(mu2, e + 1 + S, P, t);
      }
      return step(use1.x, use2.x) && step(use1.y, use2.y) &&
             step(use1.z, use2.z) && step(use1.w, use2.w);
    };
    while (group(qa1, qa2, qb1, qb2) && group(qb1, qb2, qa1, qa2)) {
    }
  }
}

template <int kW, bool kStaged>
cudaError_t launch_shared(int32_t* ys, const int32_t* mu1, const int32_t* mu2,
                          int n, int m, int S, int32_t two_gamma,
                          int32_t gamma_delta, int threads, size_t bytes,
                          cudaStream_t st) {
  const auto kernel = triplet_fill_shared<kW, kStaged>;
  if (bytes > kTripletSharedDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, threads, bytes, st>>>(ys, mu1, mu2, n, m, S, two_gamma,
                                    gamma_delta);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bialign

// Route "global": the triplet fill of one pair into ys [n+m+1, n+1, 2S+1]
// (any contents; only the domain's cells are written) from the tables
// mu1, mu2 [n+1, m+1] on `stream`, one launch of one CTA of `threads`
// threads (1-1024), the last two diagonals read back from ys.  two_gamma =
// 2 gamma, gamma_delta = gamma + Delta, reduced to int32.  Returns 0 or a
// cudaError_t value.
extern "C" int bialign_triplet_fill(int32_t* ys, const int32_t* mu1,
                                    const int32_t* mu2, int n, int m, int S,
                                    int two_gamma, int gamma_delta,
                                    int threads, int device, void* stream) {
  using namespace bialign;
  if (n < 0 || m < 0 || S < 0 || threads < 1 ||
      threads > kTripletMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  BIALIGN_TRY(cudaSetDevice(device));
  const auto st = static_cast<cudaStream_t>(stream);
  static_assert(kTripletStaticShifts == 8, "one case per compiled width");
  cudaError_t err;
  switch (S) {
#define BIALIGN_TRIPLET_CASE(s)                                              \
  case s:                                                                    \
    err = launch<2 * s + 1>(ys, mu1, mu2, n, m, S, two_gamma, gamma_delta,   \
                            threads, st);                                    \
    break;
    BIALIGN_TRIPLET_CASE(0)
    BIALIGN_TRIPLET_CASE(1)
    BIALIGN_TRIPLET_CASE(2)
    BIALIGN_TRIPLET_CASE(3)
    BIALIGN_TRIPLET_CASE(4)
    BIALIGN_TRIPLET_CASE(5)
    BIALIGN_TRIPLET_CASE(6)
    BIALIGN_TRIPLET_CASE(7)
    BIALIGN_TRIPLET_CASE(8)
#undef BIALIGN_TRIPLET_CASE
    default:
      err = launch<0>(ys, mu1, mu2, n, m, S, two_gamma, gamma_delta, threads,
                      st);
  }
  return static_cast<int>(err);
}

// Route "shared": the same fill, the same arguments, the last three
// diagonals in shared memory (and the tables too when the rows outnumber
// the threads or max_shift exceeds the compiled widths).  The tables come
// skewed, triplet_skew_rows(n, m, S) rows of n+1 values each (the host's
// shared_tables).  Returns cudaErrorInvalidValue, before any launch, for a
// CTA beyond its 227 KB of shared memory (the host's triplet_route sends
// such a pair to "global").
extern "C" int bialign_triplet_fill_shared(int32_t* ys, const int32_t* mu1,
                                           const int32_t* mu2, int n, int m,
                                           int S, int two_gamma,
                                           int gamma_delta, int threads,
                                           int device, void* stream) {
  using namespace bialign;
  if (n < 0 || m < 0 || S < 0 || threads < 1 ||
      threads > kTripletMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = triplet_staged(n, S, threads);
  const size_t bytes = triplet_shared_bytes(n, S, staged);
  if (bytes > kTripletSharedLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  BIALIGN_TRY(cudaSetDevice(device));
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (S) {
#define BIALIGN_TRIPLET_CASE(s)                                              \
  case s:                                                                    \
    err = staged ? launch_shared<2 * s + 1, true>(                           \
                       ys, mu1, mu2, n, m, S, two_gamma, gamma_delta,        \
                       threads, bytes, st)                                   \
                 : launch_shared<2 * s + 1, false>(                          \
                       ys, mu1, mu2, n, m, S, two_gamma, gamma_delta,        \
                       threads, bytes, st);                                  \
    break;
    BIALIGN_TRIPLET_CASE(0)
    BIALIGN_TRIPLET_CASE(1)
    BIALIGN_TRIPLET_CASE(2)
    BIALIGN_TRIPLET_CASE(3)
    BIALIGN_TRIPLET_CASE(4)
    BIALIGN_TRIPLET_CASE(5)
    BIALIGN_TRIPLET_CASE(6)
    BIALIGN_TRIPLET_CASE(7)
    BIALIGN_TRIPLET_CASE(8)
#undef BIALIGN_TRIPLET_CASE
    default:
      err = launch_shared<0, true>(ys, mu1, mu2, n, m, S, two_gamma,
                                   gamma_delta, threads, bytes, st);
  }
  return static_cast<int>(err);
}
