// The triplet aligner's fill: a 3-D banded max-plus wavefront over one copy
// of A and two copies of B (bialign_tpu_torch/models/triplet.py), one CTA
// for the pair, one thread-block cluster of CTAs, or one cooperative grid.
//
// Replaces bialign_tpu/models/triplet.py:fill_xla, the XLA scan over the
// anti-diagonals d = i + j (jit at :188).  Every route leaves what the plain
// twin fill_slabs leaves: the slabs ys[d, i, sk] int32 [n+m+1, n+1, 2S+1],
// the band offset sk = k - j + S, on every cell of the domain (rows
// max(0, d-m) <= i <= min(n, d), 0 <= k <= m) and nowhere else: a cell off
// the domain is never written, and by the guards never read.  The host
// (models/triplet.py triplet_route) picks the route before the launch.
//
// Route "shared" (`triplet_fill_ring<kW, kStaged, Ring::kShared>`,
// bialign_triplet_fill_shared).  One CTA runs every diagonal, one
// __syncthreads() between two; a thread takes the rows i = threadIdx.x (mod
// blockDim.x) and, for each, the band offsets sk in increasing order.  The
// working set stays on the SM:
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
// when staged (triplet_ring_bytes; the host's shared_bytes is the same
// sum), at most the 227 KB a CTA can have: one row a thread up to 1023
// rows at max_shift 0-8; staged up to 3873 rows at max_shift 1 and 817 at 8.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/triplet_probe.py,
// PERF.md, Findings): one SM issues every live row's ~100 instructions a
// diagonal and its shared and global accesses (9 loads, 3 + 3 stores); at
// DNA-Pol-1 a diagonal takes ~1,180 cycles, a warp waits ~45 of them at
// the barrier, and a pair of one row still takes ~790 a diagonal, its
// chain's.
//
// Route "cluster" (`triplet_fill_ring<kW, kStaged, Ring::kCluster>`,
// bialign_triplet_fill_cluster), for pairs whose ring does not fit one CTA,
// taken by default only at the wider bands (max_shift > 8: at the compiled
// widths route "resident" measured faster, PERF.md): one launch of one
// thread-block cluster of C CTAs, each on an SM of its own.  It replaces
// the same XLA scan.  CTA r (its rank in the cluster) takes the
// contiguous rows [r R, min(n+1, (r+1) R)), R = ceil((n+1) / C),
// and runs route "shared"'s body on them: the same thread-to-row mapping,
// the same row functions, the tables in registers (a row a thread, W
// compiled) or staged (its own rows' anti-diagonals only).  Its ring
// [3, R+1, W] holds the last three diagonals of its rows and, as local row
// 0, the halo: row r R - 1, the last row of CTA r-1, which row r R reads as
// its row i-1.  The dependence between rows is one row deep, so in each
// diagonal d the thread of a CTA's last row stores that row's W values
// into the next CTA's halo, slot d % 3, through distributed shared memory
// (cooperative_groups map_shared_rank: a store to shared::cluster), and
// one cluster barrier a diagonal publishes it.  Three slots are enough
// with one barrier a diagonal: slot d % 3 of the halo held diagonal d-3,
// which CTA r+1 last read in diagonal d-1, before the barrier that ends
// d-1 and so before CTA r stores diagonal d there.  Every thread of every
// CTA meets every barrier, live rows or not (a CTA with no rows too), the
// first before any store to another CTA (all have started), the last
// after the last such store: no CTA exits while another may still write
// into it.
// The barrier is the CTA's __syncthreads() (its own rows, for its next
// diagonal) and the cluster's barrier.cluster.arrive.relaxed / .wait
// (acquire), with a fence.acq_rel.cluster in the one thread that stored a
// halo row before it: an arrive with release semantics compiles to a
// MEMBAR.ALL.GPU in every thread, which waits for all the thread's stores
// (0.5 us a diagonal more at 1500 x 1490; the probe's variant release).  The
// slabs do not go to ys from the rows' threads: a row's W values from one
// lane are W stores each to a sector of its own.  The CTA flushes
// diagonal d-1 from its ring slot between the arrive and the wait of
// diagonal d, neighbouring threads on neighbouring cells of ys, and with a
// row a thread only warps added after the rows' flush (where enough fit),
// so that the edge warp, the last to arrive, does not add a flush to each
// diagonal.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/triplet_probe.py;
// PERF.md, Findings), at 1500 x 1490, max_shift 8, C = 8 (188 rows a CTA,
// W = 17): 2.20 us, ~4,400 cycles a diagonal, 130x the byte bound.  The
// slowest warp a diagonal works ~2,200 cycles: the warp of row 0 (i = 0
// masks four cases, so it runs the guarded form while row 0 is live) or a
// warp at one of the domain's two edges; the others' rows take less.  The
// barrier, with the loop's own work, ~1,500 (variant barriers_only: 0.77
// us a diagonal); the flush 0.75 us a diagonal more than none, the halo
// 0.05.  The guarded form at the edges and row 0, and the barrier, are
// what a further redesign has to take.
//
// Route "resident" (`triplet_fill_ring<kW, kStaged, Ring::kResident>`,
// bialign_triplet_fill_resident), for the pairs beyond one CTA at the
// compiled widths, and at the wider bands beyond what a portable cluster
// holds: one cooperative launch of G CTAs (every CTA resident at once; a
// grid the card cannot hold is refused, cudaErrorCooperativeLaunchTooLarge,
// and not cut down).  It replaces the same XLA scan.  CTA g takes the rows
// [g R, min(n+1, (g+1) R)) and runs route "cluster"'s body on them (the
// ring [3, R+1, W] with the halo as local row 0, the tables in registers or
// staged, the slabs flushed from the ring by added warps), with no barrier
// beyond its own CTA:
//  - the halo goes through device memory that no CTA overwrites during the
//    launch, `halo` [G-1, n+m+1, W]: the thread of CTA g's last row stores
//    that row's W values of diagonal d into block g, row d, as it makes
//    them; after the barrier that ends d, thread `publisher` of CTA g
//    publishes d+1 in CTA g's progress flag with a release store
//    (csrc/neighbour_flags.cuh, .gpu scope; the barrier orders the row's
//    stores before it);
//  - thread `copier` of CTA g+1 acquires that flag before it copies row d
//    of block g into local row 0 of the ring's slot of d, during diagonal
//    d, for its first row's diagonals d+1 and d+2: by cp.async into one of
//    two staging rows of shared memory, then into the ring.  Where the flag
//    already shows d+1, it starts d+1's copy too, so that the next
//    diagonal finds it on its way.  It keeps the flag's value as it read
//    it, and polls again only for a diagonal beyond it.
//  `copier` and `publisher` are the last threads of the CTA's last two
//  flush warps (of its one, else the first row's thread), so that no row's
//  chain waits for a flag, a store's acknowledgement or a copy, and the
//  release of `publisher`, a fence, does not wait for the copies of
//  `copier` in flight.
//  A CTA waits only for the CTA above, never for the one below: the halo is
//  never overwritten, so the CTA above runs ahead freely, and once the
//  pipeline is full a handoff costs no diagonal its time.  Each CTA walks
//  only the diagonals of its own rows, d = gR .. min(n+m, (g+1)R - 1 + m),
//  and publishes exactly the diagonals on which its next CTA's first row
//  reads the halo, so every wait ends.  A wait that outlasts its budget (5
//  s on the global timer) writes the fault word and traps.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// --resident-only; PERF.md, Findings): a diagonal is one CTA's rows, R =
// ceil((n+1) / G) with G up to one CTA a SM, so a row's chain of W steps
// and a CTA barrier; the pipeline's fill adds G handoffs once.  At 1500 x
// 1490, max_shift 8 (126 CTAs of 12 rows) 1.37 us a diagonal, 81x the byte
// bound, against route "cluster"'s 2.19 at C = 8; at 7000 x 6990 (130 of
// 54 rows) 1.85 us, 23x, against route "global"'s 101; at the wider bands,
// where the CTA stages its tables on one warp, 4.95 us at 800 x 790,
// max_shift 9, and 6.94 at 500 x 490, 16 (route "cluster" 4.72 and 6.82).
//
// Route "global" (`triplet_fill`, bialign_triplet_fill), taken only when
// forced.  The same CTA and rows as route "shared", but the six cases read
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

#include <cluster_barrier.cuh>
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <neighbour_flags.cuh>

#include "common.cuh"

namespace bialign {
namespace {

// Band widths W = 2S+1 compiled as constants (S = 0..kTripletStaticShifts);
// a larger S runs the same code with W read at run time.
constexpr int kTripletStaticShifts = 8;
// With a row a thread, up to this W a group's four diagonals are four
// inlined steps, each naming its registers; above it one call site in a
// loop selects them, so that the rows' code stands in the kernel once a
// group and not four times: at W = 17 four copies outgrow the SM's
// instruction cache (1500 x 1490, max_shift 8: 2.54 against 2.20 us a
// diagonal; at W = 3 the selects cost more, 0.54 against 0.60 at
// DNA-Pol-1; tools/triplet_probe.py, variant four_steps, NVIDIA H100 80GB
// HBM3, 700 W).  W = 5 to 15 are not measured.
constexpr int kInlinedStepsW = 5;
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

// -- routes "shared" and "cluster" -------------------------------------------

// Threads of a CTA of route "cluster" at most: its rows are a share of the
// pair's, and a compiled W up to 17 wants more than the 64 registers a
// thread that 1024 threads leave.
constexpr int kClusterMaxThreads = 512;
// CTAs of a cluster: at most, and without the non-portable opt-in
constexpr int kClusterMax = 16;
constexpr int kClusterPortable = 8;

// How the CTAs of one launch of triplet_fill_ring share the rows: one CTA
// (route "shared"), a thread-block cluster (route "cluster"), or a
// cooperative grid (route "resident", whose CTAs take at most as many
// threads as a cluster's).
enum class Ring { kShared, kCluster, kResident };

// Route "resident": the CTAs' last rows, diagonal by diagonal, `halo`
// [G-1, n+m+1, W] (block g CTA g's); each CTA's progress, `flags` [G]
// (zeroed before the launch; d+1 once block g holds diagonal d); the fault
// word (csrc/neighbour_flags.cuh) as the card sees it, or null.  Unused
// (null) on the other routes.
struct ResidentLink {
  int32_t* halo;
  int32_t* flags;
  int32_t* fault;
};

// Whether a CTA stages the tables in shared memory: several rows a thread,
// or W at run time.
inline bool triplet_staged(int rows, int S, int threads) {
  return S > kTripletStaticShifts || rows > threads;
}

// Bytes of a CTA's dynamic shared memory for `rows` rows of its own: the
// ring [3, rows + halo, W] (halo 1 on routes "cluster" and "resident": the
// row before the CTA's first), and when staged mu2's anti-diagonals
// [W+1, rows] and mu1's [2, rows].  Route "shared": rows n+1, halo 0.
inline size_t triplet_ring_bytes(int rows, int halo, int S, bool staged) {
  const size_t W = 2 * static_cast<size_t>(S) + 1;
  return (3 * static_cast<size_t>(rows + halo) * W +
          (staged ? static_cast<size_t>(rows) * (W + 3) : 0)) *
         sizeof(int32_t);
}

// One row's W values of diagonal d (the ring routes): the ring's rows `a`
// (d-1, i), `b` (d-1, i-1) and `c` (d-2, i-1), mu1[i, j] `m1` and
// mu2[i, j+sk-S] as `m2_at(sk)`; each value of the domain goes to the
// ring's row `here`, on route "shared" to ys at `out` (on routes "cluster"
// and "resident" null: the CTA flushes its rows a diagonal later) and, for
// the last row of a CTA that has a right neighbour, to that CTA's halo row
// or on route "resident" to the CTA's row d of the halo memory, `halo`
// (else null).
// No branch: with W compiled the 3W predecessors are loaded at once,
// before any maximum (at i = 0 `b` and `c` are row i's own, in the ring
// and never taken), and every case the guards exclude gives INVALID to the
// maximum, so that a value off the domain may be loaded with its row but
// never enters a maximum; the six cases that advance i or j meet in a tree
// of maxima, and only (0,0,1) waits for the value at sk-1.  With W at run
// time each predecessor is read under its case's guard.
template <int kW, class M2At>
__device__ __forceinline__ void row_values(
    int32_t* here, int32_t* out, int32_t* halo, const int32_t* a,
    const int32_t* b, const int32_t* c, int32_t m1, const M2At& m2_at, int d,
    int i, int j, int m, int S, int32_t two_gamma, int32_t gamma_delta) {
  // S and W as constants where kW is compiled, so that each step's guards
  // compare j with a constant
  const int Sx = kW > 0 ? (kW - 1) / 2 : S;
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
  const int jm = j - m;
  int32_t prev = NEG_INF;                           // the value at sk-1
#pragma unroll
  for (int sk = 0; sk < W; ++sk) {
    // k = j + sk - S: live 0 <= k <= m, deep k >= 1
    const int off = Sx - sk;
    const bool live = j >= off && jm <= off;
    const bool deep = live && j > off, wide = live && sk + 1 < W;
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
    if (sk == Sx && d == 0) v = 0;                            // the origin
    // (no branch: a store each under its predicate, and `prev` always v,
    // since where sk is off the domain so is the (0,0,1) term of sk+1 or
    // sk+1 itself; a branch a step kept the compiler from overlapping
    // the steps)
    if (live) here[sk] = v;
    if (live && out != nullptr) out[sk] = v;
    if (live && halo != nullptr) halo[sk] = v;
    prev = v;
  }
}

// The same for a row whose band lies inside the domain (i >= 1, j - S >=
// 1, j + S <= m; so not the origin), W compiled: every guard but those of
// sk holds, so no case is masked.  Taken by a warp whose live rows all lie
// inside (the rows of the domain's edges are one or two warps a diagonal).
template <int kW, class M2At>
__device__ __forceinline__ void row_inside(
    int32_t* __restrict__ here, int32_t* __restrict__ out,
    int32_t* __restrict__ halo, const int32_t* __restrict__ a,
    const int32_t* __restrict__ b, const int32_t* __restrict__ c, int32_t m1,
    const M2At& m2_at, int32_t two_gamma, int32_t gamma_delta) {
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
    if (out != nullptr) out[sk] = v;
    if (halo != nullptr) halo[sk] = v;
    prev = v;
  }
}

// The tables of routes "shared" and "cluster" (models/triplet.py
// shared_tables), each skewed: value (i, k) at X[(i + k) (n+1) + i], rows
// e = i + k from 0 to triplet_skew_rows - 1, zero where k lies outside
// [0, m].  Row e of mu1 holds the values mu1[i, e-i] that diagonal e
// brings to each row i, and row d+S of mu2 the values mu2[i, d-i+S]: a
// warp's rows read them from one or two cache lines, where rows of the
// tables' own layout lie in as many lines as the warp has lanes.  Row
// kappa is also the anti-diagonal that kStaged copies.
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

// Row kappa of a skewed table, the CTA's rows i in [first, end) of
// anti-diagonal kappa, into dst[i - first], asynchronously, by the whole
// CTA (kStaged true).
__device__ __forceinline__ void stage_antidiagonal(
    int32_t* dst, const int32_t* __restrict__ x, int kappa, int n, int m,
    int first, int end) {
  const int32_t* row = x + static_cast<long long>(kappa) * (n + 1);
  for (int i = max(first, kappa - m) + threadIdx.x; i <= min(end - 1, kappa);
       i += blockDim.x)
    __pipeline_memcpy_async(dst + i - first, row + i, sizeof(int32_t));
}

// The barrier between two diagonals: the CTA's, and on route "cluster"
// then the cluster's (csrc/cluster_barrier.cuh), whose arrive is relaxed:
// the thread that stored a halo row into the next CTA's shared memory
// orders it by a fence at cluster scope first (`halo`).  (An arrive with
// release semantics is a MEMBAR.ALL.GPU in every thread, which waits for
// all its stores to ys.)  On route "cluster" the work `between` runs after
// the arrive and before the wait, on route "resident" after the CTA's
// barrier.
template <Ring kRing, class Between>
__device__ __forceinline__ void ring_barrier(bool halo,
                                             const Between& between) {
  __syncthreads();
  if constexpr (kRing == Ring::kCluster) {
    if (halo) cluster_fence();
    cluster_arrive_relaxed();
    between();
    cluster_wait();
  } else if constexpr (kRing == Ring::kResident) {
    between();
  }
}

// Routes "shared" (one CTA, all n+1 rows), "cluster" (CTA r of a cluster
// of C the rows [r R, min(n+1, (r+1) R)), R = `rows`) and "resident" (CTA
// g of a cooperative grid the rows [g R, ...), the halo through `link`):
// the fill of ys [n+m+1, n+1, W] (only the domain's cells written), the
// last three diagonals of the CTA's rows in its shared memory; kW = W, or 0
// for W at run time (then kStaged).  kStaged false needs `rows` <=
// blockDim.x.  The tables skewed, as above.
template <int kW, bool kStaged, Ring kRing>
__global__ void __launch_bounds__(kRing == Ring::kShared ? kTripletMaxThreads
                                                         : kClusterMaxThreads)
    triplet_fill_ring(int32_t* ys, const int32_t* __restrict__ mu1,
                      const int32_t* __restrict__ mu2, int n, int m, int S,
                      int32_t two_gamma, int32_t gamma_delta, int rows,
                      ResidentLink link) {
  static_assert(kStaged || kW > 0, "registers hold compiled widths only");
  constexpr bool kCluster = kRing == Ring::kCluster;
  constexpr bool kResident = kRing == Ring::kResident;
  extern __shared__ int32_t smem[];
  const int W = kW > 0 ? kW : 2 * S + 1;
  const int P = n + 1;
  // this CTA's rows [first, end), at local rows i - first + kHalo of the
  // ring; local row 0 of a CTA of routes "cluster" and "resident" is its
  // halo, the last row of the CTA before it (none for the first)
  constexpr int kHalo = kRing == Ring::kShared ? 0 : 1;
  int rank = 0;
  if constexpr (kCluster)
    rank = cooperative_groups::this_cluster().block_rank();
  if constexpr (kResident) rank = static_cast<int>(blockIdx.x);
  const int first = min(P, rank * rows), end = min(P, first + rows);
  // a CTA of route "resident" without rows meets no other CTA: it leaves
  if (kResident && first >= end) return;
  const int slab = (rows + kHalo) * W;
  const int T = blockDim.x, t = threadIdx.x;
  int32_t* ring = smem;                     // [3][rows + kHalo][W]: d % 3
  int32_t* m2s = ring + 3 * slab;           // [W+1][rows]: kappa % (W+1)
  int32_t* m1s = m2s + (W + 1) * rows;      // [2][rows]: d % 2
  // (then, on route "resident", the halo's staging rows [2][W])
  // the ring of the CTA after this one, whose halo this CTA's last row is
  int32_t* next = nullptr;
  if constexpr (kCluster)
    if (end < P)
      next = cooperative_groups::this_cluster().map_shared_rank(ring,
                                                                rank + 1);
  // The flush's threads (routes "cluster" and "resident"): with a row a
  // thread, the whole warps after the rows' where the host gave some,
  // else every thread (see `flush`).
  const int row_threads = kStaged ? T : (rows + 31) / 32 * 32;
  const int f0 = T - row_threads >= 32 ? row_threads : 0;
  // Route "resident": this CTA's block of the halo memory, where its last
  // row goes, and the block of the CTA above, which its first row reads;
  // the threads that publish the one and copy the other (see the head of
  // the file).
  const long long block = static_cast<long long>(n + m + 1) * W;
  int32_t* halo_out = kResident && end < P ? link.halo + rank * block
                                           : nullptr;
  const int copier_t = f0 > 0 ? T - 1 : 0;
  const bool copier = kResident && t == copier_t;
  const bool publisher =
      kResident && t == (f0 > 0 && T - f0 >= 64 ? T - 33 : copier_t);
  const int32_t* halo_in =
      copier && first > 0 ? link.halo + (rank - 1) * block : nullptr;
  int32_t* hbuf = kStaged ? m1s + 2 * rows : ring + 3 * slab;  // [2][W]
  // The diagonals the CTA walks: on routes "shared" and "cluster" all of
  // them (every thread meets every barrier), on route "resident" those on
  // which a row of its own is live.
  const int d_first = kResident ? first : 0;
  const int d_last = kResident ? min(n + m, end - 1 + m) : n + m;

  int r0 = 0, r1 = 2, r2 = 1;               // slots of d, d-1, d-2
  // Route "resident", thread `copier`: the flag of the CTA above as last
  // read (`seen` > e: its halo of diagonal e is in memory), and the
  // diagonal whose halo is on its way into hbuf[e % 2] (cp.async), or -1.
  int seen = 0, staged_e = -1;
  const auto stage = [&](int e) {
    const int32_t* from = halo_in + static_cast<long long>(e) * W;
    int32_t* to = hbuf + (e & 1) * W;
    for (int x = 0; x < W; ++x)
      __pipeline_memcpy_async(to + x, from + x, sizeof(int32_t));
    __pipeline_commit();
  };
  // The halo of diagonal e into local row 0 of ring slot `slot`, which the
  // first row reads in diagonals e+1 and e+2, once the flag shows it; then
  // that of e+1 on its way, if the flag already shows it too.
  const auto pull = [&](int e, int slot) {
    if (staged_e != e) {
      if (seen <= e)
        seen = flag_wait(link.flags + rank - 1, e + 1, false, link.fault,
                         e + 1, 1);
      stage(e);
    }
    __pipeline_wait_prior(0);
    for (int x = 0; x < W; ++x)
      ring[slot * slab + x] = hbuf[(e & 1) * W + x];
    staged_e = -1;
    if (e + 2 <= first + m) {               // e+1's, read from e+2 on
      if (seen <= e + 1) seen = flag_acquire(link.flags + rank - 1, false);
      if (seen > e + 1) {
        stage(e + 1);
        staged_e = e + 1;
      }
    }
  };

  // One diagonal: each of this thread's live rows, its W values from the
  // ring's diagonals d-1 and d-2 and the tables' values `m1` and
  // `m2_at(sk)` (of the row i), to the ring and on route "shared" to ys,
  // and the CTA's last row also to the next CTA's halo.
  // (`inside`: every live row of this thread's warp lies inside)
  auto diagonal_rows = [&](int d, int i, const auto& m1_of,
                           const auto& m2_of, bool inside) {
    const int at = (i - first + kHalo) * W;
    int32_t* here = ring + r0 * slab + at;
    int32_t* out = kRing == Ring::kShared
                       ? ys + (static_cast<long long>(d) * P + i) * W
                       : nullptr;
    int32_t* halo = nullptr;
    if (i == end - 1) {
      if constexpr (kCluster)
        if (next != nullptr) halo = next + r0 * slab;
      if constexpr (kResident)
        if (halo_out != nullptr)
          halo = halo_out + static_cast<long long>(d) * W;
    }
    const int32_t* a = ring + r1 * slab + at;      // d-1, row i
    const int up = i >= 1 ? W : 0;
    const int32_t* b = a - up;                     // d-1, row i-1
    const int32_t* c = ring + r2 * slab + at - up;  // d-2, row i-1
    const auto m2_at = [&](int sk) { return m2_of(i, sk); };
    if constexpr (kW > 0) {
      if (inside) {
        row_inside<kW>(here, out, halo, a, b, c, m1_of(i), m2_at, two_gamma,
                       gamma_delta);
        return;
      }
    }
    row_values<kW>(here, out, halo, a, b, c, m1_of(i), m2_at, d, i, d - i,
                   m, S, two_gamma, gamma_delta);
  };
  // Routes "cluster" and "resident": the CTA's live rows of diagonal e
  // (e >= 0), from the ring's slot `slot` to ys: the rows lie side by side
  // in both, so neighbouring threads store neighbouring cells (a row's W
  // values from its thread are W stores a lane, each to a sector of its
  // own).  Only the cells of the domain.  With a row a thread, the whole
  // warps after the rows' (the host gives a warp for ~1024 cells where they
  // fit) flush, and the rows' warps do not: the last warp to arrive at a
  // barrier, an edge's, would otherwise take its share after it; else
  // every thread flushes.
  auto flush = [&](int e, int slot) {
    const int lo = max(first, e - m), hi = min(end - 1, e);
    const int32_t* from = ring + slot * slab + (lo - first + kHalo) * W;
    int32_t* to = ys + (static_cast<long long>(e) * P + lo) * W;
    if (t < f0) return;
#pragma unroll 4
    for (int x = t - f0; x < (hi - lo + 1) * W; x += T - f0) {
      const int sk = x % W, k = e - lo - x / W + sk - S;
      if (k >= 0 && k <= m) to[x] = from[x];
    }
  };
  // The barrier that ends diagonal d; on routes "cluster" and "resident"
  // after it (on "cluster" between its halves) the flush of diagonal d-1
  // (complete since the barrier that ended d-1, overwritten in d+2), which
  // so waits for no barrier.  Every thread of a CTA meets the same
  // barriers, live rows or not (on route "cluster" every thread of every
  // CTA n+m+2, one before diagonal 0); after the last, the flush of the
  // last diagonal.  On route "resident" thread `publisher` first publishes
  // d's halo, where the CTA's last row is live on d: the barrier orders
  // that row's stores before the release.
  auto end_diagonal = [&](int d) {
    // whether the CTA's last row is live on d, and this thread stored it as
    // the next CTA's halo
    const bool live = d >= end - 1 && d - (end - 1) <= m;
    const bool halo = live && next != nullptr &&
                      t == (end - 1 - first) % T;
    ring_barrier<kRing>(halo, [&] {
      if constexpr (kResident)
        if (publisher && live && halo_out != nullptr)
          flag_release(link.flags + rank, d + 1, false);
      if (d >= 1) flush(d - 1, r1);
    });
    const int r = r2;
    r2 = r1;
    r1 = r0;
    r0 = r;
  };

  if constexpr (kStaged) {
    // The tables' anti-diagonals: diagonal d reads mu2's kappa = d-S ..
    // d+S and mu1's kappa = d, staged a diagonal ahead.
    for (int kappa = max(0, d_first - S); kappa <= d_first + S; ++kappa)
      stage_antidiagonal(m2s + kappa % (W + 1) * rows, mu2, kappa, n, m,
                         first, end);
    stage_antidiagonal(m1s + d_first % 2 * rows, mu1, d_first, n, m, first,
                       end);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    if (halo_in != nullptr) pull(d_first - 1, r1);
    ring_barrier<kRing>(false, [] {});
    for (int d = d_first; d <= d_last; ++d) {
      stage_antidiagonal(m2s + (d + 1 + S) % (W + 1) * rows, mu2, d + 1 + S,
                         n, m, first, end);
      stage_antidiagonal(m1s + (d + 1) % 2 * rows, mu1, d + 1, n, m, first,
                         end);
      __pipeline_commit();
      const int lo = max(first, d - m), hi = min(end - 1, d);
      const int32_t* m1d = m1s + d % 2 * rows;
      const int kslot = (d - S + S * (W + 1)) % (W + 1);   // kappa = d - S
      // the first live row whose local row is t (mod T)
      for (int i = lo + (t + T - (lo - first) % T) % T; i <= hi; i += T)
        diagonal_rows(
            d, i, [&](int row) { return m1d[row - first]; },
            [&](int row, int sk) {
              const int s = kslot + sk;
              return m2s[(s >= W + 1 ? s - (W + 1) : s) * rows + row - first];
            },
            false);
      // route "resident": the halo of d, for diagonal d+1
      if (halo_in != nullptr && d + 1 <= first + m) pull(d, r0);
      __pipeline_wait_prior(0);
      end_diagonal(d);
    }
  } else {
    // Row i = first + t in registers: mu1[i, d-i] and a window of mu2[i,
    // d-i-S .. d-i+S] on diagonal d, from rows of the skewed tables four
    // at a time: on the diagonals d = d_first + 4g .. + 3 of group g, mu1's
    // rows d and mu2's rows d+1+S (the value the window takes after
    // diagonal d).  Even groups read (qa1, qa2) and load (qb1, qb2) for the
    // next group, odd ones the other way round; the four steps of a group
    // name their registers, so nothing selects among them at run time.
    const int i = first + t;
    const bool mine = i < end;
    int32_t w2[kW];
    int4 qa1{}, qa2{}, qb1{}, qb2{};
    if (mine) {     // diagonal d_first: mu2[i, d_first-i-S .. d_first-i+S],
                    // skewed rows e = d_first-S .. d_first+S (e < 0 unused)
#pragma unroll
      for (int sk = 0; sk < kW; ++sk) {
        const int e = d_first + sk - S;
        w2[sk] = e < 0 ? 0 : mu2[static_cast<long long>(e) * P + i];
      }
      qa1 = skewed_quad(mu1, d_first, P, i);
      qa2 = skewed_quad(mu2, d_first + 1 + S, P, i);
    }
    if (halo_in != nullptr) pull(d_first - 1, r1);
    ring_barrier<kRing>(false, [] {});
    int d = d_first;
    // diagonal d with mu1[i, d-i] = m1; then the window takes v2
    const auto step = [&](int32_t m1, int32_t v2) {
      if (mine && d >= i && d - i <= m) {
        // this warp's live rows, all inside the domain or not (the same
        // answer on every lane: no divergence)
        const int w0 = first + (t & ~31);
        const bool inside =
            max(max(0, d - m), w0) >= max(1, d - m + S) &&
            min(min(min(n, d), w0 + 31), end - 1) <= d - S - 1;
        diagonal_rows(
            d, i, [&](int) { return m1; },
            [&](int, int sk) { return w2[sk]; }, inside);
      }
      // route "resident": the halo of d, for diagonal d+1
      if constexpr (kResident)
        if (halo_in != nullptr && d + 1 <= first + m) pull(d, r0);
#pragma unroll
      for (int sk = 0; sk + 1 < kW; ++sk) w2[sk] = w2[sk + 1];
      w2[kW - 1] = v2;
      end_diagonal(d);
      return ++d <= d_last;
    };
    const auto group = [&](const int4& use1, const int4& use2, int4& next1,
                           int4& next2) {
      // the next group, if the window is still to meet row i's diagonals
      const int e = d + 4;
      if (mine && e + 3 >= i - kW - 1 && e <= i + m) {
        next1 = skewed_quad(mu1, e, P, i);
        next2 = skewed_quad(mu2, e + 1 + S, P, i);
      }
      if constexpr (kW <= kInlinedStepsW) {
        return step(use1.x, use2.x) && step(use1.y, use2.y) &&
               step(use1.z, use2.z) && step(use1.w, use2.w);
      } else {
        // the group's four steps from one call site, each taking its
        // values of registers loaded a group before (none in flight)
#pragma unroll 1
        for (int s = 0; s < 4; ++s)
          if (!step(s == 0 ? use1.x : s == 1 ? use1.y : s == 2 ? use1.z
                                                       : use1.w,
                    s == 0 ? use2.x : s == 1 ? use2.y : s == 2 ? use2.z
                                                       : use2.w))
            return false;
        return true;
      }
    };
    while (group(qa1, qa2, qb1, qb2) && group(qb1, qb2, qa1, qa2)) {
    }
  }
  if constexpr (kRing != Ring::kShared) flush(d_last, r1);
}

// Shared-memory opt-in of a ring kernel with `bytes` of dynamic shared
// memory, and on route "cluster" the non-portable sizes' above 8 CTAs.
template <class Kernel>
cudaError_t ring_ready(Kernel kernel, size_t bytes, bool non_portable) {
  cudaError_t err = cudaSuccess;
  if (bytes > kTripletSharedDefault)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess && non_portable)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// One launch of route "shared" (cluster 1) or of one cluster of `cluster`
// CTAs (route "cluster"), `rows` rows a CTA, `bytes` of dynamic shared
// memory each.  A cluster that the card cannot make resident is refused
// before the launch: cudaErrorLaunchOutOfResources.  Route "resident":
// one cooperative launch of `cluster` CTAs; a grid that the card cannot
// hold at once is refused (cudaErrorCooperativeLaunchTooLarge), and the
// refusal is not left behind as the runtime's last error.
template <int kW, bool kStaged, Ring kRing>
cudaError_t launch_ring(int32_t* ys, const int32_t* mu1, const int32_t* mu2,
                        int n, int m, int S, int32_t two_gamma,
                        int32_t gamma_delta, int threads, int cluster,
                        int rows, size_t bytes, ResidentLink link,
                        cudaStream_t st) {
  const auto kernel = triplet_fill_ring<kW, kStaged, kRing>;
  cudaError_t err = ring_ready(
      kernel, bytes, kRing == Ring::kCluster && cluster > kClusterPortable);
  if (err != cudaSuccess) return err;
  if constexpr (kRing == Ring::kResident) {
    void* params[] = {&ys, &mu1, &mu2, &n, &m, &S, &two_gamma,
                      &gamma_delta, &rows, &link};
    err = cudaLaunchCooperativeKernel(kernel, dim3(cluster), dim3(threads),
                                      params, bytes, st);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = st;
  cudaLaunchAttribute attr = {};
  if constexpr (kRing == Ring::kCluster) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(
        &resident, reinterpret_cast<const void*>(kernel), &config);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&config, kernel, ys, mu1, mu2, n, m, S, two_gamma,
                           gamma_delta, rows, link);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The three ring routes behind one switch over the compiled widths.
template <Ring kRing>
int fill_ring(int32_t* ys, const int32_t* mu1, const int32_t* mu2, int n,
              int m, int S, int two_gamma, int gamma_delta, int threads,
              int cluster, int rows, ResidentLink link, int device,
              void* stream) {
  const bool staged = triplet_staged(rows, S, threads);
  // on route "resident" also the halo's two staging rows [2, W]
  const size_t bytes =
      triplet_ring_bytes(rows, kRing == Ring::kShared ? 0 : 1, S, staged) +
      (kRing == Ring::kResident ? 2 * (2 * S + 1) * sizeof(int32_t) : 0);
  if (bytes > kTripletSharedLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  BIALIGN_TRY(cudaSetDevice(device));
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (S) {
#define BIALIGN_TRIPLET_CASE(s)                                              \
  case s:                                                                    \
    err = staged ? launch_ring<2 * s + 1, true, kRing>(                      \
                       ys, mu1, mu2, n, m, S, two_gamma, gamma_delta,        \
                       threads, cluster, rows, bytes, link, st)              \
                 : launch_ring<2 * s + 1, false, kRing>(                     \
                       ys, mu1, mu2, n, m, S, two_gamma, gamma_delta,        \
                       threads, cluster, rows, bytes, link, st);             \
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
      err = launch_ring<0, true, kRing>(ys, mu1, mu2, n, m, S, two_gamma,
                                        gamma_delta, threads, cluster, rows,
                                        bytes, link, st);
  }
  return static_cast<int>(err);
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
// such a pair to "cluster" or "resident").
extern "C" int bialign_triplet_fill_shared(int32_t* ys, const int32_t* mu1,
                                           const int32_t* mu2, int n, int m,
                                           int S, int two_gamma,
                                           int gamma_delta, int threads,
                                           int device, void* stream) {
  using namespace bialign;
  if (n < 0 || m < 0 || S < 0 || threads < 1 ||
      threads > kTripletMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_ring<Ring::kShared>(ys, mu1, mu2, n, m, S, two_gamma,
                                  gamma_delta, threads, 1, n + 1,
                                  ResidentLink{}, device, stream);
}

// Route "cluster": the same fill and arguments as route "shared", and the
// cluster's CTAs `cluster` (1-16), each of `threads` threads (1-512) and
// ceil((n+1) / cluster) rows.  Returns cudaErrorInvalidValue, before any
// launch, for a CTA beyond its 227 KB of shared memory, and the card's
// error, or cudaErrorLaunchOutOfResources, when no such cluster can be
// resident (above 8 CTAs the card may have no GPC with enough free SMs);
// it never falls back to another route.
extern "C" int bialign_triplet_fill_cluster(int32_t* ys, const int32_t* mu1,
                                            const int32_t* mu2, int n, int m,
                                            int S, int two_gamma,
                                            int gamma_delta, int threads,
                                            int cluster, int device,
                                            void* stream) {
  using namespace bialign;
  if (n < 0 || m < 0 || S < 0 || threads < 1 ||
      threads > kClusterMaxThreads || cluster < 1 || cluster > kClusterMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (n + cluster) / cluster;       // ceil((n+1) / cluster)
  return fill_ring<Ring::kCluster>(ys, mu1, mu2, n, m, S, two_gamma,
                                   gamma_delta, threads, cluster, rows,
                                   ResidentLink{}, device, stream);
}

// Route "resident": the same fill and arguments as route "shared", one
// cooperative launch of `ctas` CTAs (>= 1), each of `threads` threads
// (1-512) and ceil((n+1) / ctas) rows (CTAs beyond n+1 rows have none and
// leave at once); `halo` [ctas-1, n+m+1, 2S+1] int32 (any contents) and
// `flags` [ctas] int32, zeroed on `stream` before the call, in device
// memory; `fault` the fault word, int32 [4] of pinned host memory, or
// null.  Returns cudaErrorInvalidValue, before any launch, for a CTA beyond
// its 227 KB of shared memory, and cudaErrorCooperativeLaunchTooLarge when
// the card cannot hold the grid at once (then nothing ran, and the error is
// not left behind); it never falls back to another route.
extern "C" int bialign_triplet_fill_resident(
    int32_t* ys, const int32_t* mu1, const int32_t* mu2, int n, int m, int S,
    int two_gamma, int gamma_delta, int threads, int ctas, int32_t* halo,
    int32_t* flags, int32_t* fault, int device, void* stream) {
  using namespace bialign;
  if (n < 0 || m < 0 || S < 0 || threads < 1 ||
      threads > kClusterMaxThreads || ctas < 1 || flags == nullptr ||
      (ctas > 1 && halo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (n + ctas) / ctas;             // ceil((n+1) / ctas)
  ResidentLink link{halo, flags, nullptr};
  if (fault != nullptr) {
    void* mapped = nullptr;
    BIALIGN_TRY(cudaHostGetDevicePointer(&mapped, fault, 0));
    link.fault = static_cast<int32_t*>(mapped);
  }
  return fill_ring<Ring::kResident>(ys, mu1, mu2, n, m, S, two_gamma,
                                    gamma_delta, threads, ctas, rows, link,
                                    device, stream);
}
