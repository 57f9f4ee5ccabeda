// The sequence split: one pair's lattice rows in K contiguous shards (on
// one card or several), the tile kernel of csrc/tile_diag.cuh in its
// row-shard form.  Three entry points, each affine and non-affine, each on
// two routes:
//   * the score-only ring fill (K1/K2 score-only mode, split);
//   * the checkpointed fill (K9/K11, split);
//   * the fill of one block into a window from its checkpoint (K10/K12,
//     split).
// Route "streams" (bialign_seqsplit_*): a host loop over the diagonals and
// the shards, a launch a shard and diagonal on the shard's stream, the
// halo copied between events.  Route "resident"
// (bialign_seqsplit_resident_*): one cooperative launch a card for the
// whole diagonal range, each CTA its own rows, progress flags between
// neighbouring CTAs (below).
//
// Replaces, in bialign_tpu/parallel/seqsplit.py: `_make_shard_step` (the
// halo step, run there by `lax.scan` under `shard_map` on the XLA step of
// xla_dp) as `score_seqsplit`, `_ckpt_fill_fn` and `_block_remat_fn` use it.
//
// Layout.  Shard k owns rows a_k..b_k (a_0 = 0, a_{k+1} = b_k + 1, b_last
// = n).  Its slabs have lines of P_k = b_k - a_k + 2 rows: slot 0 is the
// halo, row a_k - 1, then its own rows; the tile kernel addresses row i at
// i - row0, row0 = a_k - 1 (shard 0's halo, row -1, is never read).  Its
// ring is [3, (9,) W, W, P_k], its checkpoints [NB, 2, (9,) W, W, P_k], its
// window [C+2, (9,) W, W, P_k].  The tables are whole on every shard's
// device and read by absolute row.
//
// The one dependency across shards: a value of row i reads row i-1 of
// diagonals d-1 and d-2.  So after shard k writes diagonal d, its row b_k
// of slab d goes to slot 0 of shard k+1's slab d, `cells` values P_k apart
// to `cells` values P_{k+1} apart, where row b_k lies on diagonal d (else
// nothing reads it).  Shard k+1's diagonal d+1 then finds it in place, and
// so does its d+2.  Checkpoints and windows hold the halo too: the slabs
// saved before diagonal b*C carry slot 0 as the halo left it, which is what
// the block fill needs for its first two diagonals.
//
// Route "streams".  The halo is one cudaMemcpy2DAsync (a peer copy between
// two cards), issued on the receiving shard's stream after an event that
// marks shard k's diagonal d.  Write after read on a ring: shard k+1's copy
// of diagonal d reads slab d % 3 of shard k, which shard k's diagonal d+3
// overwrites; so before that diagonal, shard k's stream waits for an event
// that marks the copy.  On the receiving side the copy overwrites slot 0 of
// slab d % 3, which shard k+1's diagonal d-1 read (as d-3 = d-1-2): that
// diagonal is on the same stream, before the copy.  A window is written
// once a diagonal a block: no such wait.  The caller orders the shards'
// streams against its own (bialign_tpu_torch/parallel/seqsplit.py: each
// shard's stream waits for its device's current stream first, and that
// stream waits for it after).  What bounds it: the host, which issues K
// launches, K event records and waits and a copy a boundary for every
// diagonal from one thread (PERF.md).
//
// Route "resident".  One launch a card (cudaLaunchCooperativeKernel, so
// that every CTA is resident at once; a grid the card cannot hold is
// refused, cudaErrorCooperativeLaunchTooLarge, and not cut down), on the
// card's stream of the caller.  Its grid covers the rows of every shard on
// that card: CTA j of shard k owns rows a_k + j*rows .. (one or more tiles
// of Tile::rows(S) rows; `rows` a field of the table, 0 for the fewest
// whole tiles that keep the card's grid resident) and walks the diagonals
// itself, each diagonal's live rows of its range by `fill_tile`, tile by
// tile.  CTA order across shards is row order: the CTA above CTA 0 of
// shard k is the last of shard k-1, possibly on another card.  Each CTA
// publishes its progress, p = d - d_first + 2 after diagonal d (1 before
// the first), in an int32 of device memory that the caller zeroes, and
// before diagonal d waits for two neighbours only:
//   * above >= d-1: its staged rows reach one row up, row r0-1 of
//     diagonals d-1 and d-2, which the CTA above writes;
//   * below >= d-1 (rings only): diagonal d goes to slab d % 3 over
//     diagonal d-3, whose row r1 the CTA below reads for its diagonals d-2
//     and d-1 (as their d-1 and d-2).  So the ring stays at three slabs,
//     as the twins' (ops/cuda_dp.RING): the below-wait is the price of the
//     third slab's reuse; a window is written once a diagonal and needs
//     only the first wait.
// No grid barrier.  The halo is a pull: CTA 0 of shard k+1, after its
// above-wait and before it fills diagonal d, copies row b_k of diagonal d-1
// from shard k's slab into its own slot 0 (a load through peer memory
// between cards, the flags then at system scope), where row b_k lies on
// d-1; one step past the last diagonal it pulls that diagonal's halo, so
// slot 0 holds what the twin's does in every slab.  A checkpoint is saved
// after the pull and before the fill of diagonal b*C, each CTA its own rows
// (CTA 0 of a shard also slot 0); a window's first two slabs are copied
// from the checkpoint the same way before the first publish.  Every wait is
// bounded (csrc/neighbour_flags.cuh): a flag that never comes traps.
// What bounds it: a diagonal's chain, the neighbour's handoff through the
// L2 and one tile's stage, compute and store (PERF.md).
#include <algorithm>
#include <cstdint>

#include "ckpt_diag.cuh"
#include <neighbour_flags.cuh>

namespace bialign {
namespace {

// The int64 fields of a shard's row in the host's table.
enum ShardField {
  kSlabs = 0,  // ring or window
  kMu1,
  kMu2,
  kExtra,      // checkpoints [NB, 2, ...] or a checkpoint [2, ...]; or 0
  kFirst,      // a_k
  kLast,       // b_k
  kDevice,
  kStream,     // "streams": the shard's; "resident": its card's
  kFlags,      // "resident": an int32 a row of the shard, zeroed; else 0
  kRows,       // "resident": rows a CTA, 0 for the default
  kFault,      // "resident": the fault word, int32 [4] of pinned host memory
  kShardFields
};

constexpr int kMaxShards = 64;

struct Shard {
  int32_t* slabs;
  const int32_t* mu1;
  const int32_t* mu2;
  int32_t* extra;
  int a, b, device;
  cudaStream_t st;
  cudaEvent_t wrote = nullptr;          // its last diagonal written
  cudaEvent_t copied[RING] = {};        // its halo of diagonal d copied in,
                                        // d % 3
  int rows() const { return b - a + 2; }
};

// The shards of a call, their events, and the caller's device, which the
// destructor makes current again.
struct Shards {
  Shard s[kMaxShards];
  int K = 0, caller = 0;
  ~Shards() {
    for (int k = 0; k < K; ++k) {
      cudaSetDevice(s[k].device);
      if (s[k].wrote) cudaEventDestroy(s[k].wrote);
      for (cudaEvent_t e : s[k].copied)
        if (e) cudaEventDestroy(e);
    }
    cudaSetDevice(caller);
  }
};

// Diagonal d's slab of a shard whose slab 0 is `base` (a ring's or a
// window's moved back), `slab` values a slab.
template <bool kRing>
int32_t* slab_at(int32_t* base, size_t slab, int d) {
  return reinterpret_cast<int32_t*>(
      reinterpret_cast<intptr_t>(base) +
      static_cast<intptr_t>(kRing ? d % RING : d) *
          static_cast<intptr_t>(slab) *
          static_cast<intptr_t>(sizeof(int32_t)));
}

// Diagonals d_first..d_last over the K shards of `table` (host memory, K x
// kShardFields int64).  kRing: on rings, saving checkpoints before every
// diagonal b*C when C > 0 (kExtra: [NB, 2, ...]); else into windows whose
// slab x is diagonal d_first - 2 + x, slabs 0 and 1 copied from the
// checkpoint kExtra [2, ...] first unless d_first is 0.
template <class Tile, bool kRing>
int run_shards(const int64_t* table, int K, const int32_t* consts, int n,
               int m, int S, int d_first, int d_last, int C) {
  if (K < 1 || K > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  Shards sh;
  BIALIGN_TRY(cudaGetDevice(&sh.caller));
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const int W = 2 * S + 1;
  const int cells = Tile::kStates * W * W;
  int32_t* base[kMaxShards];
  for (int k = 0; k < K; ++k) {
    const int64_t* f = table + k * kShardFields;
    Shard& s = sh.s[k];
    s.slabs = reinterpret_cast<int32_t*>(f[kSlabs]);
    s.mu1 = reinterpret_cast<const int32_t*>(f[kMu1]);
    s.mu2 = reinterpret_cast<const int32_t*>(f[kMu2]);
    s.extra = reinterpret_cast<int32_t*>(f[kExtra]);
    s.a = static_cast<int>(f[kFirst]);
    s.b = static_cast<int>(f[kLast]);
    s.device = static_cast<int>(f[kDevice]);
    s.st = reinterpret_cast<cudaStream_t>(f[kStream]);
    const int a_want = k == 0 ? 0 : sh.s[k - 1].b + 1;
    if (s.a != a_want || s.b < s.a || (k == K - 1 && s.b != n))
      return static_cast<int>(cudaErrorInvalidValue);
    sh.K = k + 1;
    BIALIGN_TRY(cudaSetDevice(s.device));
    BIALIGN_TRY(cudaEventCreateWithFlags(&s.wrote, cudaEventDisableTiming));
    for (cudaEvent_t& e : s.copied)
      BIALIGN_TRY(cudaEventCreateWithFlags(&e, cudaEventDisableTiming));
    const size_t slab = static_cast<size_t>(cells) * s.rows();
    base[k] = kRing ? s.slabs : window_base(s.slabs, slab, d_first);
    if (!kRing && d_first > 0) {
      BIALIGN_TRY(copy_slab(s.slabs, s.extra + slab, slab, s.st));
      BIALIGN_TRY(copy_slab(s.slabs + slab, s.extra, slab, s.st));
    }
  }
  for (int d = d_first; d <= d_last; ++d) {
    for (int k = 0; k < K; ++k) {
      const Shard& s = sh.s[k];
      const size_t slab = static_cast<size_t>(cells) * s.rows();
      BIALIGN_TRY(cudaSetDevice(s.device));
      // the next shard has copied its halo out of the slab d overwrites
      if (kRing && k + 1 < K && d >= RING)
        BIALIGN_TRY(cudaStreamWaitEvent(s.st, sh.s[k + 1].copied[d % RING],
                                        0));
      if (kRing && C > 0 && d > 0 && d % C == 0) {
        int32_t* ck = s.extra + static_cast<size_t>(d / C) * 2 * slab;
        BIALIGN_TRY(copy_slab(ck, slab_at<true>(s.slabs, slab, d - 1), slab,
                              s.st));
        BIALIGN_TRY(copy_slab(ck + slab,
                              slab_at<true>(s.slabs, slab, d - 2 + RING),
                              slab, s.st));
      }
      const int lo = std::max(std::max(0, d - m), s.a);
      const int hi = std::min(std::min(n, d), s.b);
      if (lo > hi) continue;
      BIALIGN_TRY((launch_rows<Tile, kRing>(base[k], s.mu1, s.mu2, cs, n, m,
                                            S, d, lo, hi, s.rows(), s.a - 1,
                                            s.st)));
      BIALIGN_TRY(cudaEventRecord(s.wrote, s.st));
    }
    for (int k = 1; k < K; ++k) {
      const Shard& from = sh.s[k - 1];
      const Shard& to = sh.s[k];
      if (from.b < d - m || from.b > d) continue;   // off diagonal d
      const size_t from_slab = static_cast<size_t>(cells) * from.rows();
      const size_t to_slab = static_cast<size_t>(cells) * to.rows();
      BIALIGN_TRY(cudaSetDevice(to.device));
      BIALIGN_TRY(cudaStreamWaitEvent(to.st, from.wrote, 0));
      BIALIGN_TRY(cudaMemcpy2DAsync(
          slab_at<kRing>(base[k], to_slab, d), to.rows() * sizeof(int32_t),
          slab_at<kRing>(base[k - 1], from_slab, d) + from.rows() - 1,
          from.rows() * sizeof(int32_t), sizeof(int32_t), cells,
          cudaMemcpyDefault, to.st));
      if (kRing) BIALIGN_TRY(cudaEventRecord(to.copied[d % RING], to.st));
    }
  }
  return 0;
}

// -- route "resident" -------------------------------------------------------

constexpr int kMaxResident = 32;

// A shard as the resident kernel sees it, on its card or another.
struct ResidentShard {
  int32_t* slabs;          // a ring, or a window moved back (window_base)
  const int32_t* mu1;
  const int32_t* mu2;
  int32_t* extra;          // checkpoints [NB, 2, ...] or a checkpoint [2, ...]
  int32_t* flags;          // its CTAs' progress, on its card
  int a, b, rows, ctas;    // its rows, rows a CTA, CTAs
  int first;               // its first CTA in this launch; -1 on another card
  int sys_above, sys_below;  // the neighbouring shard on another card
};

struct ResidentArgs {
  ResidentShard sh[kMaxResident];
  int32_t* fault;
  int K, n, m, S, d_first, d_last, C;
};
static_assert(sizeof(ResidentArgs) + sizeof(AffineConsts) <= 4000,
              "a kernel's arguments hold at most 4 KB");

// Own rows (and slot 0 for a shard's CTA 0) of every cell: `to` <- `from`,
// two slabs of lines of P rows.
__device__ __forceinline__ void copy_rows(int32_t* to, const int32_t* from,
                                          int cells, int P, int lr0,
                                          int lr1, int threads) {
  const int width = lr1 - lr0 + 1;
  for (int x = threadIdx.x; x < cells * width; x += threads) {
    const int cell = x / width;
    const int at = cell * P + lr0 + (x - cell * width);
    to[at] = from[at];
  }
}

// Diagonals d_first..d_last of every shard on this card, a CTA its rows.
template <class Tile, int kS, bool kRing>
__global__ void __launch_bounds__(Tile::kThreads)
    resident_split(const __grid_constant__ ResidentArgs args,
                   const __grid_constant__ typename Tile::Consts cs) {
  extern __shared__ int32_t smem[];
  constexpr int R = Tile::rows(kS);
  const int bx = static_cast<int>(blockIdx.x);
  int k = 0;
  while (k + 1 < args.K &&
         !(args.sh[k].first >= 0 && bx >= args.sh[k].first &&
           bx < args.sh[k].first + args.sh[k].ctas))
    ++k;
  const ResidentShard& s = args.sh[k];
  const int n = args.n, m = args.m;
  const int S = kS >= 0 ? kS : args.S;
  const int cells = Tile::kStates * (2 * S + 1) * (2 * S + 1);
  const int P = s.b - s.a + 2, row0 = s.a - 1;
  const size_t slab = static_cast<size_t>(cells) * P;
  const int j = bx - s.first;
  const int r0 = s.a + j * s.rows, r1 = min(s.b, r0 + s.rows - 1);
  // its own rows in the line, with slot 0 for CTA 0
  const int lr0 = j == 0 ? 0 : r0 - row0, lr1 = r1 - row0;
  const ResidentShard* up = k > 0 ? &args.sh[k - 1] : nullptr;
  const ResidentShard* down = k + 1 < args.K ? &args.sh[k + 1] : nullptr;
  const int32_t* above = j > 0 ? s.flags + j - 1
                         : up ? up->flags + up->ctas - 1 : nullptr;
  const int32_t* below = j + 1 < s.ctas ? s.flags + j + 1
                         : down ? down->flags : nullptr;
  const bool sys_above = j == 0 && s.sys_above;
  const bool sys_below = j + 1 == s.ctas && s.sys_below;
  const bool pulls = j == 0 && up != nullptr;
  int32_t* mine = s.flags + j;
  const int base = args.d_first - 2;     // progress after diagonal d: d - base

  if (!kRing && args.d_first > 0) {      // slabs 0, 1 <- ck[1], ck[0]
    copy_rows(s.slabs + slab_of<false>(args.d_first - 2) * slab,
              s.extra + slab, cells, P, lr0, lr1, Tile::kThreads);
    copy_rows(s.slabs + slab_of<false>(args.d_first - 1) * slab, s.extra,
              cells, P, lr0, lr1, Tile::kThreads);
  }
  __syncthreads();
  if (threadIdx.x == 0) flag_release(mine, 1, sys_above || sys_below);

  for (int d = args.d_first; d <= args.d_last + 1; ++d) {
    const bool tail = d > args.d_last;   // the last diagonal's halo only
    if (tail && !pulls) break;
    if (threadIdx.x == 0) {
      if (above)
        flag_wait(above, d - 1 - base, sys_above, args.fault, d, 1);
      if (kRing && !tail && below)
        flag_wait(below, d - 1 - base, sys_below, args.fault, d, 2);
    }
    __syncthreads();
    const int e = d - 1;                 // the halo of diagonal d-1
    if (pulls && e >= args.d_first && up->b >= e - m && up->b <= e) {
      const int Pu = up->b - up->a + 2;
      const int32_t* from =
          up->slabs + slab_of<kRing>(e) * (static_cast<size_t>(cells) * Pu) +
          Pu - 1;
      int32_t* to = s.slabs + slab_of<kRing>(e) * slab;
      for (int x = threadIdx.x; x < cells; x += Tile::kThreads)
        to[x * P] = from[x * Pu];
      __syncthreads();
    }
    if (tail) break;
    if (kRing && args.C > 0 && d > 0 && d % args.C == 0) {
      int32_t* ck = s.extra + static_cast<size_t>(d / args.C) * 2 * slab;
      copy_rows(ck, s.slabs + slab_of<true>(d - 1) * slab, cells, P, lr0,
                lr1, Tile::kThreads);
      copy_rows(ck + slab, s.slabs + slab_of<true>(d - 2) * slab, cells, P,
                lr0, lr1, Tile::kThreads);
    }
    const int lo = max(max(0, d - m), r0), hi = min(min(n, d), r1);
    for (int i0 = lo; i0 <= hi; i0 += R)
      fill_tile<Tile, kS, kRing>(smem, s.slabs, s.mu1, s.mu2, cs, n, m,
                                 m + 1, P, row0, S, d, i0,
                                 min(hi, i0 + R - 1));
    __syncthreads();
    if (threadIdx.x == 0)
      flag_release(mine, d - base, sys_above || sys_below);
  }
}

// CTAs of a shard of `own` rows at `rows` a CTA
inline int ctas_of(int own, int rows) { return (own + rows - 1) / rows; }

// Diagonals d_first..d_last over the K shards of `table` on route
// "resident", as run_shards takes them.  Returns 0 or the first CUDA error
// (cudaErrorPeerAccessUnsupported for neighbouring shards on cards that
// cannot reach each other, cudaErrorCooperativeLaunchTooLarge for a forced
// `rows` whose grid a card cannot hold).
template <class Tile, bool kRing>
int run_resident(const int64_t* table, int K, const int32_t* consts, int n,
                 int m, int S, int d_first, int d_last, int C) {
  if (K < 1 || K > kMaxResident)
    return static_cast<int>(cudaErrorInvalidValue);
  struct Caller {        // made current again on every return
    int device = 0;
    ~Caller() { cudaSetDevice(device); }
  } caller;
  BIALIGN_TRY(cudaGetDevice(&caller.device));
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const int cells = Tile::kStates * (2 * S + 1) * (2 * S + 1);
  ResidentArgs args = {};
  args.K = K;
  args.n = n;
  args.m = m;
  args.S = S;
  args.d_first = d_first;
  args.d_last = d_last;
  args.C = C;
  int device[kMaxResident];
  cudaStream_t stream[kMaxResident];
  size_t widest = 0;
  for (int k = 0; k < K; ++k) {
    const int64_t* f = table + k * kShardFields;
    ResidentShard& s = args.sh[k];
    s.a = static_cast<int>(f[kFirst]);
    s.b = static_cast<int>(f[kLast]);
    const int a_want = k == 0 ? 0 : args.sh[k - 1].b + 1;
    if (s.a != a_want || s.b < s.a || (k == K - 1 && s.b != n) ||
        f[kRows] < 0 || f[kFlags] == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t slab = static_cast<size_t>(cells) * (s.b - s.a + 2);
    widest = std::max(widest, slab);
    int32_t* slabs = reinterpret_cast<int32_t*>(f[kSlabs]);
    s.slabs = kRing ? slabs : window_base(slabs, slab, d_first);
    s.mu1 = reinterpret_cast<const int32_t*>(f[kMu1]);
    s.mu2 = reinterpret_cast<const int32_t*>(f[kMu2]);
    s.extra = reinterpret_cast<int32_t*>(f[kExtra]);
    s.flags = reinterpret_cast<int32_t*>(f[kFlags]);
    s.rows = static_cast<int>(f[kRows]);
    device[k] = static_cast<int>(f[kDevice]);
    stream[k] = reinterpret_cast<cudaStream_t>(f[kStream]);
  }
  if (table[kFault] != 0) {
    void* mapped = nullptr;
    BIALIGN_TRY(cudaHostGetDevicePointer(
        &mapped, reinterpret_cast<void*>(table[kFault]), 0));
    args.fault = static_cast<int32_t*>(mapped);
  }
  // neighbouring shards on two cards: peer access both ways
  for (int k = 1; k < K; ++k) {
    if (device[k] == device[k - 1]) continue;
    args.sh[k].sys_above = args.sh[k - 1].sys_below = 1;
    for (int x = 0; x < 2; ++x) {
      const int from = device[k - x], to = device[k - 1 + x];
      int can = 0;
      BIALIGN_TRY(cudaDeviceCanAccessPeer(&can, from, to));
      if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
      BIALIGN_TRY(cudaSetDevice(from));
      const cudaError_t err = cudaDeviceEnablePeerAccess(to, 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled)
        cudaGetLastError();
      else if (err != cudaSuccess)
        return static_cast<int>(err);
    }
  }
  return with_shift(S, [&](auto shift) -> int {
    const auto kernel = resident_split<Tile, decltype(shift)::value, kRing>;
    const TileGeometry g = tile_geometry<Tile>(S);
    const auto own = [&](int x) { return args.sh[x].b - args.sh[x].a + 1; };
    // each card's default rows a CTA: the fewest whole tiles that keep its
    // grid within what the card holds at once
    bool seen[kMaxResident] = {};
    for (int k = 0; k < K; ++k) {
      if (seen[k]) continue;
      const int dev = device[k];
      BIALIGN_TRY(cudaSetDevice(dev));
      BIALIGN_TRY(tile_ready(kernel, g, widest));
      int per_sm = 0, sms = 0;
      BIALIGN_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, g.threads, g.bytes));
      BIALIGN_TRY(
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
      int rows = g.rows;
      for (;;) {
        int grid = 0;
        for (int x = k; x < K; ++x)
          if (device[x] == dev)
            grid += ctas_of(own(x), args.sh[x].rows ? args.sh[x].rows : rows);
        if (grid <= per_sm * sms || rows > n) break;
        rows += g.rows;
      }
      for (int x = k; x < K; ++x) {
        if (device[x] != dev) continue;
        seen[x] = true;
        if (args.sh[x].rows == 0) args.sh[x].rows = rows;
        args.sh[x].ctas = ctas_of(own(x), args.sh[x].rows);
      }
    }
    // one launch a card, its shards' CTAs in row order
    for (int k = 0; k < K; ++k) seen[k] = false;
    for (int k = 0; k < K; ++k) {
      if (seen[k]) continue;
      int grid = 0;
      for (int x = 0; x < K; ++x) {
        const bool here = device[x] == device[k];
        args.sh[x].first = here ? grid : -1;
        if (here) {
          grid += args.sh[x].ctas;
          seen[x] = true;
        }
      }
      BIALIGN_TRY(cudaSetDevice(device[k]));
      void* params[] = {&args, const_cast<typename Tile::Consts*>(&cs)};
      const cudaError_t err = cudaLaunchCooperativeKernel(
          kernel, dim3(grid), dim3(g.threads), params, g.bytes, stream[k]);
      if (err != cudaSuccess) {
        // the refusal is returned here, not left as the runtime's last
        // error for another launcher's cudaGetLastError() to report
        cudaGetLastError();
        return static_cast<int>(err);
      }
    }
    return 0;
  });
}

}  // namespace
}  // namespace bialign

// Score-only ring fill of one pair over K shards, route "streams":
// `shards`, K x 11 int64 in host memory, a row a shard (ring [3, 9, W, W,
// P_k] with any contents, mu1, mu2 on its device, 0, a_k, b_k, device,
// stream, then 0, 0, 0).  The last diagonal
// is left in slab (n+m) % 3 of each ring; the score is read from the last
// shard's, which owns row n.  `consts`: the int32 [9, 15] case constants in
// host memory.  Returns 0, or the first CUDA error.
extern "C" int bialign_seqsplit_score_affine(const int64_t* shards, int K,
                                             const int32_t* consts, int n,
                                             int m, int S) {
  return bialign::run_shards<bialign::AffineTile, true>(shards, K, consts, n,
                                                        m, S, 0, n + m, 0);
}

// As bialign_seqsplit_score_affine, rings [3, W, W, P_k], the int32 [13]
// constants.
extern "C" int bialign_seqsplit_score_nonaffine(const int64_t* shards, int K,
                                                const int32_t* consts, int n,
                                                int m, int S) {
  return bialign::run_shards<bialign::NonaffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, 0);
}

// The checkpointed fill over K shards: as the score-only fill, each
// shard's fourth field its checkpoints [NB, 2, (9,) W, W, P_k], ckpts[b] =
// its slabs of diagonals (b*C-1, b*C-2) for b >= 1.
extern "C" int bialign_seqsplit_ckpt_affine(const int64_t* shards, int K,
                                            const int32_t* consts, int n,
                                            int m, int S, int C) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bialign::run_shards<bialign::AffineTile, true>(shards, K, consts, n,
                                                        m, S, 0, n + m, C);
}

extern "C" int bialign_seqsplit_ckpt_nonaffine(const int64_t* shards, int K,
                                               const int32_t* consts, int n,
                                               int m, int S, int C) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bialign::run_shards<bialign::NonaffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, C);
}

// Block d0 / C of a checkpointed band over K shards: each shard's first
// field its window [C+2, (9,) W, W, P_k] (any contents), its fourth its
// checkpoint of the block [2, ...]; diagonals d0..min(d0+C-1, n+m) into
// slabs 2.., slabs 0 and 1 the checkpoint's (d0-2, d0-1) unless d0 == 0.
extern "C" int bialign_seqsplit_block_affine(const int64_t* shards, int K,
                                             const int32_t* consts, int n,
                                             int m, int S, int d0, int C) {
  return bialign::run_shards<bialign::AffineTile, false>(
      shards, K, consts, n, m, S, d0, std::min(d0 + C - 1, n + m), 0);
}

extern "C" int bialign_seqsplit_block_nonaffine(const int64_t* shards, int K,
                                                const int32_t* consts, int n,
                                                int m, int S, int d0, int C) {
  return bialign::run_shards<bialign::NonaffineTile, false>(
      shards, K, consts, n, m, S, d0, std::min(d0 + C - 1, n + m), 0);
}

// Route "resident" of the six entries above, the same arguments; each
// shard's row of the table also names its progress flags (an int32 a row
// of the shard, zeroed, on its device), its rows a CTA (0: the default)
// and the fault word (int32 [4] of pinned host memory, or 0), and its
// stream field is its card's stream for the launch.  One cooperative
// launch a card.
extern "C" int bialign_seqsplit_resident_score_affine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m,
    int S) {
  return bialign::run_resident<bialign::AffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, 0);
}

extern "C" int bialign_seqsplit_resident_score_nonaffine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m,
    int S) {
  return bialign::run_resident<bialign::NonaffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, 0);
}

extern "C" int bialign_seqsplit_resident_ckpt_affine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m, int S,
    int C) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bialign::run_resident<bialign::AffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, C);
}

extern "C" int bialign_seqsplit_resident_ckpt_nonaffine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m, int S,
    int C) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bialign::run_resident<bialign::NonaffineTile, true>(
      shards, K, consts, n, m, S, 0, n + m, C);
}

extern "C" int bialign_seqsplit_resident_block_affine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m, int S,
    int d0, int C) {
  return bialign::run_resident<bialign::AffineTile, false>(
      shards, K, consts, n, m, S, d0, std::min(d0 + C - 1, n + m), 0);
}

extern "C" int bialign_seqsplit_resident_block_nonaffine(
    const int64_t* shards, int K, const int32_t* consts, int n, int m, int S,
    int d0, int C) {
  return bialign::run_resident<bialign::NonaffineTile, false>(
      shards, K, consts, n, m, S, d0, std::min(d0 + C - 1, n + m), 0);
}
