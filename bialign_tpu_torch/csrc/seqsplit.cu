// The sequence split: one pair's lattice rows in K contiguous shards, each
// shard's diagonals on a stream of its own (on one card or several), the
// tile kernel of csrc/tile_diag.cuh in its row-shard form.  Three entry
// points, each affine and non-affine:
//   * the score-only ring fill (K1/K2 score-only mode, split);
//   * the checkpointed fill (K9/K11, split);
//   * the fill of one block into a window from its checkpoint (K10/K12,
//     split).
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
// of slab d goes to slot 0 of shard k+1's slab d: `cells` values P_k apart
// to `cells` values P_{k+1} apart, one cudaMemcpy2DAsync (a peer copy
// between two cards), issued on the receiving shard's stream after an event
// that marks shard k's diagonal d.  Shard k+1's diagonal d+1 then finds it
// in place, and so does its d+2.  Not copied when row b_k is off diagonal
// d: nothing reads it then.
//
// Write after read on a ring.  Shard k+1's copy of diagonal d reads slab
// d % 3 of shard k, which shard k's diagonal d+3 overwrites; so before that
// diagonal, shard k's stream waits for an event that marks the copy.  On
// the receiving side the copy overwrites slot 0 of slab d % 3, which
// shard k+1's diagonal d-1 read (as d-3 = d-1-2): that diagonal is on the
// same stream, before the copy.  A window is written once a diagonal a
// block: no such wait.
//
// Checkpoints and windows hold the halo too: the slabs saved before
// diagonal b*C carry slot 0 as the copies left it, which is what the block
// fill needs for its first two diagonals.
//
// The caller orders the shards' streams against its own (the wrappers in
// bialign_tpu_torch/parallel/seqsplit.py: each shard's stream waits for its
// device's current stream first, and that stream waits for it after).
// What bounds it: the tile kernel's launches, K of them a diagonal, and the
// copies, one a shard boundary a diagonal; on one card the launches of all
// shards come from one host thread (PERF.md).
#include <algorithm>
#include <cstdint>

#include "ckpt_diag.cuh"

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
  kStream,
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

}  // namespace
}  // namespace bialign

// Score-only ring fill of one pair over K shards: `shards`, K x 8 int64 in
// host memory, a row a shard (ring [3, 9, W, W, P_k] with any contents,
// mu1, mu2 on its device, 0, a_k, b_k, device, stream).  The last diagonal
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
