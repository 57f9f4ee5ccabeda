// Traceback walks over a filled band, on the device that holds it: one
// pair's band, or every pair of a chunk band in one launch.
//
// Replaces bialign_tpu/ops/device_traceback.py:_affine_walk and
// _nonaffine_walk, the lax.while_loop programs that walk the band on the
// TPU so that it never leaves the device, and their jax.vmap forms
// _affine_walk_batch and _nonaffine_walk_batch.  Same walk, same
// tie-breaks:
//
// * affine start state: best final value, then least intrinsic shift,
//   then state order (device_traceback.py:204-216);
// * affine step: of all co-optimal cases, the least key
//   (|tA| + |tB|) * 256 + |tB|, the first minimum winning (:177-181);
//   the origin test does not fire before the first step (the `first`
//   flag, :141-144); done = 1 complete, 2 stuck;
// * non-affine step: the first case whose re-evaluated value equals the
//   cell's (ops/traceback.py:122); done = 1 when no case matches.
//
// What bounds it on an H100: latency.  A walk is up to 2(n+m) dependent
// steps, each a handful of reads from a band far larger than the L2, with
// no parallel work to hide them.  Design: one thread per pair that checks
// each case's guard before it forms an address, so no read leaves the
// pair's written cells; it writes the step count, the done flag, the score
// and the column codes into one small tensor, which the host fetches in one
// copy.  The walk body is one device function over (band, its rows per
// line P, tables, their row stride ld, n, m): a single pair has P = n + 1,
// ld = m + 1 and runs it in <<<1, 1>>>; a chunk of B pairs has the
// bucket's P = N + 1, ld = M + 1, pair b's band D * cells * P values (64
// bit) and its tables (N+1)(M+1) values behind the chunk's first, and runs
// one block per pair, so that the B chains spread over the SMs.
//
// The blockwise walks (walk_affine_block, walk_nonaffine_block) replace
// bialign_tpu/ops/checkpoint_dp.py:_affine_blk_walk and _nonaffine_blk_walk:
// the same bodies with kBlock = true, over the window [C+2, ...] that
// csrc/block_affine.cu or csrc/block_nonaffine.cu recomputed for one block
// of C diagonals from d0 (its base moved back by d0-2 slabs, so that
// cell_offset(i + j, ...) serves as it is).  The walk stops when i + j
// falls below d0 and leaves its state (i, j, k, l, and for the affine walk
// q, netA, netB, first) in a small tensor on the device, from which the
// next block's call goes on; steps, done, score and codes accumulate in
// the one output.  The call on the block of diagonal n+m works out the
// score and the start state.  So the host queues every block's fill and
// walk without reading anything back, and fetches the output once.  Not
// carried over: the per-block trace buffer with its step cap, and the
// host's fetch of the state after every block.

#include <cstdlib>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kBig = 1 << 20;
constexpr int kKeyScale = 256;  // > any |net B shift| of a walk (<= S + 1)

// out = [steps, done, score, codes...]
constexpr int kHeader = 3;

// state of a blockwise walk between two blocks
enum State { ST_I = 0, ST_J, ST_K, ST_L, ST_Q, ST_NETA, ST_NETB, ST_FIRST };

__device__ __forceinline__ int encode(int x0, int x1, int x2, int x3) {
  return x0 * 8 + x1 * 4 + x2 * 2 + x3;
}

__device__ __forceinline__ bool guard(int pi, int pj, int pk, int pl, int S) {
  return pi >= 0 && pj >= 0 && pk >= 0 && pl >= 0 && abs(pk - pi) <= S &&
         abs(pl - pj) <= S;
}

// kBlock: walk one block of a checkpointed band.  `band` is then the
// block's window on its moved base, the walk stops below diagonal d0,
// `start` says whether this is the block of diagonal n+m, and `state` is
// where the walk's state waits between blocks.
template <bool kBlock>
__device__ __forceinline__ void walk_affine_body(
    const int32_t* band, int P, const int32_t* mu1, const int32_t* mu2, int ld,
    const int32_t* cases, int n, int m, int S, int32_t* out, int lmax,
    int d0 = 0, bool start = true, int32_t* state = nullptr) {
  const int W = 2 * S + 1;
  auto cell = [&](int q, int i, int j, int k, int l) {
    return band[cell_offset(i + j, q, k - i + S, l - j + S, i, N_STATES, W, P)];
  };
  auto rec = [&](int q, int ci) {
    return cases + (q * N_AFFINE_CASES + ci) * REC;
  };

  int32_t score;
  int q = 0;
  int i = n, j = m, k = n, l = m;
  int netA = 0, netB = 0, step = 0, done = 0;
  bool first = true;
  if (!kBlock || start) {
    score = cell(0, n, m, n, m);
    for (int s = 1; s < N_STATES; ++s) score = max(score, cell(s, n, m, n, m));
    int least = kBig;
    for (int s = 0; s < N_STATES; ++s) {
      const int32_t* c = rec(s, 0);  // case 0 is state s's own column
      const int intrinsic = abs(c[X0] - c[X2]) + abs(c[X1] - c[X3]);
      if (cell(s, n, m, n, m) == score && intrinsic < least) {
        least = intrinsic;
        q = s;
      }
    }
  } else {
    if (out[1] != 0) return;  // an earlier block ended the walk
    step = out[0];
    score = out[2];
    i = state[ST_I];
    j = state[ST_J];
    k = state[ST_K];
    l = state[ST_L];
    q = state[ST_Q];
    netA = state[ST_NETA];
    netB = state[ST_NETB];
    first = state[ST_FIRST] != 0;
  }

  while (step < lmax) {
    if (kBlock && i + j < d0) break;  // the next block's
    const int32_t* c0 = rec(q, 0);
    const bool both = c0[X0] & c0[X1] & c0[X2] & c0[X3];
    if (i == 0 && j == 0 && k == 0 && l == 0 && both && !first) {
      done = 1;
      break;
    }
    const int32_t here = cell(q, i, j, k, l);
    const int32_t m1 = mu1[(long long)i * ld + j];
    const int32_t m2 = mu2[(long long)k * ld + l];
    int sel = -1;
    int best_key = kBig;
    for (int ci = 0; ci < N_AFFINE_CASES; ++ci) {
      const int32_t* c = rec(q, ci);
      const int pi = i - c[X0], pj = j - c[X1], pk = k - c[X2], pl = l - c[X3];
      if (!guard(pi, pj, pk, pl, S)) continue;
      const int32_t v = cell(c[SRC], pi, pj, pk, pl) + c[CST] + c[MU1C] * m1 +
                        c[MU2C] * m2;
      if (v != here) continue;
      const int tA = netA + (c[X0] - c[X2]) + c[SRCA];
      const int tB = netB + (c[X1] - c[X3]) + c[SRCB];
      const int key = (abs(tA) + abs(tB)) * kKeyScale + abs(tB);
      if (key < best_key) {
        best_key = key;
        sel = ci;
      }
    }
    if (sel < 0) {
      done = 2;
      break;
    }
    const int32_t* c = rec(q, sel);
    out[kHeader + step] = encode(c[X0], c[X1], c[X2], c[X3]);
    i -= c[X0];
    j -= c[X1];
    k -= c[X2];
    l -= c[X3];
    netA += c[X0] - c[X2];
    netB += c[X1] - c[X3];
    q = c[SRC];
    first = false;
    ++step;
  }
  out[0] = step;
  out[1] = done;
  out[2] = score;
  if (kBlock) {
    state[ST_I] = i;
    state[ST_J] = j;
    state[ST_K] = k;
    state[ST_L] = l;
    state[ST_Q] = q;
    state[ST_NETA] = netA;
    state[ST_NETB] = netB;
    state[ST_FIRST] = first;
  }
}

template <bool kBlock>
__device__ __forceinline__ void walk_nonaffine_body(
    const int32_t* band, int P, const int32_t* mu1, const int32_t* mu2, int ld,
    const int32_t* cases, int n, int m, int S, int32_t* out, int lmax,
    int d0 = 0, bool start = true, int32_t* state = nullptr) {
  const int W = 2 * S + 1;
  auto cell = [&](int i, int j, int k, int l) {
    return band[cell_offset(i + j, 0, k - i + S, l - j + S, i, 1, W, P)];
  };

  int32_t score;
  int i = n, j = m, k = n, l = m;
  int step = 0, done = 0;
  if (!kBlock || start) {
    score = cell(n, m, n, m);
  } else {
    if (out[1] != 0) return;  // an earlier block ended the walk
    step = out[0];
    score = out[2];
    i = state[ST_I];
    j = state[ST_J];
    k = state[ST_K];
    l = state[ST_L];
  }
  while (step < lmax) {
    if (kBlock && i + j < d0) break;  // the next block's
    const int32_t here = cell(i, j, k, l);
    const int32_t m1 = mu1[(long long)i * ld + j];
    const int32_t m2 = mu2[(long long)k * ld + l];
    const int32_t* hit = nullptr;
    for (int ci = 0; ci < N_NONAFFINE_CASES && hit == nullptr; ++ci) {
      const int32_t* c = cases + ci * REC;
      const int pi = i - c[X0], pj = j - c[X1], pk = k - c[X2], pl = l - c[X3];
      if (guard(pi, pj, pk, pl, S) &&
          cell(pi, pj, pk, pl) + c[CST] + c[MU1C] * m1 + c[MU2C] * m2 == here)
        hit = c;
    }
    if (hit == nullptr) {
      done = 1;
      break;
    }
    out[kHeader + step] = encode(hit[X0], hit[X1], hit[X2], hit[X3]);
    i -= hit[X0];
    j -= hit[X1];
    k -= hit[X2];
    l -= hit[X3];
    ++step;
  }
  out[0] = step;
  out[1] = done;
  out[2] = score;
  if (kBlock) {
    state[ST_I] = i;
    state[ST_J] = j;
    state[ST_K] = k;
    state[ST_L] = l;
  }
}

__global__ void walk_affine(const int32_t* band, const int32_t* mu1,
                            const int32_t* mu2, const int32_t* cases, int n,
                            int m, int S, int32_t* out, int lmax) {
  walk_affine_body<false>(band, n + 1, mu1, mu2, m + 1, cases, n, m, S, out,
                          lmax);
}

__global__ void walk_nonaffine(const int32_t* band, const int32_t* mu1,
                               const int32_t* mu2, const int32_t* cases, int n,
                               int m, int S, int32_t* out, int lmax) {
  walk_nonaffine_body<false>(band, n + 1, mu1, mu2, m + 1, cases, n, m, S,
                             out, lmax);
}

// One block of a checkpointed band: `window` is already on its moved base.
__global__ void walk_affine_block(const int32_t* window, const int32_t* mu1,
                                  const int32_t* mu2, const int32_t* cases,
                                  int n, int m, int S, int d0, int start,
                                  int32_t* state, int32_t* out, int lmax) {
  walk_affine_body<true>(window, n + 1, mu1, mu2, m + 1, cases, n, m, S, out,
                         lmax, d0, start != 0, state);
}

__global__ void walk_nonaffine_block(const int32_t* window,
                                     const int32_t* mu1, const int32_t* mu2,
                                     const int32_t* cases, int n, int m, int S,
                                     int d0, int start, int32_t* state,
                                     int32_t* out, int lmax) {
  walk_nonaffine_body<true>(window, n + 1, mu1, mu2, m + 1, cases, n, m, S,
                            out, lmax, d0, start != 0, state);
}

// `window` moved back by d0-2 slabs of `cells` * (n+1) values, the base on
// which slab d is diagonal d (csrc/ckpt_diag.cuh window_base).
inline const int32_t* moved_base(const int32_t* window, int cells, int n,
                                 int d0) {
  return reinterpret_cast<const int32_t*>(
      reinterpret_cast<intptr_t>(window) -
      (static_cast<intptr_t>(d0) - 2) * cells * (n + 1) *
          static_cast<intptr_t>(sizeof(int32_t)));
}

// Pair blockIdx.x of a chunk: its lengths, and whether its last cell lies
// inside the bucket and inside the D diagonals the chunk band holds.  A
// pair outside them is not walked: 0 steps, done = 2, score INVALID.
struct ChunkPair {
  int n, m;
  long long band, tables;  // offsets of this pair's band and tables
  int32_t* out;
  bool ok;
};

__device__ __forceinline__ ChunkPair chunk_pair(const int32_t* ns,
                                                const int32_t* ms, int N,
                                                int M, int D, int cells,
                                                int32_t* out, int lmax) {
  const int b = blockIdx.x;
  ChunkPair p;
  p.n = ns[b];
  p.m = ms[b];
  p.band = (long long)b * D * cells * (N + 1);
  p.tables = (long long)b * (N + 1) * (M + 1);
  p.out = out + (long long)b * (kHeader + lmax);
  p.ok = p.n >= 0 && p.n <= N && p.m >= 0 && p.m <= M && p.n + p.m < D;
  if (!p.ok) {
    p.out[0] = 0;
    p.out[1] = 2;
    p.out[2] = INVALID;
  }
  return p;
}

__global__ void walk_affine_batch(const int32_t* bands, const int32_t* mu1,
                                  const int32_t* mu2, const int32_t* cases,
                                  const int32_t* ns, const int32_t* ms, int N,
                                  int M, int D, int S, int32_t* out,
                                  int lmax) {
  const int W = 2 * S + 1;
  const ChunkPair p =
      chunk_pair(ns, ms, N, M, D, N_STATES * W * W, out, lmax);
  if (!p.ok) return;
  walk_affine_body<false>(bands + p.band, N + 1, mu1 + p.tables,
                          mu2 + p.tables, M + 1, cases, p.n, p.m, S, p.out,
                          lmax);
}

__global__ void walk_nonaffine_batch(const int32_t* bands, const int32_t* mu1,
                                     const int32_t* mu2, const int32_t* cases,
                                     const int32_t* ns, const int32_t* ms,
                                     int N, int M, int D, int S, int32_t* out,
                                     int lmax) {
  const int W = 2 * S + 1;
  const ChunkPair p = chunk_pair(ns, ms, N, M, D, W * W, out, lmax);
  if (!p.ok) return;
  walk_nonaffine_body<false>(bands + p.band, N + 1, mu1 + p.tables,
                             mu2 + p.tables, M + 1, cases, p.n, p.m, S, p.out,
                             lmax);
}

}  // namespace
}  // namespace bialign

// Walks band [n+m+1, 9, W, W, n+1] on `stream` into out [3 + lmax].
extern "C" int bialign_walk_affine(const int32_t* band, const int32_t* mu1,
                                   const int32_t* mu2, const int32_t* cases,
                                   int n, int m, int S, int32_t* out, int lmax,
                                   int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  bialign::walk_affine<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      band, mu1, mu2, cases, n, m, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Walks band [n+m+1, W, W, n+1] on `stream` into out [3 + lmax].
extern "C" int bialign_walk_nonaffine(const int32_t* band, const int32_t* mu1,
                                      const int32_t* mu2, const int32_t* cases,
                                      int n, int m, int S, int32_t* out,
                                      int lmax, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  bialign::walk_nonaffine<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      band, mu1, mu2, cases, n, m, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Walks the B >= 1 pairs of chunk band [B, D, 9, W, W, N+1] on `stream`,
// one block per pair, into out [B, 3 + lmax]; tables [B, N+1, M+1], lengths
// ns, ms [B].
extern "C" int bialign_walk_affine_batch(
    const int32_t* bands, const int32_t* mu1, const int32_t* mu2,
    const int32_t* cases, const int32_t* ns, const int32_t* ms, int B, int N,
    int M, int D, int S, int32_t* out, int lmax, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  bialign::walk_affine_batch<<<B, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, mu1, mu2, cases, ns, ms, N, M, D, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// The same over chunk band [B, D, W, W, N+1].
extern "C" int bialign_walk_nonaffine_batch(
    const int32_t* bands, const int32_t* mu1, const int32_t* mu2,
    const int32_t* cases, const int32_t* ns, const int32_t* ms, int B, int N,
    int M, int D, int S, int32_t* out, int lmax, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  bialign::walk_nonaffine_batch<<<B, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, mu1, mu2, cases, ns, ms, N, M, D, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Walks block d0.. of a checkpointed affine band on `stream`: window
// [C+2, 9, W, W, n+1] (slab x = diagonal d0-2+x), state [8], out
// [3 + lmax].  `start` != 0 on the block of diagonal n+m: the walk then
// begins; else it goes on from `state` and appends to `out`.
extern "C" int bialign_walk_affine_block(
    const int32_t* window, const int32_t* mu1, const int32_t* mu2,
    const int32_t* cases, int n, int m, int S, int d0, int start,
    int32_t* state, int32_t* out, int lmax, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const int W = 2 * S + 1;
  bialign::walk_affine_block<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      bialign::moved_base(window, bialign::N_STATES * W * W, n, d0), mu1, mu2,
      cases, n, m, S, d0, start, state, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// The same over window [C+2, W, W, n+1]; state [8], of which 4 are used.
extern "C" int bialign_walk_nonaffine_block(
    const int32_t* window, const int32_t* mu1, const int32_t* mu2,
    const int32_t* cases, int n, int m, int S, int d0, int start,
    int32_t* state, int32_t* out, int lmax, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const int W = 2 * S + 1;
  bialign::walk_nonaffine_block<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      bialign::moved_base(window, W * W, n, d0), mu1, mu2, cases, n, m, S, d0,
      start, state, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t value returned by the functions of this library.
extern "C" const char* bialign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
