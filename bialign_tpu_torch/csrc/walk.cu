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

#include <cstdlib>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kBig = 1 << 20;
constexpr int kKeyScale = 256;  // > any |net B shift| of a walk (<= S + 1)

// out = [steps, done, score, codes...]
constexpr int kHeader = 3;

__device__ __forceinline__ int encode(int x0, int x1, int x2, int x3) {
  return x0 * 8 + x1 * 4 + x2 * 2 + x3;
}

__device__ __forceinline__ bool guard(int pi, int pj, int pk, int pl, int S) {
  return pi >= 0 && pj >= 0 && pk >= 0 && pl >= 0 && abs(pk - pi) <= S &&
         abs(pl - pj) <= S;
}

__device__ __forceinline__ void walk_affine_body(
    const int32_t* band, int P, const int32_t* mu1, const int32_t* mu2, int ld,
    const int32_t* cases, int n, int m, int S, int32_t* out, int lmax) {
  const int W = 2 * S + 1;
  auto cell = [&](int q, int i, int j, int k, int l) {
    return band[cell_offset(i + j, q, k - i + S, l - j + S, i, N_STATES, W, P)];
  };
  auto rec = [&](int q, int ci) {
    return cases + (q * N_AFFINE_CASES + ci) * REC;
  };

  int32_t score = cell(0, n, m, n, m);
  for (int q = 1; q < N_STATES; ++q) score = max(score, cell(q, n, m, n, m));
  int q = 0;
  int least = kBig;
  for (int s = 0; s < N_STATES; ++s) {
    const int32_t* c = rec(s, 0);  // case 0 is state s's own column
    const int intrinsic = abs(c[X0] - c[X2]) + abs(c[X1] - c[X3]);
    if (cell(s, n, m, n, m) == score && intrinsic < least) {
      least = intrinsic;
      q = s;
    }
  }

  int i = n, j = m, k = n, l = m;
  int netA = 0, netB = 0, step = 0, done = 0;
  bool first = true;
  while (step < lmax) {
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
}

__device__ __forceinline__ void walk_nonaffine_body(
    const int32_t* band, int P, const int32_t* mu1, const int32_t* mu2, int ld,
    const int32_t* cases, int n, int m, int S, int32_t* out, int lmax) {
  const int W = 2 * S + 1;
  auto cell = [&](int i, int j, int k, int l) {
    return band[cell_offset(i + j, 0, k - i + S, l - j + S, i, 1, W, P)];
  };

  const int32_t score = cell(n, m, n, m);
  int i = n, j = m, k = n, l = m;
  int step = 0, done = 0;
  while (step < lmax) {
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
}

__global__ void walk_affine(const int32_t* band, const int32_t* mu1,
                            const int32_t* mu2, const int32_t* cases, int n,
                            int m, int S, int32_t* out, int lmax) {
  walk_affine_body(band, n + 1, mu1, mu2, m + 1, cases, n, m, S, out, lmax);
}

__global__ void walk_nonaffine(const int32_t* band, const int32_t* mu1,
                               const int32_t* mu2, const int32_t* cases, int n,
                               int m, int S, int32_t* out, int lmax) {
  walk_nonaffine_body(band, n + 1, mu1, mu2, m + 1, cases, n, m, S, out, lmax);
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
  walk_affine_body(bands + p.band, N + 1, mu1 + p.tables, mu2 + p.tables,
                   M + 1, cases, p.n, p.m, S, p.out, lmax);
}

__global__ void walk_nonaffine_batch(const int32_t* bands, const int32_t* mu1,
                                     const int32_t* mu2, const int32_t* cases,
                                     const int32_t* ns, const int32_t* ms,
                                     int N, int M, int D, int S, int32_t* out,
                                     int lmax) {
  const int W = 2 * S + 1;
  const ChunkPair p = chunk_pair(ns, ms, N, M, D, W * W, out, lmax);
  if (!p.ok) return;
  walk_nonaffine_body(bands + p.band, N + 1, mu1 + p.tables, mu2 + p.tables,
                      M + 1, cases, p.n, p.m, S, p.out, lmax);
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

// Message of a cudaError_t value returned by the functions of this library.
extern "C" const char* bialign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
