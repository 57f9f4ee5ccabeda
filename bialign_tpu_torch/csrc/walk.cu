// Traceback walks over a filled band, on the device that holds it.
//
// Replaces bialign_tpu/ops/device_traceback.py:_affine_walk and
// _nonaffine_walk, the lax.while_loop programs that walk the band on the
// TPU so that it never leaves the device.  Same walk, same tie-breaks:
//
// * affine start state: best final value, then least intrinsic shift,
//   then state order (device_traceback.py:204-216);
// * affine step: of all co-optimal cases, the least key
//   (|tA| + |tB|) * 256 + |tB|, the first minimum winning (:177-181);
//   the origin test does not fire before the first step (the `first`
//   flag, :141-144); done = 1 complete, 2 stuck;
// * non-affine step: the first case whose re-evaluated value equals the
//   cell's (ops/traceback.py:122).
//
// What bounds it on an H100: latency.  A walk is up to 2(n+m) dependent
// steps, each a handful of reads from a band far larger than the L2, with
// no parallel work to hide them.  Design: one thread (<<<1, 1>>>) that
// checks each case's guard before it forms an address, so no read leaves
// the band; it writes the step count, the done flag and the column codes
// into one small tensor, which the host fetches in one copy.

#include <cstdlib>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kBig = 1 << 20;
constexpr int kKeyScale = 256;  // > any |net B shift| of a walk (<= S + 1)

// out = [steps, done, codes...]
constexpr int kHeader = 2;

__device__ __forceinline__ int encode(int x0, int x1, int x2, int x3) {
  return x0 * 8 + x1 * 4 + x2 * 2 + x3;
}

__device__ __forceinline__ bool guard(int pi, int pj, int pk, int pl, int S) {
  return pi >= 0 && pj >= 0 && pk >= 0 && pl >= 0 && abs(pk - pi) <= S &&
         abs(pl - pj) <= S;
}

__global__ void walk_affine(const int32_t* band, const int32_t* mu1,
                            const int32_t* mu2, const int32_t* cases, int n,
                            int m, int S, int32_t* out, int lmax) {
  const int W = 2 * S + 1;
  const int P = n + 1;
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
    const int32_t m1 = mu1[(long long)i * (m + 1) + j];
    const int32_t m2 = mu2[(long long)k * (m + 1) + l];
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
}

__global__ void walk_nonaffine(const int32_t* band, const int32_t* mu1,
                               const int32_t* mu2, const int32_t* cases, int n,
                               int m, int S, int32_t* out, int lmax) {
  const int W = 2 * S + 1;
  const int P = n + 1;
  auto cell = [&](int i, int j, int k, int l) {
    return band[cell_offset(i + j, 0, k - i + S, l - j + S, i, 1, W, P)];
  };

  int i = n, j = m, k = n, l = m;
  int step = 0, done = 0;
  while (step < lmax) {
    const int32_t here = cell(i, j, k, l);
    const int32_t m1 = mu1[(long long)i * (m + 1) + j];
    const int32_t m2 = mu2[(long long)k * (m + 1) + l];
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
}

}  // namespace
}  // namespace bialign

// Walks band [n+m+1, 9, W, W, n+1] on `stream` into out [2 + lmax].
extern "C" int bialign_walk_affine(const int32_t* band, const int32_t* mu1,
                                   const int32_t* mu2, const int32_t* cases,
                                   int n, int m, int S, int32_t* out, int lmax,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bialign::walk_affine<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      band, mu1, mu2, cases, n, m, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Walks band [n+m+1, W, W, n+1] on `stream` into out [2 + lmax].
extern "C" int bialign_walk_nonaffine(const int32_t* band, const int32_t* mu1,
                                      const int32_t* mu2, const int32_t* cases,
                                      int n, int m, int S, int32_t* out,
                                      int lmax, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bialign::walk_nonaffine<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      band, mu1, mu2, cases, n, m, S, out, lmax);
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t value returned by the functions of this library.
extern "C" const char* bialign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
