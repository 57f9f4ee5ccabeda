// The triplet aligner's fill: a 3-D banded max-plus wavefront over one copy
// of A and two copies of B (bialign_tpu_torch/models/triplet.py), one CTA
// for the pair.
//
// Replaces bialign_tpu/models/triplet.py:fill_xla, the XLA scan over the
// anti-diagonals d = i + j (jit at :188).  It leaves what the plain twin
// fill_slabs leaves: the slabs ys[d, i, sk] int32 [n+m+1, n+1, 2S+1], the
// band offset sk = k - j + S, on every cell of the domain (rows
// max(0, d-m) <= i <= min(n, d), 0 <= k <= m) and nowhere else: a cell off
// the domain is never written, and by the guards never read.
//
// Design.  One CTA runs every diagonal, a __syncthreads() between two; a
// thread takes the rows i = threadIdx.x (mod blockDim.x) and, for each,
// the band offsets sk in increasing order.  The six cases that advance i or
// j read diagonals d-1 and d-2, which the kernel wrote into ys before the
// barrier (the last two diagonals stay in the L1 and the L2); the seventh,
// (0,0,1), advances k within the diagonal and reads the row's value at
// sk-1, which the same thread has just made and keeps in a register, so no
// barrier falls inside a diagonal.  The tables are read in their own
// (n+1) x (m+1) layout: no diagonal copy of them is built.  Not carried
// over from the XLA scan: its diagonal tables MU1D/MU2D (the TPU's
// gather-free skew), the padded shifts of whole slabs, and the unrolled
// sweep of the (0,0,1) case over all W offsets.
//
// Arithmetic: int32 that wraps as torch's and XLA's int32 do.  The adds run
// in uint32_t (signed overflow is undefined in C++), so that the kernel
// equals the twin also on tables whose sums leave int32.  The sentinels are
// the twin's: INVALID for an empty maximum, NEG_INF for an unreachable
// cell (csrc/common.cuh).

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

// Band widths W = 2S+1 compiled as constants (S = 0..kTripletStaticShifts);
// a larger S runs the same code with W read at run time.
constexpr int kTripletStaticShifts = 8;
constexpr int kTripletMaxThreads = 1024;

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

}  // namespace
}  // namespace bialign

// The triplet fill of one pair into ys [n+m+1, n+1, 2S+1] (any contents;
// only the domain's cells are written) from the tables mu1, mu2 [n+1, m+1]
// on `stream`, one launch of one CTA of `threads` threads (1-1024).
// two_gamma = 2 gamma, gamma_delta = gamma + Delta, reduced to int32.
// Returns 0 or a cudaError_t value.
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
