// Non-affine band fill of one pair (K2, band mode).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_kernel with its slab
// update _make_nonaffine_update (launched by _nonaffine_pallas).  Same
// recurrence, same int32 values on every genuine cell: the 13 columns of
// the reference (pyx:225-252), of which the 9 that advance a sequence read
// diagonals d-1 and d-2 and the 4 str-only ones read this diagonal in
// ascending t = sk + sl; the INVALID mask of a failed guard,
// INVALID -> NEG_INF, and 0 at the origin.
//
// What bounds it on an H100 80GB HBM3 at 700 W (measured; PERF.md,
// Findings): as in csrc/fill_affine.cu, one thread's chain of dependent
// loads, each case's loads behind that case's guard: 25 positions x 13
// cases, about 325 serial L2 round trips, about 50 us per launch.  Not the
// band writes (173 MB for the DNA-Pol-1 pair at the CLI's max_shift 2) nor
// the 1862 launches, one per diagonal.
//
// Design: as csrc/fill_affine.cu.  The band is the carry, one launch per
// diagonal, one thread per live lattice row, shift positions in ascending
// t with each value written at once, so the str-only cases read this
// thread's own earlier writes.  With no state axis, one guard serves all
// 13 cases: for the str-only columns (x0 = x1 = 0) it reduces to the
// reference's sk >= x2, sl >= x3, k >= x2, l >= x3.

#include <algorithm>

#include "common.cuh"

namespace bialign {
namespace {

constexpr int kBlock = 128;
constexpr int kTable = N_NONAFFINE_CASES * REC;

__global__ void fill_nonaffine_diag(int32_t* band,
                                    const int32_t* __restrict__ mu1,
                                    const int32_t* __restrict__ mu2,
                                    const int32_t* __restrict__ cases, int n,
                                    int m, int S, int d, int lo, int hi) {
  __shared__ int32_t tab[kTable];
  for (int x = threadIdx.x; x < kTable; x += blockDim.x) tab[x] = cases[x];
  __syncthreads();

  const int i = lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (i > hi) return;
  const int j = d - i;
  const int W = 2 * S + 1;
  const int P = n + 1;
  const int32_t m1 = mu1[(long long)i * (m + 1) + j];

  for (int t = 0; t <= 4 * S; ++t) {
    for (int sk = max(0, t - 2 * S); sk <= min(2 * S, t); ++sk) {
      const int sl = t - sk;
      const int k = i + sk - S;
      const int l = j + sl - S;
      const int32_t m2 = mu_at(mu2, k, l, n, m);

      int32_t best = INVALID;
      for (int ci = 0; ci < N_NONAFFINE_CASES; ++ci) {
        const int32_t* cc = tab + ci * REC;
        const int x0 = cc[X0], x1 = cc[X1], x2 = cc[X2], x3 = cc[X3];
        const int psk = sk - x2 + x0, psl = sl - x3 + x1;
        if (i >= x0 && j >= x1 && k >= x2 && l >= x3 && psk >= 0 && psk < W &&
            psl >= 0 && psl < W) {
          const int32_t pred =
              band[cell_offset(d - x0 - x1, 0, psk, psl, i - x0, 1, W, P)];
          best = max(best, pred + cc[CST] + cc[MU1C] * m1 + cc[MU2C] * m2);
        }
      }
      int32_t val = best == INVALID ? NEG_INF : best;
      if (d == 0 && i == 0 && sk == S && sl == S) val = 0;  // pyx:464-465
      band[cell_offset(d, 0, sk, sl, i, 1, W, P)] = val;
    }
  }
}

}  // namespace
}  // namespace bialign

// Fills band [n+m+1, W, W, n+1] (pre-filled with INVALID) on `stream`.
// Returns 0, or the first launch error as a cudaError_t value.
extern "C" int bialign_fill_nonaffine(int32_t* band, const int32_t* mu1,
                                      const int32_t* mu2, const int32_t* cases,
                                      int n, int m, int S, int device,
                                      void* stream) {
  using namespace bialign;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int d = 0; d <= n + m; ++d) {
    const int lo = std::max(0, d - m);
    const int hi = std::min(n, d);
    const int blocks = (hi - lo + 1 + kBlock - 1) / kBlock;
    fill_nonaffine_diag<<<blocks, kBlock, 0, st>>>(band, mu1, mu2, cases, n,
                                                   m, S, d, lo, hi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
