// One row of one diagonal of the non-affine recurrence of one pair: the
// device function `Nonaffine::row` that the one-CTA-a-pair kernel K6
// instantiates, csrc/cta_scores.cu (non-affine form) through
// csrc/cta_scores.cuh.  Every other non-affine fill (K2, K5, K8's
// non-affine form, K11, K12) runs the tile kernel of csrc/tile_diag.cuh
// (`NonaffineTile`), as csrc/affine_diag.cuh says.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_nonaffine_kernel with its slab
// update _make_nonaffine_update, as the batched kernels use it.  Same
// recurrence, same int32 values on every genuine cell: the 13 columns of
// the reference (pyx:225-252), of which the 10 that advance a sequence read
// diagonals d-1 and d-2 and the 3 str-only ones read this diagonal in
// ascending t = sk + sl; the INVALID mask of a failed guard,
// INVALID -> NEG_INF, and 0 at the origin.
//
// As in csrc/affine_diag.cuh the callers differ only in where the slabs
// live: `slabs` is slab 0 of this pair, P its rows per line, and diagonal d
// is slab d of the band [n+m+1, W, W, P] or slab d % 3 of the ring
// [3, W, W, P] (template kRing); the tables are the pair's own or its plane
// of a bucket's stack (ld).
//
// What bounds K6, which runs it (measured; PERF.md, Findings): as in
// csrc/affine_diag.cuh, one thread's chain of dependent loads, each case's
// loads behind that case's guard: 25 positions x 13 cases.
//
// Design: as csrc/affine_diag.cuh.  One thread per live lattice row, shift
// positions in ascending t with each value written at once, so the
// str-only cases read this thread's own earlier writes.  With no state
// axis, one guard serves all 13 cases: for the str-only columns
// (x0 = x1 = 0) it reduces to the reference's sk >= x2, sl >= x3, k >= x2,
// l >= x3.  Rows outside the live range are never written and, by the
// guard, never read.
#pragma once

#include "common.cuh"

namespace bialign {
namespace {

struct Nonaffine {
  // int32 values of the packed case table (cuda_dp.nonaffine_case_table)
  static constexpr int kTable = N_NONAFFINE_CASES * REC;

  // int32 values of one slab per lattice row: [W, W]
  __host__ __device__ static int cells(int S) {
    return (2 * S + 1) * (2 * S + 1);
  }

  // Row i of diagonal d: every shift position of cell (i, d-i).  `tab` is
  // the case table, in shared memory.
  template <bool kRing>
  __device__ __forceinline__ static void row(
      int32_t* slabs, const int32_t* tab, const int32_t* __restrict__ mu1,
      const int32_t* __restrict__ mu2, int n, int m, int ld, int P, int S,
      int d, int i) {
    const int j = d - i;
    const int W = 2 * S + 1;
    const int32_t m1 = mu1[(long long)i * ld + j];

    for (int t = 0; t <= 4 * S; ++t) {
      for (int sk = max(0, t - 2 * S); sk <= min(2 * S, t); ++sk) {
        const int sl = t - sk;
        const int k = i + sk - S;
        const int l = j + sl - S;
        const int32_t m2 = mu_at(mu2, k, l, n, m, ld);

        int32_t best = INVALID;
        for (int ci = 0; ci < N_NONAFFINE_CASES; ++ci) {
          const int32_t* cc = tab + ci * REC;
          const int x0 = cc[X0], x1 = cc[X1], x2 = cc[X2], x3 = cc[X3];
          const int psk = sk - x2 + x0, psl = sl - x3 + x1;
          if (i >= x0 && j >= x1 && k >= x2 && l >= x3 && psk >= 0 && psk < W &&
              psl >= 0 && psl < W) {
            const int32_t pred = slabs[cell_offset(
                slab_of<kRing>(d - x0 - x1), 0, psk, psl, i - x0, 1, W, P)];
            best = max(best, pred + cc[CST] + cc[MU1C] * m1 + cc[MU2C] * m2);
          }
        }
        int32_t val = best == INVALID ? NEG_INF : best;
        if (d == 0 && i == 0 && sk == S && sl == S) val = 0;  // pyx:464-465
        slabs[cell_offset(slab_of<kRing>(d), 0, sk, sl, i, 1, W, P)] = val;
      }
    }
  }

  // The optimal score, from the slab of diagonal n+m: the value at
  // (S, S, n).
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int S, int n) {
    return slab[cell_offset(0, 0, S, S, n, 1, 2 * S + 1, P)];
  }
};

}  // namespace
}  // namespace bialign
