// One row of one diagonal of the affine recurrence of one pair: the device
// function `Affine::row` that the bucket kernels instantiate:
//   csrc/batch_affine.cu (K4, both modes) through csrc/batch_diag.cuh;
//   csrc/cta_scores.cu (K6, affine form) through csrc/cta_scores.cuh;
//   csrc/conveyor_scores.cu (K8, affine form) through csrc/conveyor.cuh.
// The single-pair fills K1 and K9-K12 run the tile kernel of
// csrc/tile_diag.cuh, the same recurrence over a tile of rows a CTA; the
// next step moves these drivers onto it too (its device function takes a
// pair's slab base, tables and row range).  Until then the two are held
// to the same plain twins on the card (chip_smoke.py, phase 3).
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_kernel with its slab
// update _make_update, as the batched kernels use it.  Same recurrence,
// same int32 values on every genuine cell: group A (9 full columns, one per
// source state), group C (seq-only half columns), group B (str-only half
// columns, within the diagonal, in ascending t = sk + sl), the INVALID mask
// of a failed guard, INVALID -> NEG_INF, and the origin's initial values.
//
// The callers differ only in where the slabs live and how they are
// addressed: `slabs` is slab 0 of this pair (device memory, or a CTA's
// shared memory), P its rows per line, and kRing says where diagonal d is:
//   band (kRing = false): slab d of [n+m+1, 9, W, W, P]; the band in
//     device memory doubles as the carry;
//   ring (kRing = true): slab d % 3 of [3, 9, W, W, P].  Diagonal d
//     reads d-1 and d-2 and overwrites d-3.  Two slabs would not do: a
//     thread of diagonal d would overwrite a row of d-2 that a
//     neighbouring thread still reads.
// The tables are one pair's [n+1, m+1] (ld = m+1, P = n+1), or its plane of
// a bucket's zero-padded stack [N+1, M+1] (ld = M+1, P = N+1), bounded by
// the pair's own n, m either way.
//
// What bounds the bucket kernels that run it on an H100 80GB HBM3 at 700 W
// (measured; PERF.md, Findings): the length of one thread's chain of
// dependent loads.  Each case group's loads sit behind that group's guard
// branch, which the compiler does not hoist them above, so a thread's
// groups load one after another: 81 (position, state) pairs x 3 groups,
// about 243 serial L2 round trips, about 50-75 us a launch whatever the
// rows.  csrc/tile_diag.cuh is what replaces it.
//
// Design: one thread per live lattice row i of the diagonal (max(0, d-m)
// <= i <= min(n, d)); rows are the slab's last axis, so a warp's loads and
// stores are coalesced.  The thread visits the (sk, sl) shift positions in
// ascending t and writes each value at once: group B then reads its own
// earlier writes from the slab, so the thread keeps no Q*W*W array in
// registers and needs no barrier inside a diagonal.  Between diagonals the
// caller orders reads after writes: one launch per diagonal, or a
// __syncthreads() where one CTA holds the pair.  Rows outside the live
// range are never written, and never read either: a case's guard (i >= a,
// j >= b) makes its predecessor a live row of its own diagonal
// (0 <= i-a <= n, 0 <= j-b <= m), which a thread wrote for every state and
// shift position.
#pragma once

#include "common.cuh"

namespace bialign {
namespace {

struct Affine {
  // int32 values of the packed case table (cuda_dp.affine_case_table)
  static constexpr int kTable = N_STATES * N_AFFINE_CASES * REC;

  // int32 values of one slab per lattice row: [9, W, W]
  __host__ __device__ static int cells(int S) {
    return N_STATES * (2 * S + 1) * (2 * S + 1);
  }

  // Row i of diagonal d: every state and shift position of cell (i, d-i).
  // `tab` is the case table, in shared memory.
  template <bool kRing>
  __device__ __forceinline__ static void row(
      int32_t* slabs, const int32_t* tab, const int32_t* __restrict__ mu1,
      const int32_t* __restrict__ mu2, int n, int m, int ld, int P, int S,
      int d, int i) {
    const int j = d - i;
    const int W = 2 * S + 1;
    const long long state_stride = (long long)W * W * P;
    const int32_t m1 = mu1[(long long)i * ld + j];
    const int here = slab_of<kRing>(d);

    for (int t = 0; t <= 4 * S; ++t) {
      for (int sk = max(0, t - 2 * S); sk <= min(2 * S, t); ++sk) {
        const int sl = t - sk;
        const int k = i + sk - S;
        const int l = j + sl - S;
        const int32_t m2 = mu_at(mu2, k, l, n, m, ld);
        const bool origin = d == 0 && i == 0 && sk == S && sl == S;

        for (int q = 0; q < N_STATES; ++q) {
          const int32_t* cq = tab + q * N_AFFINE_CASES * REC;
          int32_t best = INVALID;

          // group A: column (a, b, c, e) = state q from all 9 source states
          // (pallas_dp.py:208-226)
          {
            const int a = cq[X0], b = cq[X1], c = cq[X2], e = cq[X3];
            const int psk = sk - c + a, psl = sl - e + b;
            if (i >= a && j >= b && k >= c && l >= e && psk >= 0 && psk < W &&
                psl >= 0 && psl < W) {
              const int32_t* pred =
                  slabs + cell_offset(slab_of<kRing>(d - a - b), 0, psk, psl,
                                      i - a, N_STATES, W, P);
              int32_t agg = pred[cq[SRC] * state_stride] + cq[CST];
              for (int s = 1; s < N_STATES; ++s) {
                const int32_t* cs = cq + s * REC;
                agg = max(agg, pred[cs[SRC] * state_stride] + cs[CST]);
              }
              best = agg + cq[MU1C] * m1 + cq[MU2C] * m2;
            }
          }

          // group C: seq-only half column (a, b, 0, 0) (pallas_dp.py:228-240)
          {
            const int32_t* cc = cq + FIRST_C * REC;
            const int a = cc[X0], b = cc[X1];
            const int psk = sk + a, psl = sl + b;
            if (i >= a && j >= b && psk < W && psl < W) {
              const int32_t* pred =
                  slabs + cell_offset(slab_of<kRing>(d - a - b), 0, psk, psl,
                                      i - a, N_STATES, W, P);
              int32_t agg = pred[cc[SRC] * state_stride] + cc[CST];
              for (int h = 1; h < 3; ++h) {
                const int32_t* ch = cc + h * REC;
                agg = max(agg, pred[ch[SRC] * state_stride] + ch[CST]);
              }
              best = max(best, agg + cc[MU1C] * m1);
            }
          }

          // group B: str-only half column (0, 0, c, e), read from this
          // diagonal at t - c - e, which this thread has already written; a
          // source off the slab (sk < c or sl < e) is a dead case
          // (pallas_dp.py:270-299)
          {
            const int32_t* cb = cq + FIRST_B * REC;
            const int c = cb[X2], e = cb[X3];
            if (sk >= c && sl >= e && k >= c && l >= e) {
              const int32_t* pred = slabs + cell_offset(here, 0, sk - c, sl - e,
                                                        i, N_STATES, W, P);
              int32_t agg = pred[cb[SRC] * state_stride] + cb[CST];
              for (int h = 1; h < 3; ++h) {
                const int32_t* ch = cb + h * REC;
                agg = max(agg, pred[ch[SRC] * state_stride] + ch[CST]);
              }
              best = max(best, agg + cb[MU2C] * m2);
            }
          }

          int32_t val = best == INVALID ? NEG_INF : best;
          if (origin) {
            // only the both-match state starts at 0 (pyx:483-485)
            const bool both = cq[X0] & cq[X1] & cq[X2] & cq[X3];
            val = both ? 0 : NEG_INF;
          }
          slabs[cell_offset(here, q, sk, sl, i, N_STATES, W, P)] = val;
        }
      }
    }
  }

  // The optimal score, from the slab of diagonal n+m: the max over the 9
  // states at (S, S, n).
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int S, int n) {
    const int W = 2 * S + 1;
    int32_t best = slab[cell_offset(0, 0, S, S, n, N_STATES, W, P)];
    for (int q = 1; q < N_STATES; ++q)
      best = max(best, slab[cell_offset(0, q, S, S, n, N_STATES, W, P)]);
    return best;
  }
};

}  // namespace
}  // namespace bialign
