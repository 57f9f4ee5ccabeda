// One row of one diagonal of the affine recurrence at max_shift 0: the
// device function `AffineMs0::row` shared by csrc/score_affine_ms0.cu (K3,
// one pair, one launch per diagonal) and csrc/cta_scores_ms0.cu (K7, one
// CTA per pair of a bucket, through csrc/cta_scores.cuh).
//
// Replaces the slab update bialign_tpu/ops/pallas_dp.py:_make_update_ms0
// with the tables of _ms0_live_tables.  At max_shift 0 the shift band
// collapses to one position, so a column must advance both alignment copies
// in lockstep: only the three synchronised states (0,1,0,1), (1,0,1,0),
// (1,1,1,1) are reachable, and the half columns of groups B and C are dead.
// What is left is a max over the three live source states of one
// predecessor cell, per live target state.  Equal to csrc/affine_diag.cuh
// at max_shift 0 in the score, not slab for slab: the six dead states are
// not computed.  A failed guard gives NEG_INF at once (there is no INVALID
// mask to merge with another group), and the origin gets 0 for the
// both-match state and NEG_INF for the other two.
//
// A slab is [3, P] (the live states; rows last), diagonal d in slab d % 3
// of a ring of three.  A guard (i >= a, j >= b) makes its predecessor a
// live row of its own diagonal, so the stale rows of the ring are never
// read.  The tables are the pair's own [n+1, m+1] (ld = m+1) or its plane
// of a bucket's zero-padded stack (ld = M+1).
#pragma once

#include "common.cuh"

namespace bialign {
namespace {

constexpr int LIVE = 3;   // live states at max_shift 0

// One packed live target state (cuda_dp.ms0_case_table): its column's
// sequence advances (a, b), its mu1/mu2 multiplicities, and the constant of
// each live source state.
enum Ms0Field {
  MS0_A = 0, MS0_B, MS0_MU1C, MS0_MU2C, MS0_CST, MS0_REC = MS0_CST + LIVE
};

struct AffineMs0 {
  static constexpr int kTable = LIVE * MS0_REC;

  // int32 values of one slab per lattice row (S is 0)
  __host__ __device__ static int cells(int) { return LIVE; }

  // Row i of diagonal d: the three live states of cell (i, d-i).  `tab` is
  // the case table, in shared memory; kRing is always true here.
  template <bool kRing>
  __device__ __forceinline__ static void row(
      int32_t* ring, const int32_t* tab, const int32_t* __restrict__ mu1,
      const int32_t* __restrict__ mu2, int /*n*/, int /*m*/, int ld, int P,
      int /*S*/, int d, int i) {
    const int j = d - i;
    const long long at = (long long)i * ld + j;
    const int32_t m1 = mu1[at];
    const int32_t m2 = mu2[at];   // (k, l) = (i, j) at max_shift 0
    int32_t* here = ring + (long long)slab_of<true>(d) * LIVE * P;

    for (int t = 0; t < LIVE; ++t) {
      const int32_t* ct = tab + t * MS0_REC;
      const int a = ct[MS0_A], b = ct[MS0_B];
      int32_t val = NEG_INF;
      if (i >= a && j >= b) {
        const int32_t* pred =
            ring + (long long)slab_of<true>(d - a - b) * LIVE * P + (i - a);
        int32_t agg = pred[0] + ct[MS0_CST];
        for (int s = 1; s < LIVE; ++s)
          agg = max(agg, pred[(long long)s * P] + ct[MS0_CST + s]);
        val = agg + ct[MS0_MU1C] * m1 + ct[MS0_MU2C] * m2;
      }
      if (d == 0 && i == 0) val = (a & b) ? 0 : NEG_INF;   // the origin
      here[(long long)t * P + i] = val;
    }
  }

  // The optimal score, from the slab of diagonal n+m: the max over the
  // three live states at row n.
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int /*S*/, int n) {
    return max(slab[n], max(slab[P + n], slab[2 * P + n]));
  }
};

}  // namespace
}  // namespace bialign
