// The affine recurrence at max_shift 0, one value of one diagonal: the
// per-value functions `AffineMs0` that the one-CTA-a-pair kernel `cta_ms0`
// of csrc/cta_scores.cuh runs for K3 (one pair, csrc/score_affine_ms0.cu)
// and K7 (a bucket, csrc/cta_scores_ms0.cu), and K3's per-diagonal kernel
// for a pair beyond one CTA (csrc/score_affine_ms0.cu).
//
// Replaces the slab update bialign_tpu/ops/pallas_dp.py:_make_update_ms0
// with the tables of _ms0_live_tables.  At max_shift 0 the shift band
// collapses to one position, so a column must advance both alignment copies
// in lockstep: only the three synchronised states (0,1,0,1), (1,0,1,0),
// (1,1,1,1) are reachable, and the half columns of groups B and C are dead.
// What is left is a max over the three live source states of one
// predecessor cell, per live target state: group A of the tile kernels
// (csrc/tile_diag.cuh) between live states.  Equal to the affine kernels
// at max_shift 0 in the score, not slab for slab: the six dead states are
// not computed.  A failed guard gives NEG_INF at once (there is no INVALID
// mask to merge with another group), and the origin gets 0 for the
// both-match state and NEG_INF for the other two.
//
// A slab is [3, P] (the live states; rows last), diagonal d in slab d % 3
// of a ring of three.  A guard (i >= a, j >= b) makes its predecessor a
// live row of its own diagonal, so the stale rows of the ring are never
// read.  The columns and multiplicities are the affine ones of
// csrc/recurrence.cuh; the constant terms come by value (AffineMs0Consts,
// packed by bialign_tpu_torch/ops/cuda_dp.py ms0_kernel_consts).
#pragma once

#include "common.cuh"
#include "recurrence.cuh"

namespace bialign {
namespace {

// The live states at max_shift 0 are STATES 0, 4 and 8: live state t is
// state 4t, whose column advances (a, b) and (c, e) alike.
__host__ __device__ constexpr int live_state(int t) { return 4 * t; }
static_assert(kStateCol[live_state(0)][0] == kStateCol[live_state(0)][2] &&
                  kStateCol[live_state(0)][1] == kStateCol[live_state(0)][3] &&
                  kStateCol[live_state(1)][0] == kStateCol[live_state(1)][2] &&
                  kStateCol[live_state(1)][1] == kStateCol[live_state(1)][3] &&
                  live_state(2) == kStateBoth,
              "the live states at max_shift 0");

// cst[t][s]: the constant of live target state t from live source state s.
struct AffineMs0Consts {
  int32_t cst[3][3];
};

struct AffineMs0 {
  using Consts = AffineMs0Consts;
  static constexpr int kStates = 3;
  __device__ static int32_t origin(int t) {
    return live_state(t) == kStateBoth ? 0 : NEG_INF;
  }

  // Live state t of row i (at `at` in the slabs d1, d2 of diagonals d-1
  // and d-2, whose states lie `stride` values apart); the shift arguments
  // are those of the tile's outer and are 0 here.
  __device__ __forceinline__ static int32_t outer(
      const int32_t* d1, const int32_t* d2, int stride, const Consts& cs,
      int32_t m1, int32_t m2, int t, int, int, int at, int i, int j, int,
      int) {
    const int q = live_state(t);
    const int a = bit_of(kX0, q), b = bit_of(kX1, q);
    if (i < a || j < b) return NEG_INF;
    const int32_t* p = (a + b == 2 ? d2 : d1) + at - a;
    const int32_t agg = max(max(p[0] + cs.cst[t][0],
                                p[stride] + cs.cst[t][1]),
                            p[2 * stride] + cs.cst[t][2]);
    return agg + bit_of(kAMu1, q) * m1 + bit_of(kAMu2, q) * m2;
  }

  // No str-only case is live at max_shift 0 (and no t-level calls this).
  __device__ __forceinline__ static int32_t inner(const int32_t*, int, int,
                                                  const Consts&, int32_t, int,
                                                  int, int, int, int, int) {
    return INVALID;
  }

  // The optimal score, from the slab of diagonal n+m: the max over the
  // three live states at row n.
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int, int n) {
    return max(slab[n], max(slab[P + n], slab[2 * P + n]));
  }
};

}  // namespace
}  // namespace bialign
