// The constants of the recurrence that do not depend on the costs, compiled
// into the tile kernels of csrc/tile_diag.cuh: the affine states, the
// sources of each target state's half-column cases and the cases' mu1/mu2
// multiplicities, and the 13 non-affine columns.  The order is the one of
// bialign_tpu_torch/ops/cases.py (STATES, iter_affine_cases, NONAFFINE_COLS);
// tests/test_torch_kernel_consts.py reads the tables below from this file
// and holds them to the JAX package's bialign_tpu/ops/cases.py.  Only the
// constant term of a case depends on the costs (beta, gamma, delta); it
// reaches the kernels by value (AffineConsts, NonaffineConsts).
//
// The kernels index the tables with a target state that is known only at
// run time, so each column of a table is also packed into one scalar word
// (a bit or a 4-bit field per entry) that device code can shift and mask.
#pragma once

#include <cstdint>

namespace bialign {

// The 9 affine states (x0, x1, x2, x3), in STATES order.
constexpr int kStateCol[9][4] = {
    {0, 1, 0, 1}, {0, 1, 1, 0}, {0, 1, 1, 1}, {1, 0, 0, 1}, {1, 0, 1, 0},
    {1, 0, 1, 1}, {1, 1, 0, 1}, {1, 1, 1, 0}, {1, 1, 1, 1}};
constexpr int kStateBoth = 8;     // (1, 1, 1, 1): 0 at the origin

// Group B of target state q = (a, b, c, e): the str-only column (0, 0, c, e)
// from the states (a, b, h0, h1), (h0, h1) in HALF_STATES order.
constexpr int kBSrc[9][3] = {{2, 1, 0}, {2, 1, 0}, {2, 1, 0},
                             {5, 4, 3}, {5, 4, 3}, {5, 4, 3},
                             {8, 7, 6}, {8, 7, 6}, {8, 7, 6}};
// Group C: the seq-only column (a, b, 0, 0) from the states (h0, h1, c, e).
constexpr int kCSrc[9][3] = {{6, 3, 0}, {7, 4, 1}, {8, 5, 2},
                             {6, 3, 0}, {7, 4, 1}, {8, 5, 2},
                             {6, 3, 0}, {7, 4, 1}, {8, 5, 2}};
// Multiplicities of target state q's cases: (group A mu1, group A mu2,
// group B mu2, group C mu1); the other two of B and C are 0.
constexpr int kAffineMu[9][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}, {0, 1, 1, 0},
                                 {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 1, 1, 0},
                                 {1, 0, 0, 1}, {1, 0, 0, 1}, {1, 1, 1, 1}};

// The 13 non-affine columns, in NONAFFINE_COLS order, and their (mu1, mu2)
// multiplicities.
constexpr int kNonaffineCol[13][4] = {
    {1, 1, 1, 1}, {1, 0, 1, 0}, {0, 1, 0, 1}, {1, 1, 0, 0}, {0, 0, 1, 1},
    {1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}, {1, 0, 1, 1},
    {0, 1, 1, 1}, {1, 1, 1, 0}, {1, 1, 0, 1}};
constexpr int kNonaffineMu[13][2] = {
    {1, 1}, {0, 0}, {0, 0}, {1, 0}, {0, 1}, {0, 0}, {0, 0},
    {0, 0}, {0, 0}, {0, 1}, {0, 1}, {1, 0}, {1, 0}};

// -- the tables as scalar words ---------------------------------------------

template <int N, int K>
constexpr uint64_t pack_bits(const int (&t)[N][K], int col) {
  uint64_t w = 0;
  for (int x = 0; x < N; ++x) w |= uint64_t(t[x][col] & 1) << x;
  return w;
}

template <int N, int K>
constexpr uint64_t pack_nibbles(const int (&t)[N][K], int col) {
  uint64_t w = 0;
  for (int x = 0; x < N; ++x) w |= uint64_t(t[x][col] & 15) << (4 * x);
  return w;
}

constexpr uint64_t kX0 = pack_bits(kStateCol, 0),
                   kX1 = pack_bits(kStateCol, 1),
                   kX2 = pack_bits(kStateCol, 2),
                   kX3 = pack_bits(kStateCol, 3);
constexpr uint64_t kB0 = pack_nibbles(kBSrc, 0), kB1 = pack_nibbles(kBSrc, 1),
                   kB2 = pack_nibbles(kBSrc, 2);
constexpr uint64_t kC0 = pack_nibbles(kCSrc, 0), kC1 = pack_nibbles(kCSrc, 1),
                   kC2 = pack_nibbles(kCSrc, 2);
constexpr uint64_t kAMu1 = pack_bits(kAffineMu, 0),
                   kAMu2 = pack_bits(kAffineMu, 1),
                   kBMu2 = pack_bits(kAffineMu, 2),
                   kCMu1 = pack_bits(kAffineMu, 3);
constexpr uint64_t kN0 = pack_bits(kNonaffineCol, 0),
                   kN1 = pack_bits(kNonaffineCol, 1),
                   kN2 = pack_bits(kNonaffineCol, 2),
                   kN3 = pack_bits(kNonaffineCol, 3);
constexpr uint64_t kNMu1 = pack_bits(kNonaffineMu, 0),
                   kNMu2 = pack_bits(kNonaffineMu, 1);

__device__ __forceinline__ int bit_of(uint64_t word, int x) {
  return static_cast<int>((word >> x) & 1u);
}
__device__ __forceinline__ int nibble_of(uint64_t word, int x) {
  return static_cast<int>((word >> (4 * x)) & 15u);
}

}  // namespace bialign
