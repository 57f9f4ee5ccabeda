// Definitions shared by the CUDA kernels of bialign_tpu_torch.
//
// All DP values are int32.  The host checks int32 safety first
// (bialign_tpu_torch/ops/cases.py check_int32_safe), so no sum below can
// wrap.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bialign {

// The reference's -infinity (bialign_tpu/ops/cases.py NEG_INF) and the
// masked-case sentinel (bialign_tpu/ops/xla_dp.py INVALID).
constexpr int32_t NEG_INF = -(1 << 30);
constexpr int32_t INVALID = -(1 << 30) - (1 << 29);

constexpr int N_STATES = 9;
constexpr int N_AFFINE_CASES = 15;     // per target state: 9 A, 3 B, 3 C
constexpr int N_NONAFFINE_CASES = 13;
constexpr int FIRST_B = 9;             // affine case order of iter_affine_cases
constexpr int FIRST_C = 12;

// One recursion case is REC int32 values, packed by
// bialign_tpu_torch/ops/cuda_dp.py (affine_case_table, nonaffine_case_table):
// source state, column (x0, x1, x2, x3), mu1/mu2 multiplicities, the
// constant gap/shift term, and the source state's intrinsic shifts
// (s0 - s2, s1 - s3) for the walk's tie-break key.
enum Field { SRC = 0, X0, X1, X2, X3, MU1C, MU2C, CST, SRCA, SRCB, REC };

// Offset of band cell (d, q, sk, sl, i) in the layout [D, nq, W, W, P]
// (nq = 9 affine, 1 non-affine), in 64 bits, for the row functions and the
// walks.  Rows are last, so the threads of a warp, which hold neighbouring
// rows, touch neighbouring addresses.  The tile kernels
// (csrc/tile_diag.cuh) take one 64-bit base a slab and 32-bit offsets
// inside it instead.
__device__ __forceinline__ long long cell_offset(int d, int q, int sk, int sl,
                                                 int i, int nq, int W, int P) {
  return ((((long long)d * nq + q) * W + sk) * W + sl) * P + i;
}

// Where diagonal d lives: slab d of a band [n+m+1, ...], or slab d % RING of
// the ring [RING, ...] that the score-only kernels carry (d >= -2: the
// slab of a guarded-out predecessor of diagonals 0 and 1 is computed, never
// read).
constexpr int RING = 3;
template <bool kRing>
__device__ __forceinline__ int slab_of(int d) {
  return kRing ? (d + RING) % RING : d;
}

// mu1/mu2 are dense tables whose rows are `ld` values apart: [n+1, m+1]
// with ld = m+1 for one pair, or one pair's [N+1, M+1] plane of a bucket's
// zero-padded stack with ld = M+1.  A (k, l) outside the pair's own
// [0, n] x [0, m] scores 0, as in the diagonal tables of the JAX engines
// (xla_dp._diag_mu_tables) and as the stack's padding reads.
__device__ __forceinline__ int32_t mu_at(const int32_t* mu, int k, int l,
                                         int n, int m, int ld) {
  return (k >= 0 && k <= n && l >= 0 && l <= m) ? mu[(long long)k * ld + l]
                                                : 0;
}

// Threads of a block of the kernels that run one thread a row (the row
// functions of csrc/affine_diag.cuh and csrc/nonaffine_diag.cuh under the
// bucket kernels K4-K8, and K3): a block holds 128 consecutive rows of a
// diagonal, or walks a pair's rows in strides of 128 (one CTA a pair).
// The single-pair fills K1, K2 and K9-K12 size their CTAs by the tile of
// csrc/tile_diag.cuh instead (`tile_geometry`).
constexpr int kRowBlock = 128;

// Copies a packed case table into a block's shared memory; every thread of
// the block calls it (the kernels that run one thread a row; the tile
// kernels take their constants by value and compile the rest in).
__device__ __forceinline__ void load_table(int32_t* tab,
                                           const int32_t* __restrict__ cases,
                                           int count) {
  for (int x = threadIdx.x; x < count; x += blockDim.x) tab[x] = cases[x];
  __syncthreads();
}

// The kernels' launchers return 0 or the first CUDA error as an int.
#define BIALIGN_TRY(call)                                   \
  do {                                                      \
    const cudaError_t err_ = (call);                        \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace bialign
