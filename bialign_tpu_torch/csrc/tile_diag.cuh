// One diagonal of one pair's recurrence, a tile of rows a CTA: the kernel
// of the single-pair fills K1 (affine) and K2 (non-affine), band and
// score-only, and of the low-memory path's K9-K12 (csrc/ckpt_diag.cuh); its
// device function `fill_tile` also serves the bucket kernels K4/K5
// (csrc/batch_diag.cuh) and K8 (csrc/conveyor.cuh), a pair's tile at a
// time.  Its per-value functions (`AffineTile`, `NonaffineTile`: outer and
// inner) also serve the one-CTA-a-pair kernel K6 (csrc/cta_scores.cuh),
// which reads its ring of slabs in shared memory in place.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_kernel with its slab update
// _make_update, and _nonaffine_kernel with _make_nonaffine_update (both
// launched by _affine_pallas / _nonaffine_pallas; K9-K12 by
// _affine_pallas_ckpt, _affine_pallas_block and their non-affine forms).
// Same recurrence, same int32 value on every genuine cell as the plain
// twins (bialign_tpu_torch/ops/cuda_dp.py): group A (9 full columns, one a
// source state), group C (seq-only half columns), group B (str-only half
// columns, within the diagonal in ascending t = sk + sl), the INVALID mask
// of a failed guard, INVALID -> NEG_INF, and the origin's values;
// non-affine, the 13 columns, the 3 str-only ones within the diagonal.
//
// Where the slabs live: `slabs` is slab 0 of the pair, P its rows per line,
// and diagonal d is slab d of a band [n+m+1, (9,) W, W, P] (kRing = false;
// also a block's window, whose base the caller moves back) or slab d % 3 of
// a ring [3, (9,) W, W, P] (kRing = true).  A line holds rows row0 ..
// row0 + P - 1, row i at i - row0: the whole pair (row0 = 0, P = n + 1), or
// one row shard of the sequence split with its halo row in front
// (csrc/seqsplit.cu).  A slab is addressed by one 64-bit base and 32-bit
// offsets inside it (the launcher refuses a slab of 2^31 values or more).
//
// Design, for an H100 (132 SMs, 227 KB of shared memory a CTA, 50 MB L2).
// One launch a diagonal; CTA x takes the R consecutive live rows from
// i0 = lo + x * R (R a compile-time function of max_shift; on the DNA-Pol-1
// pair, 929 rows at affine max_shift 1, that is 117 CTAs of 256 threads).
//  1. Stage.  The CTA copies rows [i0-1, i0+R-1] (clamped to [0, n]) of
//     slabs d-1 and d-2, every state and shift position, into shared
//     memory, rows fastest as in the slab, and the rows' mu1 values and
//     mu2 windows: asynchronous copies (cp.async), all issued before one
//     wait, so the stage costs one round trip to the L2.  A slab of a
//     diagonal below 0 is not read (band mode has none there).  Staged
//     rows off a diagonal's live range are never used:
//     a case's guard (i >= a, j >= b) makes its predecessor a live row of
//     its own diagonal, which a CTA of that launch wrote.
//  2. Groups A and C.  One thread a (state, shift position, row) value,
//     neighbouring threads on neighbouring rows.  Every source of a group
//     is loaded from the staged slabs at once, under the group's guard, then
//     the maxima are taken; the raw maximum (INVALID where every case was
//     guarded out) goes to a tile of diagonal d in shared memory.
//  3. Group B by t-levels.  For t = 1 .. 4S, after a barrier, the values of
//     level t take the max with their str-only cases, whose sources are
//     other states of the same row at lower t, read from the tile.
//  4. Store.  INVALID -> NEG_INF and one coalesced store of the tile's live
//     rows to slab d; rows off the live range are never written (in a band
//     they keep what the wrapper put there, in a ring diagonal d-3).
// The columns, sources and multiplicities are compiled in
// (csrc/recurrence.cuh); the constant terms (9 x 15 int32 affine, 13
// non-affine) come by value in the kernel's argument space.  max_shift 0-3
// are instantiated with W, the t-levels and the tile's size as constants;
// larger max_shifts run the same kernel with S read at run time and R = 1,
// as far as the tile fits a CTA's shared memory (max_shift 17 affine, 48
// non-affine), beyond which the launcher refuses.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; measured, PERF.md,
// Findings): the chain of one launch, from the staged loads through 4S + 2
// barriers to the store, about 4.4 us on the device whatever the rows
// (affine max_shift 1; 3.7 non-affine at 2), and the host's launch rate:
// the launches of a fill are 5.4 us apart, n+m+1 of them, so the device is
// busy little more than half of a fill.  The bytes a fill must move and
// the operations it must do are 60-250 times below the time.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_pipeline.h>

#include "common.cuh"
#include "recurrence.cuh"

namespace bialign {
namespace {

// The largest max_shift instantiated with compile-time sizes; above it the
// kernel reads S at run time.
constexpr int kStaticShifts = 3;

// Constant terms of the affine cases: cst[q] in iter_affine_cases order (9
// group A by source state, 3 group B, 3 group C), packed by
// bialign_tpu_torch/ops/cuda_dp.py affine_kernel_consts.
struct AffineConsts {
  int32_t cst[N_STATES][N_AFFINE_CASES];
};
// ... and of the 13 non-affine columns (nonaffine_kernel_consts).
struct NonaffineConsts {
  int32_t cst[N_NONAFFINE_CASES];
};

__device__ __forceinline__ int32_t unmask(int32_t v) {
  return v == INVALID ? NEG_INF : v;
}

// The affine recurrence's two phases for one value of a tile.
struct AffineTile {
  using Consts = AffineConsts;
  static constexpr int kStates = N_STATES;
  static constexpr int kThreads = 256;
  // rows of a CTA's tile: about 650-900 values at max_shift 0-3
  __host__ __device__ static constexpr int rows(int kS) {
    return kS == 0 ? 32 : kS == 1 ? 8 : kS == 2 ? 4 : kS == 3 ? 2 : 1;
  }
  __device__ static int32_t origin(int q) {
    return q == kStateBoth ? 0 : NEG_INF;
  }

  // Groups A and C of state q at shift position (sk, sl) of row i: `d1`
  // and `d2` are the slabs of diagonals d-1 and d-2 as the caller holds
  // them (staged rows of a tile, or a ring's slabs in place), `stride` the
  // values between two shift positions there (a state is W*W strides), and
  // row i lies at `at` in them.
  __device__ __forceinline__ static int32_t outer(
      const int32_t* d1, const int32_t* d2, int stride, const Consts& cs,
      int32_t m1, int32_t m2, int q, int sk, int sl, int at, int i, int j,
      int S, int W) {
    const int a = bit_of(kX0, q), b = bit_of(kX1, q);
    const int c = bit_of(kX2, q), e = bit_of(kX3, q);
    const int k = i + sk - S, l = j + sl - S;
    const int lane = W * W * stride;       // values between two states
    // diagonal d-a-b, row i-a
    const int32_t* pred = (a + b == 2 ? d2 : d1) + at - a;
    int32_t best = INVALID;
    {  // group A: column (a, b, c, e) from all 9 sources
       // (pallas_dp.py:208-226)
      const int psk = sk - c + a, psl = sl - e + b;
      if (i >= a && j >= b && k >= c && l >= e && psk >= 0 && psk < W &&
          psl >= 0 && psl < W) {
        const int32_t* p = pred + (psk * W + psl) * stride;
        int32_t v[N_STATES];
#pragma unroll
        for (int s = 0; s < N_STATES; ++s) v[s] = p[s * lane];
        int32_t agg = v[0] + cs.cst[q][0];
#pragma unroll
        for (int s = 1; s < N_STATES; ++s) agg = max(agg, v[s] + cs.cst[q][s]);
        best = agg + bit_of(kAMu1, q) * m1 + bit_of(kAMu2, q) * m2;
      }
    }
    {  // group C: column (a, b, 0, 0) (pallas_dp.py:228-240)
      const int psk = sk + a, psl = sl + b;
      if (i >= a && j >= b && psk < W && psl < W) {
        const int32_t* p = pred + (psk * W + psl) * stride;
        const int32_t v0 = p[nibble_of(kC0, q) * lane];
        const int32_t v1 = p[nibble_of(kC1, q) * lane];
        const int32_t v2 = p[nibble_of(kC2, q) * lane];
        const int32_t agg = max(max(v0 + cs.cst[q][FIRST_C],
                                    v1 + cs.cst[q][FIRST_C + 1]),
                                v2 + cs.cst[q][FIRST_C + 2]);
        best = max(best, agg + bit_of(kCMu1, q) * m1);
      }
    }
    return best;
  }

  // Group B of state q at (sk, sl): the str-only column (0, 0, c, e) from
  // this diagonal at position (sk-c, sl-e), which lies at a lower t;
  // `tile` points at this row of diagonal d, state 0, position (0, 0) (in
  // a tile, or in place in a ring), `R` is the values between two
  // positions there, `plane` between two states.  INVALID if guarded out.
  __device__ __forceinline__ static int32_t inner(
      const int32_t* tile, int plane, int R, const Consts& cs, int32_t m2,
      int q, int sk, int sl, int k, int l, int W) {
    const int c = bit_of(kX2, q), e = bit_of(kX3, q);
    if (!(sk >= c && sl >= e && k >= c && l >= e)) return INVALID;
    const int32_t* p = tile + ((sk - c) * W + (sl - e)) * R;
    const int32_t v0 = unmask(p[nibble_of(kB0, q) * plane]);
    const int32_t v1 = unmask(p[nibble_of(kB1, q) * plane]);
    const int32_t v2 = unmask(p[nibble_of(kB2, q) * plane]);
    const int32_t agg = max(max(v0 + cs.cst[q][FIRST_B],
                                v1 + cs.cst[q][FIRST_B + 1]),
                            v2 + cs.cst[q][FIRST_B + 2]);
    return agg + bit_of(kBMu2, q) * m2;  // (pallas_dp.py:270-299)
  }

  // The optimal score from the slab of diagonal n+m (P rows a line): the
  // max over the 9 states at (S, S, n).
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int S, int n) {
    const int W = 2 * S + 1;
    const int centre = (S * W + S) * P + n;
    int32_t best = slab[centre];
    for (int q = 1; q < N_STATES; ++q)
      best = max(best, slab[q * W * W * P + centre]);
    return best;
  }
};

// The non-affine recurrence's two phases for one value of a tile (q = 0).
struct NonaffineTile {
  using Consts = NonaffineConsts;
  static constexpr int kStates = 1;
  static constexpr int kThreads = 128;
  __host__ __device__ static constexpr int rows(int kS) {
    return kS == 0 ? 128 : kS == 1 ? 16 : kS == 2 ? 8 : kS == 3 ? 4 : 1;
  }
  __device__ static int32_t origin(int) { return 0; }  // pyx:464-465

  // The 10 columns that advance a sequence, from diagonals d-1 and d-2
  // (arguments as AffineTile::outer).
  __device__ __forceinline__ static int32_t outer(
      const int32_t* d1, const int32_t* d2, int stride, const Consts& cs,
      int32_t m1, int32_t m2, int, int sk, int sl, int at, int i, int j,
      int S, int W) {
    const int k = i + sk - S, l = j + sl - S;
    int32_t best = INVALID;
#pragma unroll
    for (int ci = 0; ci < N_NONAFFINE_CASES; ++ci) {
      const int x0 = bit_of(kN0, ci), x1 = bit_of(kN1, ci);
      const int x2 = bit_of(kN2, ci), x3 = bit_of(kN3, ci);
      if (x0 + x1 == 0) continue;
      const int psk = sk - x2 + x0, psl = sl - x3 + x1;
      if (i >= x0 && j >= x1 && k >= x2 && l >= x3 && psk >= 0 && psk < W &&
          psl >= 0 && psl < W) {
        const int32_t* p = x0 + x1 == 2 ? d2 : d1;
        const int32_t pred = p[(psk * W + psl) * stride + at - x0];
        best = max(best, pred + cs.cst[ci] + bit_of(kNMu1, ci) * m1 +
                             bit_of(kNMu2, ci) * m2);
      }
    }
    return best;
  }

  // The 3 str-only columns (0, 0, x2, x3), from this diagonal.
  __device__ __forceinline__ static int32_t inner(
      const int32_t* tile, int, int R, const Consts& cs, int32_t m2, int,
      int sk, int sl, int k, int l, int W) {
    int32_t best = INVALID;
#pragma unroll
    for (int ci = 0; ci < N_NONAFFINE_CASES; ++ci) {
      const int x2 = bit_of(kN2, ci), x3 = bit_of(kN3, ci);
      if (bit_of(kN0, ci) + bit_of(kN1, ci) != 0) continue;
      if (k >= x2 && l >= x3 && sk >= x2 && sl >= x3) {
        const int32_t pred = unmask(tile[((sk - x2) * W + (sl - x3)) * R]);
        best = max(best, pred + cs.cst[ci] + bit_of(kNMu2, ci) * m2);
      }
    }
    return best;
  }

  // The optimal score from the slab of diagonal n+m: the value at (S, S, n).
  __device__ __forceinline__ static int32_t score(const int32_t* slab, int P,
                                                  int S, int n) {
    const int W = 2 * S + 1;
    return slab[(S * W + S) * P + n];
  }
};

// Rows i0..i1 (at most R of them, all live on diagonal d) of one pair's
// diagonal d, by the whole CTA.  `smem`: tile_geometry<Tile>(S).bytes of
// shared memory.  `mu1`, `mu2`: the pair's tables, rows `ld` apart (the
// pair's own or its plane of a bucket's stack).  The slabs' lines hold rows
// row0 .. row0 + P - 1; rows i0 - 1 .. i1 must lie among them.
template <class Tile, int kS, bool kRing>
__device__ __forceinline__ void fill_tile(
    int32_t* smem, int32_t* slabs, const int32_t* __restrict__ mu1,
    const int32_t* __restrict__ mu2, const typename Tile::Consts& cs, int n,
    int m, int ld, int P, int row0, int S_arg, int d, int i0, int i1) {
  constexpr int R = Tile::rows(kS);
  constexpr int R1 = R + 1;
  const int S = kS >= 0 ? kS : S_arg;
  const int W = 2 * S + 1, W2 = W * W;
  const int cells = Tile::kStates * W2;
  const int plane = W2 * R;              // tile values between two states
  int32_t* prev = smem;                  // [2][cells][R1]: d-1, d-2
  int32_t* tile = prev + 2 * cells * R1;  // [cells][R]
  int32_t* m2s = tile + cells * R;       // [W2][R]
  int32_t* m1s = m2s + W2 * R;           // [R]
  const size_t slab = static_cast<size_t>(cells) * P;
  const int top = i0 - 1;
  const int last = min(n, i1);           // rows read above i0-1: <= i1

  // 1. stage: asynchronous copies, all in flight at once, one wait
  for (int x = threadIdx.x; x < 2 * cells * R1; x += Tile::kThreads) {
    const int lr = x % R1, rest = x / R1;
    const int back = rest / cells, cell = rest - back * cells;
    const int row = top + lr;
    const int dd = d - 1 - back;
    if (dd >= 0 && row >= 0 && row <= last)
      __pipeline_memcpy_async(prev + x,
                              slabs + slab_of<kRing>(dd) * slab +
                                  static_cast<unsigned>(cell * P + row -
                                                        row0),
                              sizeof(int32_t));
  }
  for (int x = threadIdx.x; x < W2 * R; x += Tile::kThreads) {
    const int r = x % R, pos = x / R;
    const int i = i0 + r;
    const int sk = pos / W, sl = pos - sk * W;
    const int k = i + sk - S, l = d - i + sl - S;
    if (i > i1) continue;
    if (k >= 0 && k <= n && l >= 0 && l <= m)     // else 0 (common.cuh)
      __pipeline_memcpy_async(m2s + x, mu2 + (long long)k * ld + l,
                              sizeof(int32_t));
    else
      m2s[x] = 0;
  }
  for (int r = threadIdx.x; r < R; r += Tile::kThreads)
    if (i0 + r <= i1)
      __pipeline_memcpy_async(m1s + r, mu1 + (long long)(i0 + r) * ld + d -
                                           i0 - r, sizeof(int32_t));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. groups A and C (and the origin's values)
  for (int x = threadIdx.x; x < cells * R; x += Tile::kThreads) {
    const int r = x % R, cell = x / R;
    const int i = i0 + r;
    if (i > i1) continue;
    const int q = cell / W2, pos = cell - q * W2;
    const int sk = pos / W, sl = pos - sk * W;
    const int j = d - i;
    int32_t v = Tile::outer(prev, prev + cells * R1, R1, cs, m1s[r],
                            m2s[pos * R + r], q, sk, sl, r + 1, i, j, S, W);
    if (d == 0 && i == 0 && sk == S && sl == S) v = Tile::origin(q);
    tile[x] = v;
  }

  // 3. group B, level by level (at the origin every str-only case is
  //    guarded out: k = l = 0 there, so its values stand)
  for (int t = 1; t <= 4 * S; ++t) {
    __syncthreads();
    const int sk0 = max(0, t - 2 * S);
    const int level = (min(2 * S, t) - sk0 + 1) * Tile::kStates * R;
    for (int x = threadIdx.x; x < level; x += Tile::kThreads) {
      const int r = x % R, y = x / R;
      const int i = i0 + r;
      if (i > i1) continue;
      const int q = y % Tile::kStates;
      const int sk = sk0 + y / Tile::kStates, sl = t - sk;
      const int j = d - i;
      const int pos = sk * W + sl;
      const int32_t v = Tile::inner(tile + r, plane, R, cs, m2s[pos * R + r],
                                    q, sk, sl, i + sk - S, j + sl - S, W);
      int32_t& here = tile[(q * W2 + pos) * R + r];
      here = max(here, v);
    }
  }
  __syncthreads();

  // 4. store the live rows to slab d
  int32_t* out = slabs + slab_of<kRing>(d) * slab;
  for (int x = threadIdx.x; x < cells * R; x += Tile::kThreads) {
    const int r = x % R, cell = x / R;
    if (i0 + r <= i1)
      out[static_cast<unsigned>(cell * P + i0 + r - row0)] = unmask(tile[x]);
  }
}

// Rows lo..hi of diagonal d, R a CTA, on slabs whose lines hold rows row0 ..
// row0 + P - 1.
template <class Tile, int kS, bool kRing>
__global__ void __launch_bounds__(Tile::kThreads)
    tile_diag(int32_t* slabs, const int32_t* __restrict__ mu1,
              const int32_t* __restrict__ mu2,
              const __grid_constant__ typename Tile::Consts cs, int n, int m,
              int S, int d, int lo, int hi, int P, int row0) {
  extern __shared__ int32_t smem[];
  constexpr int R = Tile::rows(kS);
  const int i0 = lo + blockIdx.x * R;
  fill_tile<Tile, kS, kRing>(smem, slabs, mu1, mu2, cs, n, m, m + 1, P, row0,
                             S, d, i0, min(hi, i0 + R - 1));
}

// The one geometry of a launch: rows a CTA, threads, shared bytes.
struct TileGeometry {
  int rows, threads;
  size_t bytes;
};

template <class Tile>
TileGeometry tile_geometry(int S) {
  const int R = Tile::rows(S <= kStaticShifts ? S : -1);
  const size_t W2 = static_cast<size_t>(2 * S + 1) * (2 * S + 1);
  const size_t cells = Tile::kStates * W2;
  return {R, Tile::kThreads,
          sizeof(int32_t) * (cells * (3 * R + 2) + W2 * R + R)};
}

// int32 values of one slab of P rows at max_shift S
template <class Tile>
__host__ __device__ size_t slab_values(int P, int S) {
  return static_cast<size_t>(Tile::kStates) * (2 * S + 1) * (2 * S + 1) * P;
}

// Shared memory one CTA can have on an H100, and the most without opting in.
constexpr size_t kSharedLimit = 232448;
constexpr size_t kSharedDefault = 48 * 1024;

// Before a tile kernel's first launch: refuses a tile beyond one CTA's
// shared memory and a slab of 2^31 values or more (32-bit offsets inside a
// slab), and opts the kernel in to more than the default shared memory.
template <class Kernel>
cudaError_t tile_ready(Kernel kernel, const TileGeometry& g, size_t slab) {
  if (g.bytes > kSharedLimit || slab >= (size_t{1} << 31))
    return cudaErrorInvalidValue;
  if (g.bytes > kSharedDefault)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(g.bytes));
  return cudaSuccess;
}

// f(std::integral_constant<int, kS>{}) with the instantiation of max_shift
// S: kS = S for 0-3, kS = -1 (S read at run time) above.
template <class F>
auto with_shift(int S, F&& f) {
  static_assert(kStaticShifts == 3, "one case per instantiated max_shift");
  switch (S) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, -1>{});
  }
}

// Rows lo..hi (lo <= hi) of one pair's diagonal d, on slabs of lines of P
// rows from row0.
template <class Tile, bool kRing>
cudaError_t launch_rows(int32_t* slabs, const int32_t* mu1,
                        const int32_t* mu2, const typename Tile::Consts& cs,
                        int n, int m, int S, int d, int lo, int hi, int P,
                        int row0, cudaStream_t st) {
  return with_shift(S, [&](auto shift) {
    const auto kernel = tile_diag<Tile, decltype(shift)::value, kRing>;
    const TileGeometry g = tile_geometry<Tile>(S);
    const cudaError_t err = tile_ready(kernel, g, slab_values<Tile>(P, S));
    if (err != cudaSuccess) return err;
    kernel<<<(hi - lo + g.rows) / g.rows, g.threads, g.bytes, st>>>(
        slabs, mu1, mu2, cs, n, m, S, d, lo, hi, P, row0);
    return cudaGetLastError();
  });
}

// Diagonal d of one pair, its slabs' lines the whole pair's n + 1 rows.
template <class Tile, bool kRing>
cudaError_t launch_diagonal(int32_t* slabs, const int32_t* mu1,
                            const int32_t* mu2,
                            const typename Tile::Consts& cs, int n, int m,
                            int S, int d, cudaStream_t st) {
  return launch_rows<Tile, kRing>(slabs, mu1, mu2, cs, n, m, S, d,
                                  std::max(0, d - m), std::min(n, d), n + 1,
                                  0, st);
}

// The constant terms as the host passed them, one int32 array.
template <class Tile>
typename Tile::Consts consts_from(const int32_t* host) {
  typename Tile::Consts cs;
  std::memcpy(&cs, host, sizeof cs);
  return cs;
}

// Runs diagonals 0..n+m on `stream`, one launch each; `consts` (host
// memory) are the case constants.  Returns 0, or the first CUDA error as a
// cudaError_t value.
template <class Tile, bool kRing>
int run_diagonals(int32_t* slabs, const int32_t* mu1, const int32_t* mu2,
                  const int32_t* consts, int n, int m, int S, int device,
                  void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  for (int d = 0; d <= n + m; ++d)
    BIALIGN_TRY((launch_diagonal<Tile, kRing>(slabs, mu1, mu2, cs, n, m, S,
                                              d, st)));
  return 0;
}

}  // namespace
}  // namespace bialign
