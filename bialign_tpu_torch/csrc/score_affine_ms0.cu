// Affine score of one pair at max_shift 0 (K3), by three routes.
//
// Replaces bialign_tpu/ops/pallas_dp.py:_affine_ms0_kernel with its slab
// update _make_update_ms0, launched by _affine_pallas_ms0.  The recurrence
// (three live states, one predecessor cell each) is `AffineMs0` of
// csrc/affine_ms0_diag.cuh, which K7 (csrc/cta_scores_ms0.cu) shares.
//
// * One CTA (`bialign_score_affine_ms0`): K7's kernel `cta_ms0` of
//   csrc/cta_scores.cuh at B = 1 on the pair's own tables, the ring in
//   shared memory and the diagonal loop inside the kernel, one launch.  It
//   takes a pair of up to 4096 rows (n <= 4095), what one CTA holds.
// * One cooperative grid (`bialign_score_affine_ms0_resident`), for the
//   pairs beyond: `cta_ms0<kRows, true>`, G CTAs in one launch, CTA g the
//   rows [g R, (g+1) R), R = ceil((n+1) / G), each in a ring of its own in
//   shared memory with the row above as a halo, which comes through device
//   memory, `halo` [G-1, n+m+1, 3], under a progress flag a CTA
//   (csrc/neighbour_flags.cuh; the design is stated at the kernel).  A CTA
//   waits only for the one above; once the pipeline is full a diagonal is
//   one CTA's rows, a row a thread, and its barrier.  A grid the card
//   cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge),
//   not cut down.  It also takes the pairs from 1024 rows up to the 4096
//   one CTA holds, where it measured faster than one CTA (NVIDIA H100 80GB
//   HBM3, 700 W; chip_smoke.py --resident-only; PERF.md, Findings): 0.76
//   us a diagonal at 4096 x 4090 (129 CTAs of 32 rows) and 0.69 at 8192 x
//   8180, against one CTA's 2.36 at 4000 x 3990 and the per-diagonal
//   route's 3.0-3.4; the byte bound is ~160x below.
// * One launch a diagonal (`bialign_score_affine_ms0_grid`), on the ring in
//   device memory, taken only when forced: one thread a (live state, row)
//   value, rows fastest, the tables read where a value needs them.  The
//   time is then the n+m+1 launches themselves, the host's launch rate.
// bialign_tpu_torch/ops/cuda_dp.py affine_ms0_last_slab picks the route by
// the pair's rows (cuda_dp.batch_route at B = 1: one CTA below 1024 rows,
// "resident" from there) and raises for a forced one-CTA route that does
// not fit.  Each leaves the ring argument as the
// others do, the last diagonal in slab (n+m) % 3.  Not carried over from
// the TPU kernel: the chunk of diagonals per grid step, the bucketed
// diagonal count, the d_last scalar prefetch, the 128-lane padding, and the
// padding of the output back to nine states: the wrapper returns the max of
// the three states at row n.

#include <algorithm>
#include <cstring>

#include "affine_ms0_diag.cuh"
#include "cta_scores.cuh"

namespace bialign {
namespace {

constexpr int kMs0Block = 128;   // threads of a per-diagonal launch

// Diagonal d of the pair's ring [3, 3, n+1]: values t * L + r, live row
// lo + r of L.
__global__ void __launch_bounds__(kMs0Block)
    affine_ms0_diag(int32_t* ring, const int32_t* __restrict__ mu1,
                    const int32_t* __restrict__ mu2,
                    const __grid_constant__ AffineMs0Consts cs, int n, int m,
                    int d, int lo, int L) {
  const int x = blockIdx.x * kMs0Block + threadIdx.x;
  if (x >= AffineMs0::kStates * L) return;
  const int t = x / L, i = lo + x % L, j = d - i;
  const size_t slab = static_cast<size_t>(AffineMs0::kStates) * (n + 1);
  const long long at = static_cast<long long>(i) * (m + 1) + j;
  int32_t v = AffineMs0::outer(ring + slab_of<true>(d - 1) * slab,
                               ring + slab_of<true>(d - 2) * slab, n + 1, cs,
                               mu1[at], mu2[at], t, 0, 0, i, i, j, 0, 1);
  if (d == 0) v = AffineMs0::origin(t);          // the one row, i = 0
  ring[slab_of<true>(d) * slab + static_cast<size_t>(t) * (n + 1) + i] = v;
}

// Diagonals 0..n+m over the ring [3, 3, n+1] (any contents) on `stream`,
// one launch each; the last diagonal is left in slab (n+m) % 3.  `consts`
// (host memory) are the case constants.  Returns 0, or the first launch
// error as a cudaError_t value.
inline int run_ms0_diagonals(int32_t* ring, const int32_t* mu1,
                             const int32_t* mu2, const int32_t* consts,
                             int n, int m, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  AffineMs0Consts cs;
  std::memcpy(&cs, consts, sizeof cs);
  for (int d = 0; d <= n + m; ++d) {
    const int lo = std::max(0, d - m);
    const int L = std::min(n, d) - lo + 1;
    const int blocks = (AffineMs0::kStates * L + kMs0Block - 1) / kMs0Block;
    affine_ms0_diag<<<blocks, kMs0Block, 0, st>>>(ring, mu1, mu2, cs, n, m,
                                                  d, lo, L);
    BIALIGN_TRY(cudaGetLastError());
  }
  return 0;
}

// Diagonals 0..n+m over the ring [3, 3, n+1] (any contents) on `stream`
// in one cooperative launch of `ctas` CTAs, each ceil((n+1) / ctas) rows
// on `threads` threads (0: a row a thread in whole warps and two warps
// more, whose last threads copy and publish the halo, up to
// kCtaMaxThreads; a thread takes up to kMs0RowsPerThread rows); `halo`
// [ctas-1, n+m+1, 3] (any contents) and `flags` [ctas] (zeroed on `stream`
// before the call) in device memory; `fault` the fault word (pinned host
// memory) or null.
// The ring is left as the other routes leave it: each CTA copies its rows
// in and back.  Returns 0, or the first error as a cudaError_t value
// (cudaErrorInvalidValue for more rows a CTA than it holds,
// cudaErrorCooperativeLaunchTooLarge for a grid the card cannot hold,
// which is then not left behind as the runtime's last error).
inline int run_resident_ms0(int32_t* ring, const int32_t* mu1,
                            const int32_t* mu2, const int32_t* consts, int n,
                            int m, int ctas, int threads, int32_t* halo,
                            int32_t* flags, int32_t* fault, int device,
                            void* stream) {
  if (n < 0 || m < 0 || ctas < 1 || threads < 0 ||
      threads > kCtaMaxThreads || ring == nullptr || flags == nullptr ||
      (ctas > 1 && halo == nullptr))
    return cudaErrorInvalidValue;
  BIALIGN_TRY(cudaSetDevice(device));
  AffineMs0Consts cs;
  std::memcpy(&cs, consts, sizeof cs);
  Ms0Link link{(n + ctas) / ctas, halo, flags, nullptr};   // ceil
  if (threads == 0)    // a row a thread, and two warps for the halo
    threads = std::min(kCtaMaxThreads, (link.rows + 31) / 32 * 32 + 64);
  const int rows = (link.rows + threads - 1) / threads;   // a thread's
  if (rows > kMs0RowsPerThread) return cudaErrorInvalidValue;
  if (fault != nullptr) {
    void* mapped = nullptr;
    BIALIGN_TRY(cudaHostGetDevicePointer(&mapped, fault, 0));
    link.fault = static_cast<int32_t*>(mapped);
  }
  const size_t bytes =   // the ring [3, 3, rows+1], the halo's rows [2, 3]
      (static_cast<size_t>(RING) * (link.rows + 1) + 2) *
      AffineMs0::kStates * sizeof(int32_t);
  int32_t* out = nullptr;
  const int32_t* lengths = nullptr;
  int B = 1;
  auto launch = [&](auto kernel) {
    BIALIGN_TRY(tile_ready(kernel, TileGeometry{1, threads, bytes}, 0));
    void* params[] = {&ring, &out, &mu1, &mu2, &lengths, &lengths, &cs,
                      &B, &n, &m, &link};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(ctas), dim3(threads), params, bytes,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) cudaGetLastError();   // not left behind
    return static_cast<int>(err);
  };
  static_assert(kMs0RowsPerThread == 4, "one instantiation a row count");
  return rows == 1   ? launch(cta_ms0<1, true>)
         : rows == 2 ? launch(cta_ms0<2, true>)
                     : launch(cta_ms0<4, true>);
}

}  // namespace
}  // namespace bialign

// Runs the recurrence on `stream` in one CTA, the ring [3, 3, n+1] (any
// contents) copied into shared memory and back; the last diagonal is left
// in slab (n+m) % 3.  `consts` (host memory): the constants [3, 3].
// Returns 0, or the first error as a cudaError_t value
// (cudaErrorInvalidValue for a pair of more than 4096 rows).
extern "C" int bialign_score_affine_ms0(int32_t* ring, const int32_t* mu1,
                                        const int32_t* mu2,
                                        const int32_t* consts, int n, int m,
                                        int device, void* stream) {
  return bialign::run_cta_ms0(ring, nullptr, mu1, mu2, nullptr, nullptr,
                              consts, 1, n, m, 0, device, stream);
}

// The same on route "resident": one cooperative launch of `ctas` CTAs of
// `threads` threads (0 for the default), with the halo memory [ctas-1,
// n+m+1, 3] and the flags [ctas] (zeroed) in device memory and the fault
// word (pinned host memory, or null), as run_resident_ms0 takes them.
extern "C" int bialign_score_affine_ms0_resident(
    int32_t* ring, const int32_t* mu1, const int32_t* mu2,
    const int32_t* consts, int n, int m, int ctas, int threads,
    int32_t* halo, int32_t* flags, int32_t* fault, int device,
    void* stream) {
  return bialign::run_resident_ms0(ring, mu1, mu2, consts, n, m, ctas,
                                   threads, halo, flags, fault, device,
                                   stream);
}

// The same, one launch a diagonal over the ring in device memory.
extern "C" int bialign_score_affine_ms0_grid(int32_t* ring,
                                             const int32_t* mu1,
                                             const int32_t* mu2,
                                             const int32_t* consts, int n,
                                             int m, int device,
                                             void* stream) {
  return bialign::run_ms0_diagonals(ring, mu1, mu2, consts, n, m, device,
                                    stream);
}
