// Host loops of the checkpointed low-memory path: the score-only fill that
// also saves the two slabs entering every block of C diagonals (K9, K11),
// and the band-mode fill of one block into a window, from its checkpoint
// (K10, K12).  Both launch the per-diagonal kernels of csrc/affine_diag.cuh
// and csrc/nonaffine_diag.cuh as they are, so the recurrence stays the one
// `Affine::row` / `Nonaffine::row` that every other kernel instantiates.
//
// Replaces, in bialign_tpu/ops/pallas_dp.py: _affine_ckpt_kernel and
// _nonaffine_ckpt_kernel (launched by _affine_pallas_ckpt and
// _nonaffine_pallas_ckpt), _affine_block_kernel and _nonaffine_block_kernel
// (launched by _affine_pallas_block and _nonaffine_pallas_block).
//
// * Checkpointed fill: the ring [3, (9,) W, W, n+1] of the score-only
//   kernels, diagonal d in slab d % 3.  Before diagonal d0 = b * C is
//   launched (b >= 1), slab (d0-1) % 3 is copied to ckpts[b, 0] and slab
//   (d0-2) % 3 to ckpts[b, 1], device to device on the same stream: after
//   diagonal d0-1 was written, before diagonal d0+1 overwrites the slab of
//   d0-2.  Block 0 is entered by no diagonal: ckpts[0] is never written
//   and, by the guards, never read.  The last diagonal stays in slab
//   (n+m) % 3.
// * Block fill: a window [C+2, (9,) W, W, n+1] whose slabs 0 and 1 are
//   diagonals d0-2 and d0-1 (copied from the checkpoint; for block 0 they
//   are left as they are) and whose slab x+2 is diagonal d0+x.  The kernel
//   runs with band addressing (diagonal d in slab d) on the window's base
//   moved back by d0-2 slabs, in 64 bits, so the row function needs no
//   notion of a window.  It stops at d = min(d0+C-1, n+m).
//
// What bounds both on an H100 is what bounds the per-diagonal kernels (one
// thread's chain of dependent loads: csrc/affine_diag.cuh); the copies are 2
// slabs per C diagonals.  Not carried over from the TPU kernels: the chunk
// of G diagonals per grid step with its VMEM budget, the padded diagonal
// count and row count with their garbage tail, the d_last prefetch, and the
// rounding of C to a quantum: any C >= 1 is taken.
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace bialign {
namespace {

// affine_diag<kRing> and nonaffine_diag<kRing>: (slabs, mu1, mu2, cases, n,
// m, S, d, lo, hi)
using DiagKernel = void (*)(int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int, int, int, int, int, int);

inline cudaError_t launch_diagonal(DiagKernel kernel, int32_t* slabs,
                                   const int32_t* mu1, const int32_t* mu2,
                                   const int32_t* cases, int n, int m, int S,
                                   int d, cudaStream_t st) {
  const int lo = std::max(0, d - m);
  const int hi = std::min(n, d);
  const int blocks = (hi - lo + kRowBlock) / kRowBlock;
  kernel<<<blocks, kRowBlock, 0, st>>>(slabs, mu1, mu2, cases, n, m, S, d, lo,
                                       hi);
  return cudaGetLastError();
}

inline cudaError_t copy_slab(int32_t* to, const int32_t* from, size_t values,
                             cudaStream_t st) {
  return cudaMemcpyAsync(to, from, values * sizeof(int32_t),
                         cudaMemcpyDeviceToDevice, st);
}

// Diagonals 0..n+m on `ring` with the ring kernel `kernel`, saving the
// slabs that enter each block of C diagonals into ckpts [NB, 2, ...];
// `cells` = int32 values of one slab per lattice row.
inline int run_ckpt_diagonals(DiagKernel kernel, int cells, int32_t* ring,
                              int32_t* ckpts, const int32_t* mu1,
                              const int32_t* mu2, const int32_t* cases, int n,
                              int m, int S, int C, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slab = static_cast<size_t>(cells) * (n + 1);
  for (int d = 0; d <= n + m; ++d) {
    if (d > 0 && d % C == 0) {
      int32_t* ck = ckpts + static_cast<size_t>(d / C) * 2 * slab;
      BIALIGN_TRY(copy_slab(ck, ring + ((d - 1) % RING) * slab, slab, st));
      BIALIGN_TRY(copy_slab(ck + slab, ring + ((d - 2 + RING) % RING) * slab,
                            slab, st));
    }
    BIALIGN_TRY(launch_diagonal(kernel, ring, mu1, mu2, cases, n, m, S, d, st));
  }
  return 0;
}

// `window` moved back by d0-2 slabs: the base on which slab d is diagonal d.
inline int32_t* window_base(int32_t* window, size_t slab, int d0) {
  return reinterpret_cast<int32_t*>(
      reinterpret_cast<intptr_t>(window) -
      (static_cast<intptr_t>(d0) - 2) * static_cast<intptr_t>(slab) *
          static_cast<intptr_t>(sizeof(int32_t)));
}

// Diagonals d0..min(d0+C-1, n+m) into `window` with the band kernel
// `kernel`, from the checkpoint ck [2, ...] = diagonals (d0-1, d0-2).
inline int run_block_diagonals(DiagKernel kernel, int cells, int32_t* window,
                               const int32_t* ck, const int32_t* mu1,
                               const int32_t* mu2, const int32_t* cases, int n,
                               int m, int S, int d0, int C, int device,
                               void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slab = static_cast<size_t>(cells) * (n + 1);
  if (d0 > 0) {
    BIALIGN_TRY(copy_slab(window, ck + slab, slab, st));
    BIALIGN_TRY(copy_slab(window + slab, ck, slab, st));
  }
  int32_t* base = window_base(window, slab, d0);
  const int last = std::min(d0 + C - 1, n + m);
  for (int d = d0; d <= last; ++d)
    BIALIGN_TRY(launch_diagonal(kernel, base, mu1, mu2, cases, n, m, S, d, st));
  return 0;
}

}  // namespace
}  // namespace bialign
