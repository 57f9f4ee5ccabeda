// Host loops of the checkpointed low-memory path: the score-only fill that
// also saves the two slabs entering every block of C diagonals (K9, K11),
// and the band-mode fill of one block into a window, from its checkpoint
// (K10, K12).  Both launch the tile kernel of the single-pair fills
// (csrc/tile_diag.cuh, `launch_diagonal`) as it is, so K9-K12 run the
// recurrence of K1 and K2 and move with it.
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
//   moved back by d0-2 slabs, in 64 bits, so the tile kernel needs no
//   notion of a window: it stages slabs d-1 and d-2 >= d0-2 only, never
//   one of a diagonal below 0, and rows [0, n] of them only.  It stops at
//   d = min(d0+C-1, n+m).
//
// What bounds both on an H100 is what bounds the tile kernel (one launch's
// chain of staged loads and barriers, and the host's launch rate:
// csrc/tile_diag.cuh); the copies are 2 slabs per C diagonals.  Not
// carried over from the TPU kernels: the chunk of G diagonals per grid step
// with its VMEM budget, the padded diagonal count and row count with their
// garbage tail, the d_last prefetch, and the rounding of C to a quantum:
// any C >= 1 is taken.
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tile_diag.cuh"

namespace bialign {
namespace {

inline cudaError_t copy_slab(int32_t* to, const int32_t* from, size_t values,
                             cudaStream_t st) {
  return cudaMemcpyAsync(to, from, values * sizeof(int32_t),
                         cudaMemcpyDeviceToDevice, st);
}

// int32 values of one slab of a (n+1)-row pair at max_shift S
template <class Tile>
size_t slab_values(int n, int S) {
  return static_cast<size_t>(Tile::kStates) * (2 * S + 1) * (2 * S + 1) *
         (n + 1);
}

// Diagonals 0..n+m on `ring` with Tile's ring kernel, saving the slabs
// that enter each block of C diagonals into ckpts [NB, 2, ...]; `consts`
// (host memory) are the case constants.
template <class Tile>
int run_ckpt_diagonals(int32_t* ring, int32_t* ckpts, const int32_t* mu1,
                       const int32_t* mu2, const int32_t* consts, int n, int m,
                       int S, int C, int device, void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const size_t slab = slab_values<Tile>(n, S);
  for (int d = 0; d <= n + m; ++d) {
    if (d > 0 && d % C == 0) {
      int32_t* ck = ckpts + static_cast<size_t>(d / C) * 2 * slab;
      BIALIGN_TRY(copy_slab(ck, ring + ((d - 1) % RING) * slab, slab, st));
      BIALIGN_TRY(copy_slab(ck + slab, ring + ((d - 2 + RING) % RING) * slab,
                            slab, st));
    }
    BIALIGN_TRY(
        (launch_diagonal<Tile, true>(ring, mu1, mu2, cs, n, m, S, d, st)));
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

// Diagonals d0..min(d0+C-1, n+m) into `window` with Tile's band kernel,
// from the checkpoint ck [2, ...] = diagonals (d0-1, d0-2).
template <class Tile>
int run_block_diagonals(int32_t* window, const int32_t* ck, const int32_t* mu1,
                        const int32_t* mu2, const int32_t* consts, int n,
                        int m, int S, int d0, int C, int device,
                        void* stream) {
  BIALIGN_TRY(cudaSetDevice(device));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const typename Tile::Consts cs = consts_from<Tile>(consts);
  const size_t slab = slab_values<Tile>(n, S);
  if (d0 > 0) {
    BIALIGN_TRY(copy_slab(window, ck + slab, slab, st));
    BIALIGN_TRY(copy_slab(window + slab, ck, slab, st));
  }
  int32_t* base = window_base(window, slab, d0);
  const int last = std::min(d0 + C - 1, n + m);
  for (int d = d0; d <= last; ++d)
    BIALIGN_TRY(
        (launch_diagonal<Tile, false>(base, mu1, mu2, cs, n, m, S, d, st)));
  return 0;
}

}  // namespace
}  // namespace bialign
