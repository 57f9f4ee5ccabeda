"""Checkpointed (low-memory) band fill and the traceback that recomputes
the band block by block: CUDA kernel wrappers and their plain twins.

Counterpart of :mod:`bialign_tpu.ops.checkpoint_dp`.  The band path keeps
the whole band ``[n+m+1, (9,) W, W, n+1]`` on the device for the walk; its
size grows as (n+m) * n and ends where the device's memory does.  Here the
fill keeps only the two diagonal slabs that enter every block of ``C``
diagonals (a checkpoint), and the traceback walks the band block by block
from the last, recomputing each block's ``C`` diagonals from its checkpoint
into one reused window.  With ``C ~ sqrt(2 (n+m+1))`` the checkpoints and
the window are O(sqrt(n+m)) slabs each.  Score, trace (the same column at
every step, the affine tie-breaks included) and ``complete`` flag equal the
band path's.

* :func:`fill_affine_checkpoint` / :func:`fill_nonaffine_checkpoint` (K9
  ``_affine_ckpt_kernel``, K11 ``_nonaffine_ckpt_kernel`` of
  ``pallas_dp.py``; ``csrc/ckpt_affine.cu``, ``csrc/ckpt_nonaffine.cu``)
  return a :class:`CheckpointBand`: the score-only fill on a ring of three
  slabs, which also saves ``ckpts[b] = (diagonal b*C - 1, diagonal
  b*C - 2)`` before diagonal ``b*C`` runs.
* :func:`affine_block` / :func:`nonaffine_block` (K10
  ``_affine_block_kernel``, K12 ``_nonaffine_block_kernel``;
  ``csrc/block_affine.cu``, ``csrc/block_nonaffine.cu``) recompute block
  ``b`` into a window ``[C+2, (9,) W, W, n+1]``: slabs 0 and 1 are the
  checkpoint's diagonals ``d0 - 2`` and ``d0 - 1`` (copied in, so that the
  walk reads one array), slab ``x + 2`` is diagonal ``d0 + x``,
  ``d0 = b * C``.
* :func:`affine_block_walk` / :func:`nonaffine_block_walk`
  (``_affine_blk_walk``, ``_nonaffine_blk_walk`` of ``checkpoint_dp.py``,
  ``lax.while_loop`` programs there; ``csrc/walk.cu``) walk one block's
  window down to diagonal ``d0`` and leave the walk's state in a small
  tensor on the device (:func:`new_walk`), where the next block's call
  finds it.
* :func:`affine_traceback` / :func:`nonaffine_traceback` queue, for every
  block from the last to the first, its fill and its walk on the current
  stream, read nothing back in between, and fetch the walk tensor in one
  copy.
* Each wrapper launches its kernel for tensors on a CUDA device and runs
  its plain twin only for tensors on the CPU.  ``*_plain`` are the twins:
  the per-diagonal steps of :mod:`~bialign_tpu_torch.ops.cuda_dp` on the
  ring and on a window, and the host walk of
  :mod:`~bialign_tpu_torch.ops.traceback` over a window, with the same
  state in and out.

Nothing here is the size of a band or has a diagonal axis ``[n+m+1, ...]``:
the kernels and the twins read the dense tables ``[n+1, m+1]``, so the
saving is O(sqrt(n+m)) for the non-affine band too (the JAX package keeps
diagonal tables as large as the non-affine band beside its checkpoints).
Slabs hold rows of older diagonals, or whatever the memory held, outside a
diagonal's live range; block 0's checkpoint is never written.  None of it is
read: every predecessor of the fill and of the walk is guarded to a live
row.  So rings, checkpoints and windows are ``torch.empty``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from . import traceback as host_tb
from .band import INVALID
from .cases import N_STATES
from .cuda_dp import (
    RING,
    _affine_step,
    _check_ring,
    _check_tables,
    _device_cases,
    _Geometry,
    _nonaffine_step,
    _ring_shape,
    _tile_consts,
)
from .device_traceback import _HEADER, decode_codes, walk_capacity

# Kernel launches per wrapper (one per fill, per block, per block's walk).
LAUNCHES = {"ckpt_affine": 0, "ckpt_nonaffine": 0, "block_affine": 0,
            "block_nonaffine": 0, "walk_affine_block": 0,
            "walk_nonaffine_block": 0}

# A blockwise walk's tensor: [i, j, k, l, q, netA, netB, first] (the
# non-affine walk uses the first four), then the walk's output [steps, done,
# score, codes...] (csrc/walk.cu `State`, kHeader).
STATE = 8


def default_block(D: int) -> int:
    """Block size minimising checkpoints (2/C slabs per diagonal) plus one
    live block (C slabs) over D diagonals: C = sqrt(2 D), floored at 8."""
    return max(8, int(math.ceil(math.sqrt(2.0 * D))))


@dataclass(frozen=True)
class CheckpointBand:
    """A checkpointed band on its device.  ``ckpts``: int32
    ``[NB, 2, 9, W, W, n+1]`` (affine) or ``[NB, 2, W, W, n+1]``,
    ``NB = (n+m) // block + 1``; ``ckpts[b, 0]`` is the slab of diagonal
    ``b*block - 1`` and ``ckpts[b, 1]`` of ``b*block - 2`` (``ckpts[0]`` is
    never written).  ``final``: the slab of diagonal n+m.  ``mu1``, ``mu2``:
    the dense tables, from which any block is recomputed.  ``params``:
    (beta, gamma, delta) or (gamma, delta)."""

    ckpts: torch.Tensor
    final: torch.Tensor
    mu1: torch.Tensor
    mu2: torch.Tensor
    n: int
    m: int
    max_shift: int
    affine: bool
    params: tuple
    block: int

    @property
    def n_blocks(self) -> int:
        return (self.n + self.m) // self.block + 1

    @property
    def device(self) -> torch.device:
        """Where windows are recomputed and walked: the tables' device."""
        return self.mu1.device

    @property
    def window_shape(self) -> tuple:
        """``[C+2, (9,) W, W, n+1]``, C no more than the band's diagonals."""
        return (min(self.block, self.n + self.m + 1) + 2,
                *self.final.shape)

    def final_score(self) -> int:
        """Optimal score, read from the final cell (n, m, n, m)."""
        n, S = self.n, self.max_shift
        if self.affine:
            return int(self.final[:, S, S, n].max())
        return int(self.final[S, S, n])

    def _check_ckpts(self) -> None:
        _check_ring(self.ckpts, _ckpts_shape(self.mu1, self.max_shift,
                                             self.affine, self.block),
                    self.mu1, "ckpts")

    def _recompute(self, b: int, *, plain: bool = False, window=None):
        """The window of block b; ``plain``: through the twin."""
        if self.affine:
            fn = affine_block_plain if plain else affine_block
        else:
            fn = nonaffine_block_plain if plain else nonaffine_block
        return fn(self, b, window=window)

    def cells(self, idxs, *, plain: bool = False) -> np.ndarray:
        """Exact values of a batch of cells, as :meth:`DeviceBand.cells`
        (``[N, 5]`` of (q, i, j, k, l) affine, ``[N, 4]`` of (i, j, k, l)
        otherwise): each touched block is recomputed once into one window
        and its cells gathered there, on the device."""
        idx = np.asarray(idxs, dtype=np.int64)
        dev = self.device
        S, C = self.max_shift, self.block
        blocks = (idx[:, -4] + idx[:, -3]) // C
        out = torch.empty(len(idx), dtype=torch.int32, device=dev)
        window = None
        for b in np.unique(blocks).tolist():
            window = self._recompute(b, plain=plain, window=window)
            sel = torch.as_tensor(blocks == b, device=dev)
            at = torch.as_tensor(idx[blocks == b], device=dev)
            i, j = at[:, -4], at[:, -3]
            where = (i + j - b * C + 2,
                     *((at[:, 0],) if self.affine else ()),
                     at[:, -2] - i + S, at[:, -1] - j + S, i)
            out[sel] = window[where]
        return out.cpu().numpy()


def _states(affine: bool) -> tuple:
    return (N_STATES,) if affine else ()


def _block_size(block, D: int) -> int:
    C = default_block(D) if block is None else block
    if isinstance(C, bool) or not isinstance(C, (int, np.integer)) or C < 1:
        raise ValueError(f"block must be an int >= 1 or None, got {block!r}")
    return int(C)


def _ckpts_shape(mu1, S: int, affine: bool, C: int) -> tuple:
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    return ((n + m) // C + 1, 2, *_ring_shape(mu1, S, _states(affine))[1:])


def _check_band(cb: CheckpointBand, affine: bool, params=None) -> None:
    if not isinstance(cb, CheckpointBand):
        raise TypeError(f"expected a CheckpointBand, got {type(cb)}")
    if cb.affine != affine:
        raise ValueError(f"an {'affine' if affine else 'non-affine'} band "
                         f"is needed, got affine={cb.affine}")
    if params is not None and tuple(params) != tuple(cb.params):
        raise ValueError(f"costs {tuple(params)} are not the band's "
                         f"{tuple(cb.params)}")
    _check_tables(cb.mu1, cb.mu2, cb.max_shift)
    cb._check_ckpts()


def _check_block(cb: CheckpointBand, b: int) -> None:
    if not 0 <= b < cb.n_blocks:
        raise ValueError(f"block {b} of a band of {cb.n_blocks} blocks")


# -- checkpointed fills ------------------------------------------------------

def fill_affine_checkpoint(mu1, mu2, max_shift, beta, gamma, delta, *,
                           block=None, ring=None,
                           ckpts=None) -> CheckpointBand:
    """Affine fill that keeps only the checkpoints (K9): the CUDA kernel
    for tables on a CUDA device, the plain twin for tables on the CPU.
    ``block``: C, any int >= 1 (default :func:`default_block`).  ``ring``
    ``[3, 9, W, W, n+1]`` and ``ckpts`` ``[NB, 2, 9, W, W, n+1]``: memory to
    use, whatever it holds (default: fresh, uninitialised).  The caller
    checks int32 safety first, as for the band fills."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_affine_checkpoint_plain(mu1, mu2, max_shift, beta, gamma,
                                            delta, block=block, ring=ring,
                                            ckpts=ckpts)
    return _ckpt_kernel("ckpt_affine", mu1, mu2, max_shift,
                        (beta, gamma, delta), True, block, ring, ckpts)


def fill_nonaffine_checkpoint(mu1, mu2, max_shift, gamma, delta, *,
                              block=None, ring=None,
                              ckpts=None) -> CheckpointBand:
    """Non-affine fill that keeps only the checkpoints (K11); as
    :func:`fill_affine_checkpoint`, ``ring`` being ``[3, W, W, n+1]`` and
    ``ckpts`` ``[NB, 2, W, W, n+1]``."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_nonaffine_checkpoint_plain(mu1, mu2, max_shift, gamma,
                                               delta, block=block, ring=ring,
                                               ckpts=ckpts)
    return _ckpt_kernel("ckpt_nonaffine", mu1, mu2, max_shift, (gamma, delta),
                        False, block, ring, ckpts)


def _ckpt_memory(mu1, S, affine, block, ring, ckpts, make):
    """(C, ring, ckpts): the block size and the two buffers, checked if
    given and made by ``make(shape)`` if not."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    C = _block_size(block, n + m + 1)
    shapes = (_ring_shape(mu1, S, _states(affine)),
              _ckpts_shape(mu1, S, affine, C))
    _check_ring(ring, shapes[0], mu1)
    _check_ring(ckpts, shapes[1], mu1, "ckpts")
    ring = make(shapes[0]) if ring is None else ring
    ckpts = make(shapes[1]) if ckpts is None else ckpts
    return C, ring, ckpts


def _ckpt_kernel(name, mu1, mu2, S, params, affine, block, ring, ckpts):
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    dev = mu1.device
    C, ring, ckpts = _ckpt_memory(
        mu1, S, affine, block, ring, ckpts,
        lambda shape: torch.empty(shape, dtype=torch.int32, device=dev))
    consts = _tile_consts(affine, params, S)
    _build.launch(f"bialign_{name}", dev, ring, ckpts, mu1, mu2, consts, n, m,
                  S, C)
    LAUNCHES[name] += 1
    return CheckpointBand(ckpts=ckpts, final=ring[(n + m) % RING], mu1=mu1,
                          mu2=mu2, n=n, m=m, max_shift=S, affine=affine,
                          params=tuple(params), block=C)


def _ckpt_plain(step, mu1, mu2, S, params, affine, block, ring, ckpts):
    """Run ``step`` over all diagonals on a ring of three slabs, as
    ``cuda_dp._ring_plain`` does, and before diagonal b*C runs (b >= 1) save
    the slabs of diagonals b*C - 1 and b*C - 2 as they stand in the ring."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    dev = mu1.device
    C, ring, ckpts = _ckpt_memory(
        mu1, S, affine, block, ring, ckpts,
        lambda shape: torch.full(shape, INVALID, dtype=torch.int32,
                                 device=dev))
    for d in range(n + m + 1):
        if d and d % C == 0:
            ckpts[d // C, 0] = ring[(d - 1) % RING]
            ckpts[d // C, 1] = ring[(d - 2) % RING]
        val, live = step(d, ring[(d - 1) % RING], ring[(d - 2) % RING])
        ring[d % RING] = torch.where(live, val, ring[d % RING])
    return CheckpointBand(ckpts=ckpts, final=ring[(n + m) % RING], mu1=mu1,
                          mu2=mu2, n=n, m=m, max_shift=S, affine=affine,
                          params=tuple(params), block=C)


def fill_affine_checkpoint_plain(mu1, mu2, max_shift, beta, gamma, delta, *,
                                 block=None, ring=None,
                                 ckpts=None) -> CheckpointBand:
    """Plain twin of K9: the step of ``cuda_dp.fill_affine_plain`` on a
    ring of three slabs, saving the checkpoints."""
    _check_tables(mu1, mu2, max_shift)
    g = _Geometry(mu1, mu2, max_shift)
    return _ckpt_plain(_affine_step(g, beta, gamma, delta), mu1, mu2,
                       max_shift, (beta, gamma, delta), True, block, ring,
                       ckpts)


def fill_nonaffine_checkpoint_plain(mu1, mu2, max_shift, gamma, delta, *,
                                    block=None, ring=None,
                                    ckpts=None) -> CheckpointBand:
    """Plain twin of K11."""
    _check_tables(mu1, mu2, max_shift)
    g = _Geometry(mu1, mu2, max_shift)
    return _ckpt_plain(_nonaffine_step(g, gamma, delta), mu1, mu2, max_shift,
                       (gamma, delta), False, block, ring, ckpts)


# -- one block's band --------------------------------------------------------

def affine_block(cb: CheckpointBand, b: int, *, window=None) -> torch.Tensor:
    """The window ``[C+2, 9, W, W, n+1]`` of block b of an affine
    checkpointed band (K10): slab x is diagonal ``b*C - 2 + x``.  The CUDA
    kernel for a band on a CUDA device, the plain twin for one on the CPU.
    ``window``: the memory to fill, whatever it holds (default: fresh,
    uninitialised); only the live rows of the block's diagonals and the two
    checkpoint slabs are written."""
    _check_band(cb, True)
    if cb.device.type == "cpu":
        return affine_block_plain(cb, b, window=window)
    return _block_kernel("block_affine", cb, b, window)


def nonaffine_block(cb: CheckpointBand, b: int, *,
                    window=None) -> torch.Tensor:
    """The window ``[C+2, W, W, n+1]`` of block b of a non-affine
    checkpointed band (K12); as :func:`affine_block`."""
    _check_band(cb, False)
    if cb.device.type == "cpu":
        return nonaffine_block_plain(cb, b, window=window)
    return _block_kernel("block_nonaffine", cb, b, window)


def _check_one_device(cb: CheckpointBand) -> None:
    if not isinstance(cb.ckpts, torch.Tensor):
        raise TypeError("the blocks of a band sharded over devices are "
                        "recomputed by its own _recompute")


def _block_kernel(name, cb: CheckpointBand, b: int, window):
    _check_block(cb, b)
    _check_one_device(cb)
    dev = cb.device
    shape = cb.window_shape
    _check_ring(window, shape, cb.mu1, "window")
    if window is None:
        window = torch.empty(shape, dtype=torch.int32, device=dev)
    consts = _tile_consts(cb.affine, cb.params, cb.max_shift)
    _build.launch(f"bialign_{name}", dev, window, cb.ckpts[b], cb.mu1, cb.mu2,
                  consts, cb.n, cb.m, cb.max_shift, b * cb.block,
                  shape[0] - 2)
    LAUNCHES[name] += 1
    return window


def _block_plain(step, cb: CheckpointBand, b: int, window):
    """Run ``step`` over the diagonals of block b on a window, as the block
    kernels do: slabs 0 and 1 from the checkpoint (block 0 has none: they
    stay as they are), then diagonal d0 + x reads slabs x + 1 and x and
    writes the live rows of slab x + 2."""
    _check_block(cb, b)
    _check_one_device(cb)
    shape = cb.window_shape
    _check_ring(window, shape, cb.mu1, "window")
    if window is None:
        window = torch.full(shape, INVALID, dtype=torch.int32,
                            device=cb.device)
    d0 = b * cb.block
    if b:
        window[0] = cb.ckpts[b, 1]
        window[1] = cb.ckpts[b, 0]
    for x, d in enumerate(range(d0, min(d0 + shape[0] - 3, cb.n + cb.m) + 1)):
        val, live = step(d, window[x + 1], window[x])
        window[x + 2] = torch.where(live, val, window[x + 2])
    return window


def affine_block_plain(cb: CheckpointBand, b: int, *, window=None):
    """Plain twin of K10."""
    _check_band(cb, True)
    g = _Geometry(cb.mu1, cb.mu2, cb.max_shift)
    return _block_plain(_affine_step(g, *cb.params), cb, b, window)


def nonaffine_block_plain(cb: CheckpointBand, b: int, *, window=None):
    """Plain twin of K12."""
    _check_band(cb, False)
    g = _Geometry(cb.mu1, cb.mu2, cb.max_shift)
    return _block_plain(_nonaffine_step(g, *cb.params), cb, b, window)


# -- one block's walk --------------------------------------------------------

def new_walk(cb: CheckpointBand, device=None) -> torch.Tensor:
    """The tensor of a blockwise walk, int32 ``[8 + 3 + Lmax]``: the state
    between blocks, then steps, done, score and the codes (last column
    first), all zero until the walk of the last block sets it up."""
    return torch.zeros(STATE + _HEADER + walk_capacity(cb.n, cb.m),
                       dtype=torch.int32,
                       device=cb.device if device is None else device)


def _check_walk(cb: CheckpointBand, b: int, window, walk, device) -> None:
    _check_block(cb, b)
    _check_ring(window, cb.window_shape, cb.mu1, "window")
    size = STATE + _HEADER + walk_capacity(cb.n, cb.m)
    if (tuple(walk.shape) != (size,) or walk.dtype != torch.int32
            or walk.device != device or not walk.is_contiguous()):
        raise ValueError(
            f"walk must be a contiguous int32 tensor [{size}] on {device}, "
            f"got {walk.dtype} {tuple(walk.shape)} on {walk.device}")


def affine_block_walk(cb: CheckpointBand, b: int, window, walk) -> None:
    """Walk block b of an affine band over its ``window``, in place on
    ``walk`` (:func:`new_walk`): from the band's last cell if b is the last
    block, else from the state the walk of block b+1 left; down to
    diagonal ``b*C``.  The CUDA kernel for a window on a CUDA device (not
    waited for), the host walk for one on the CPU."""
    _check_band(cb, True)
    if window.device.type == "cpu":
        return affine_block_walk_plain(cb, b, window, walk)
    return _block_walk_kernel("walk_affine_block", cb, b, window, walk)


def nonaffine_block_walk(cb: CheckpointBand, b: int, window, walk) -> None:
    """Walk block b of a non-affine band; as :func:`affine_block_walk`."""
    _check_band(cb, False)
    if window.device.type == "cpu":
        return nonaffine_block_walk_plain(cb, b, window, walk)
    return _block_walk_kernel("walk_nonaffine_block", cb, b, window, walk)


def _block_walk_kernel(name, cb: CheckpointBand, b: int, window, walk):
    dev = window.device
    _check_walk(cb, b, window, walk, dev)
    cases = _device_cases("affine" if cb.affine else "nonaffine", cb.params,
                          dev)
    _build.launch(f"bialign_{name}", dev, window, cb.mu1, cb.mu2, cases, cb.n,
                  cb.m, cb.max_shift, b * cb.block, int(b == cb.n_blocks - 1),
                  walk[:STATE], walk[STATE:], walk_capacity(cb.n, cb.m))
    LAUNCHES[name] += 1


def _block_walk_plain(cb: CheckpointBand, b: int, window, walk, n_state,
                      start_state, walker):
    """The host walk over block b's window copied to the host, on a walk
    tensor on the CPU, as the blockwise kernels run it: ``start_state(cell)
    -> (state, score)`` on the last block, else the ``n_state`` values of
    the state and the counts from ``walk``; ``walker(cell, mu1, mu2, state,
    stop_below, cap)`` -> (columns, state, done)."""
    _check_walk(cb, b, window, walk, torch.device("cpu"))
    win = window.cpu().numpy()
    buf = walk.numpy()                      # shares the tensor's memory
    out = buf[STATE:]
    n, m, S, d0 = cb.n, cb.m, cb.max_shift, b * cb.block

    if cb.affine:
        def cell(q, i, j, k, l):
            return int(win[i + j - d0 + 2, q, k - i + S, l - j + S, i])
    else:
        def cell(i, j, k, l):
            return int(win[i + j - d0 + 2, k - i + S, l - j + S, i])

    if b == cb.n_blocks - 1:
        state, score = start_state(cell)
        steps = 0
    else:
        if out[1] != 0:
            return                          # an earlier block ended the walk
        steps, score = int(out[0]), int(out[2])
        state = tuple(int(v) for v in buf[:n_state])
    cols, state, done = walker(
        cell, cb.mu1.cpu().numpy(), cb.mu2.cpu().numpy(), state, d0,
        walk_capacity(n, m) - steps)
    codes = [8 * c[0] + 4 * c[1] + 2 * c[2] + c[3] for c in cols]
    out[_HEADER + steps:_HEADER + steps + len(codes)] = codes
    out[:_HEADER] = (steps + len(codes), done, score)
    buf[:n_state] = [int(v) for v in state]


def affine_block_walk_plain(cb: CheckpointBand, b: int, window, walk) -> None:
    """Plain twin of the affine blockwise walk; ``walk`` lies on the CPU."""
    _check_band(cb, True)
    n, m, S = cb.n, cb.m, cb.max_shift

    def start_state(cell):
        final = [cell(q, n, m, n, m) for q in range(N_STATES)]
        q = host_tb.affine_start_state(final)
        return (n, m, n, m, q, 0, 0, True), max(final)

    def walker(cell, mu1, mu2, state, stop_below, cap):
        state = (*state[:7], bool(state[7]))
        return host_tb.affine_walk(cell, mu1, mu2, S, *cb.params, state,
                                   stop_below=stop_below, cap=cap)
    _block_walk_plain(cb, b, window, walk, STATE, start_state, walker)


def nonaffine_block_walk_plain(cb: CheckpointBand, b: int, window,
                               walk) -> None:
    """Plain twin of the non-affine blockwise walk."""
    _check_band(cb, False)
    n, m, S = cb.n, cb.m, cb.max_shift

    def start_state(cell):
        return (n, m, n, m), cell(n, m, n, m)

    def walker(cell, mu1, mu2, state, stop_below, cap):
        return host_tb.nonaffine_walk(cell, mu1, mu2, S, *cb.params, state,
                                      stop_below=stop_below, cap=cap)
    _block_walk_plain(cb, b, window, walk, 4, start_state, walker)


# -- the blockwise traceback -------------------------------------------------

def _traceback(cb: CheckpointBand, plain: bool, walk_fn, walk):
    """Queue every block's fill (``cb._recompute``; ``plain``: through the
    twins) and walk, last block first, over one window; then fetch ``walk``
    in one copy.  Returns (codes, done, state)."""
    window = None
    for b in range(cb.n_blocks - 1, -1, -1):
        window = cb._recompute(b, plain=plain, window=window)
        walk_fn(cb, b, window, walk)
    res = walk.cpu().numpy()
    steps, done = int(res[STATE]), int(res[STATE + 1])
    codes = res[STATE + _HEADER:STATE + _HEADER + steps]
    return codes, done, res[:STATE]


def _affine_result(codes, done: int, state):
    if done not in (1, 2):
        raise RuntimeError(
            "checkpoint traceback: the affine walk neither reached the "
            f"origin nor stopped (state {state.tolist()} after "
            f"{len(codes)} columns); the trace would be corrupt")
    return decode_codes(codes), done == 1


def _nonaffine_result(codes, done: int, state):
    if done != 1 or state[:4].any():
        raise RuntimeError(
            "checkpoint traceback: the non-affine walk ended at "
            f"{state[:4].tolist()} (done {done}) after {len(codes)} columns, "
            "not at the origin; the trace would be corrupt")
    return decode_codes(codes)


def affine_traceback(cb: CheckpointBand, beta, gamma, delta):
    """Blockwise affine traceback, (trace, complete) as the band path's
    walk returns them: the CUDA kernels for a band on a CUDA device (no
    host round trip between blocks, one copy back), the plain twins for one
    on the CPU."""
    _check_band(cb, True, (beta, gamma, delta))
    if cb.device.type == "cpu":
        return affine_traceback_plain(cb, beta, gamma, delta)
    return _affine_result(*_traceback(cb, False, affine_block_walk,
                                      new_walk(cb)))


def nonaffine_traceback(cb: CheckpointBand, gamma, delta):
    """Blockwise non-affine traceback (the forward trace); as
    :func:`affine_traceback`."""
    _check_band(cb, False, (gamma, delta))
    if cb.device.type == "cpu":
        return nonaffine_traceback_plain(cb, gamma, delta)
    return _nonaffine_result(*_traceback(cb, False, nonaffine_block_walk,
                                         new_walk(cb)))


def affine_traceback_plain(cb: CheckpointBand, beta, gamma, delta):
    """The blockwise affine traceback through the plain twins, on the
    band's device; the walk runs on the host."""
    _check_band(cb, True, (beta, gamma, delta))
    return _affine_result(*_traceback(
        cb, True, affine_block_walk_plain, new_walk(cb, "cpu")))


def nonaffine_traceback_plain(cb: CheckpointBand, gamma, delta):
    """The blockwise non-affine traceback through the plain twins."""
    _check_band(cb, False, (gamma, delta))
    return _nonaffine_result(*_traceback(
        cb, True, nonaffine_block_walk_plain, new_walk(cb, "cpu")))
