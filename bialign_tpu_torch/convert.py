"""State of the JAX package -> state of the port.

The DP has no learned parameters: its "weights" are the dense score tables
``mu1``/``mu2`` built on the host (``scoring/tables.py`` of either
package), and its state is the filled band, in score-only mode the last
diagonal's slab, or in low-memory mode the checkpoints.  A batch's inputs are its buckets' padded stacks of
tables, or of residue and structure codes; the state of a batch of
alignments is the chunk band of its pairs.  All cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.band import DeviceBand, DeviceBatchBand
from .ops.cases import N_STATES
from .ops.checkpoint_dp import CheckpointBand

_I32 = np.iinfo(np.int32)


def tables_to_torch(mu1, mu2, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense ``[n+1, m+1]`` score tables as contiguous int32 tensors on
    ``device``.  Raises if a value does not fit int32."""
    out = []
    for name, mu in (("mu1", mu1), ("mu2", mu2)):
        a = np.asarray(mu)
        if a.ndim != 2 or not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"{name} must be a 2-D integer array, got "
                             f"{a.dtype} {a.shape}")
        if a.size and (a.min() < _I32.min or a.max() > _I32.max):
            raise ValueError(f"{name} has values outside int32")
        out.append(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                   .to(device))
    if out[0].shape != out[1].shape:
        raise ValueError(f"mu1 {tuple(out[0].shape)} and mu2 "
                         f"{tuple(out[1].shape)} differ in shape")
    return out[0], out[1]


def band_from_jax(ys, n: int, m: int, max_shift: int, affine: bool,
                  p_last: bool) -> DeviceBand:
    """A band filled by the JAX package, as a port band on the CPU.

    ``ys`` is the JAX ``DeviceBand.ys`` as an array: the Pallas layout
    ``[D_pad, (Q,) W, W, Ppad]`` (``p_last``) or the XLA layout
    ``[D, (Q,) P, W, W]``.  Both are cropped to the port's
    ``[n+m+1, (Q,) W, W, n+1]``; rows off a diagonal's live range keep the
    JAX engine's values, which no walk reads.
    """
    ys = np.asarray(ys)
    D, P, W = n + m + 1, n + 1, 2 * max_shift + 1
    if not p_last:
        ys = np.moveaxis(ys, -3, -1)
    ys = ys[:D, ..., :P]
    want = (D, *((N_STATES,) if affine else ()), W, W, P)
    if ys.shape != want:
        raise ValueError(f"JAX band crops to {ys.shape}, expected {want}")
    return DeviceBand(ys=torch.from_numpy(np.ascontiguousarray(ys, np.int32)),
                      n=n, m=m, max_shift=max_shift, affine=affine)


def slab_from_jax(last, n: int, max_shift: int, affine: bool) -> torch.Tensor:
    """The last-diagonal slab of a JAX score-only fill, as a port slab on
    the CPU.

    ``last`` is the output of the JAX package's score-only kernels in the
    Pallas layout, ``[1, 9, W, W, Ppad]`` (affine) or ``[1, W, W, Ppad]``
    (non-affine), cropped to the port's ``[(9,) W, W, n+1]``.  Only row n is
    live on the last diagonal; the other rows keep the JAX kernel's values.
    """
    last = np.asarray(last)
    W = 2 * max_shift + 1
    want = (1, *((N_STATES,) if affine else ()), W, W)
    if last.shape[:-1] != want or last.shape[-1] < n + 1:
        raise ValueError(f"JAX slab {last.shape}, expected {want} + "
                         f"(>= {n + 1},)")
    return torch.from_numpy(np.array(last[0, ..., :n + 1], dtype=np.int32))


def stacks_from_jax(mu1p, mu2p, ns, ms, device):
    """What the JAX batched-scores path ships to its kernels for one bucket,
    as the port's tensors on ``device``.

    ``mu1p``, ``mu2p``: the zero-padded stacks ``[B, N+1, M+1]`` of
    ``parallel.batch.stack_padded``, int32 or narrowed to int16 for the
    transfer (``pallas_dp._narrow_if_fits``); ``ns``, ``ms``: the pairs'
    lengths ``[B]``, batch-axis padding included.  Returns contiguous int32
    ``(mu1p, mu2p, ns, ms)``, the arguments of
    :func:`bialign_tpu_torch.ops.cuda_dp.affine_batch_scores`.
    """
    stacks = [np.asarray(a) for a in (mu1p, mu2p)]
    lengths = [np.asarray(a) for a in (ns, ms)]
    for name, a, ndim in (("mu1p", stacks[0], 3), ("mu2p", stacks[1], 3),
                          ("ns", lengths[0], 1), ("ms", lengths[1], 1)):
        if a.ndim != ndim or a.dtype not in (np.int16, np.int32):
            raise ValueError(f"{name} must be a {ndim}-D int16 or int32 "
                             f"array, got {a.dtype} {a.shape}")
    B = stacks[0].shape[0]
    if stacks[0].shape != stacks[1].shape or any(
            a.shape != (B,) for a in lengths):
        raise ValueError(
            f"shapes differ: mu1p {stacks[0].shape}, mu2p {stacks[1].shape}, "
            f"ns {lengths[0].shape}, ms {lengths[1].shape}")
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(device) for a in (*stacks, *lengths))


def batch_band_from_jax(ys_folded, ns, ms, N: int, max_shift: int,
                        affine: bool) -> DeviceBatchBand:
    """The chunk band of the JAX batched fills in band mode, as a port
    chunk band on the CPU.

    ``ys_folded`` is the output of ``pallas_dp._affine_pallas_batched_dense``
    / ``_nonaffine_pallas_batched_dense`` with ``score_only=False``: the
    folded layout ``[B, D_pad, (9 *) W * W * SUB, 128]`` whose second-last
    axis runs over ((q,) sk, sl, i // 128) and whose last is i % 128.  It is
    unfolded and cropped to the port's ``[B, D_pad, (9,) W, W, N+1]``; all
    D_pad diagonals stay.  ``ns``, ``ms``: the pairs' lengths ``[B]``.
    Cells that are not genuine keep the JAX kernel's values, which nothing
    reads.
    """
    ys = np.asarray(ys_folded)
    W = 2 * max_shift + 1
    states = (N_STATES,) if affine else ()
    cells = int(np.prod(states + (W, W)))
    if ys.ndim != 4 or ys.shape[2] % cells or ys.shape[2] // cells \
            * ys.shape[3] < N + 1:
        raise ValueError(f"JAX chunk band {ys.shape} does not fold "
                         f"{states + (W, W)} cells over >= {N + 1} rows")
    B, D = ys.shape[:2]
    ys = ys.reshape(B, D, *states, W, W, -1)[..., :N + 1]
    lengths = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
               for a in (ns, ms)]
    if any(t.shape != (B,) for t in lengths):
        raise ValueError(f"ns {tuple(lengths[0].shape)}, ms "
                         f"{tuple(lengths[1].shape)} for a band of {B} pairs")
    return DeviceBatchBand(
        ys=torch.from_numpy(np.ascontiguousarray(ys, np.int32)),
        ns=lengths[0], ms=lengths[1], max_shift=max_shift, affine=affine)


def code_stacks_from_jax(ca, cb, sa, sb, ns, ms, B: int, N: int, device):
    """What the JAX codes path ships to the device for one bucket
    (``parallel.batch._code_buckets``), as the port's tensors on ``device``.

    ``ca``, ``sa``: uint8 ``[Bp, Ppad]`` with the rows padded to the TPU's
    lane width and the batch axis to a multiple of PACK; ``cb``, ``sb``:
    ``[Bp, M+1]``; ``ns``, ``ms``: ``[Bp]``.  Both paddings are stripped:
    returns ``(ca [B, N+1], cb [B, M+1], sa, sb, ns [B], ms)``, the
    arguments of :func:`bialign_tpu_torch.ops.cuda_dp.mu_planes_from_codes`
    after the table.
    """
    arrays = [np.asarray(a) for a in (ca, cb, sa, sb, ns, ms)]
    for name, a in zip(("ca", "cb", "sa", "sb"), arrays):
        if a.ndim != 2 or a.dtype != np.uint8 or a.shape[0] < B:
            raise ValueError(f"{name} must be a uint8 [>= {B}, width] "
                             f"array, got {a.dtype} {a.shape}")
    if arrays[0].shape[1] < N + 1 or arrays[2].shape[1] < N + 1:
        raise ValueError(f"ca {arrays[0].shape}, sa {arrays[2].shape} hold "
                         f"fewer than {N + 1} rows")
    ca, cb, sa, sb = (a[:B] for a in arrays[:4])
    out = [ca[:, :N + 1], cb, sa[:, :N + 1], sb]
    out += [np.asarray(a[:B], dtype=np.int32) for a in arrays[4:]]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in out)


def checkpoint_band_from_jax(cb, mu1, mu2) -> CheckpointBand:
    """A checkpointed band filled by the JAX package, as the port's on the
    CPU.

    ``cb``: the JAX ``CheckpointBand`` (read by attribute: ``ckpts``,
    ``final``, ``db``, ``n``, ``m``, ``max_shift``, ``affine``, ``params``,
    ``p_last``), in either layout: ``ckpts [NB, 2, (Q,) P, W, W]`` from the
    XLA scan, or ``[NB, 2, (Q,) W, W, Ppad]`` from the Pallas fill
    (``p_last``), whose block count covers the padded diagonals.  Both are
    cropped to the port's ``[(n+m) // C + 1, 2, (Q,) W, W, n+1]``, C the
    JAX band's block size; ``mu1``, ``mu2``: the pair's dense tables, which
    take the place of its diagonal tables.  Rows off a diagonal's live
    range keep the JAX engine's values, which nothing reads.
    """
    n, m, S, affine = cb.n, cb.m, cb.max_shift, bool(cb.affine)
    C = int(np.asarray(cb.db).shape[1])
    NB, P, W = (n + m) // C + 1, n + 1, 2 * S + 1
    ckpts, final = np.asarray(cb.ckpts), np.asarray(cb.final)
    if not cb.p_last:
        ckpts, final = (np.moveaxis(a, -3, -1) for a in (ckpts, final))
    ckpts, final = ckpts[:NB, ..., :P], final[..., :P]
    slab = (*((N_STATES,) if affine else ()), W, W, P)
    if ckpts.shape != (NB, 2, *slab) or final.shape != slab:
        raise ValueError(
            f"JAX checkpoints crop to {ckpts.shape} and {final.shape}, "
            f"expected {(NB, 2, *slab)} and {slab}")
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    if tuple(t1.shape) != (n + 1, m + 1):
        raise ValueError(f"tables {tuple(t1.shape)} for a band of ({n}, {m})")
    return CheckpointBand(
        ckpts=torch.from_numpy(np.array(ckpts, dtype=np.int32, order="C")),
        final=torch.from_numpy(np.array(final, dtype=np.int32, order="C")),
        mu1=t1, mu2=t2, n=n, m=m, max_shift=S, affine=affine,
        params=tuple(int(v) for v in cb.params), block=C)
