"""State of the JAX package -> state of the port.

The DP has no learned parameters: its "weights" are the dense score tables
``mu1``/``mu2`` built on the host (``scoring/tables.py`` of either
package), and its state is the filled band, or in score-only mode the last
diagonal's slab.  A batch's inputs are its buckets' padded stacks of
tables.  All cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.band import DeviceBand
from .ops.cases import N_STATES

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
