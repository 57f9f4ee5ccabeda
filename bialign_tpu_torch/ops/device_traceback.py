"""Traceback walks over a filled band: CUDA kernel wrappers and plain twins.

Counterpart of :mod:`bialign_tpu.ops.device_traceback`.  The walk runs on
the device that holds the band (``csrc/walk.cu``, one thread a pair), so
only the trace, O(n+m) column codes, crosses to the host.  Its plain twin is
the host walk :mod:`bialign_tpu_torch.ops.traceback`, which the kernel must
match trace for trace, over ``band.to_numpy()``.

The single-pair walks return what the JAX package's return: ``(trace,
complete)`` (affine) or ``trace`` (non-affine), the trace a forward list of
column 4-tuples.  The batch walks (``_affine_walk_batch``,
``_nonaffine_walk_batch`` there) walk every pair of a
:class:`~bialign_tpu_torch.ops.band.DeviceBatchBand` in one launch and
return one int32 tensor ``[B, 3 + Lmax]`` on the band's device, not waited
for: per pair the step count, the done flag (affine: 1 complete, 2 stuck;
non-affine: 1), the score, and the column codes, last column first
(:func:`unpack_walks` takes it apart on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import traceback as host_tb
from .band import DeviceBand, DeviceBatchBand
from .cases import N_STATES
from .cuda_dp import (
    INVALID,
    _device_cases,
    affine_case_table,
    nonaffine_case_table,
)

# Kernel launches per wrapper, for run reports.
LAUNCHES = {"walk_affine": 0, "walk_nonaffine": 0, "walk_affine_batch": 0,
            "walk_nonaffine_batch": 0}

_HEADER = 3   # out = [steps, done, score, codes...] (csrc/walk.cu)


def decode_codes(codes) -> list:
    """Column codes of a walk (last column first, code = 8*x0 + 4*x1 +
    2*x2 + x3) -> forward trace of (x0, x1, x2, x3)."""
    return [((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
            for c in reversed(np.asarray(codes).tolist())]


def _walk_kernel(name, band: DeviceBand, cases, mu1, mu2):
    """Launch walk ``name``; return (codes, done) on the host."""
    ys = band.ys
    n, m = band.n, band.m
    for mu in (mu1, mu2):
        if (mu.device != ys.device or mu.dtype != torch.int32
                or tuple(mu.shape) != (n + 1, m + 1)
                or not mu.is_contiguous()):
            raise ValueError(
                f"score table {mu.dtype} {tuple(mu.shape)} on {mu.device} "
                f"does not fit the band of ({n}, {m}) on {ys.device}"
            )
    if ys.dtype != torch.int32 or not ys.is_contiguous():
        raise ValueError("the band must be a contiguous int32 tensor")
    lmax = 2 * (n + m) + 1
    out = torch.empty(_HEADER + lmax, dtype=torch.int32, device=ys.device)
    cases_t = torch.from_numpy(cases).to(ys.device)
    _build.launch(f"bialign_{name}", ys.device, ys, mu1, mu2, cases_t, n, m,
                  band.max_shift, out, lmax)
    LAUNCHES[name] += 1
    res = out.cpu().numpy()
    steps, done = int(res[0]), int(res[1])
    return res[_HEADER:_HEADER + steps], done


def affine_traceback(band: DeviceBand, beta, gamma, delta, mu1, mu2):
    """Affine walk: the CUDA kernel for a band on a CUDA device, the host
    walk for a band on the CPU.  ``mu1``/``mu2``: the fill's tables.
    Returns (trace, complete)."""
    if band.ys.device.type == "cpu":
        return affine_traceback_plain(band, beta, gamma, delta, mu1, mu2)
    codes, done = _walk_kernel(
        "walk_affine", band, affine_case_table(beta, gamma, delta), mu1, mu2
    )
    return decode_codes(codes), done == 1


def nonaffine_traceback(band: DeviceBand, gamma, delta, mu1, mu2):
    """Non-affine walk: the CUDA kernel for a band on a CUDA device, the
    host walk for a band on the CPU.  Returns the trace."""
    if band.ys.device.type == "cpu":
        return nonaffine_traceback_plain(band, gamma, delta, mu1, mu2)
    codes, _done = _walk_kernel(
        "walk_nonaffine", band, nonaffine_case_table(gamma, delta), mu1, mu2
    )
    return decode_codes(codes)


def affine_traceback_plain(band: DeviceBand, beta, gamma, delta, mu1, mu2):
    """The host walk (ops/traceback.py:45) over the band copied to host."""
    return host_tb.affine_traceback(
        band.to_numpy(), _host(mu1), _host(mu2), band.max_shift, beta, gamma,
        delta,
    )


def nonaffine_traceback_plain(band: DeviceBand, gamma, delta, mu1, mu2):
    """The host walk (ops/traceback.py:122) over the band copied to host."""
    return host_tb.nonaffine_traceback(
        band.to_numpy(), _host(mu1), _host(mu2), band.max_shift, gamma, delta,
    )


def _host(mu) -> np.ndarray:
    return mu.cpu().numpy() if isinstance(mu, torch.Tensor) else np.asarray(mu)


# -- every pair of a chunk band ----------------------------------------------

def walk_capacity(N: int, M: int) -> int:
    """Lmax, the codes a walk inside an (N, M) bucket can write."""
    return 2 * (N + M) + 1


def _check_batch(bband: DeviceBatchBand, mu1p, mu2p):
    ys = bband.ys
    B, N = ys.shape[0], bband.N
    if ys.dtype != torch.int32 or not ys.is_contiguous():
        raise ValueError("the band must be a contiguous int32 tensor")
    for name, t, shape in (("mu1p", mu1p, (B, N + 1, mu1p.shape[-1])),
                           ("mu2p", mu2p, (B, N + 1, mu1p.shape[-1])),
                           ("ns", bband.ns, (B,)), ("ms", bband.ms, (B,))):
        if (t.device != ys.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} {t.dtype} {tuple(t.shape)} on {t.device} does not "
                f"fit the chunk band {tuple(ys.shape)} on {ys.device}")


def _walk_batch_kernel(name, bband: DeviceBatchBand, cases, mu1p, mu2p):
    """Launch batch walk ``name`` over all pairs of ``bband``; the output
    ``[B, 3 + Lmax]`` stays on the device and is not waited for."""
    _check_batch(bband, mu1p, mu2p)
    ys = bband.ys
    B, N, M = ys.shape[0], bband.N, mu1p.shape[2] - 1
    lmax = walk_capacity(N, M)
    out = torch.empty((B, _HEADER + lmax), dtype=torch.int32,
                      device=ys.device)
    if B:
        _build.launch(f"bialign_{name}", ys.device, ys, mu1p, mu2p, cases,
                      bband.ns, bband.ms, B, N, M, bband.D, bband.max_shift,
                      out, lmax)
        LAUNCHES[name] += 1
    return out


def affine_walk_batch(bband: DeviceBatchBand, beta, gamma, delta, mu1p, mu2p):
    """Affine walks of all pairs of a chunk band: the CUDA kernel (one
    block a pair) for a band on a CUDA device, the host walk pair by pair
    for a band on the CPU.  ``mu1p``/``mu2p``: the fill's stacks."""
    if bband.ys.device.type == "cpu":
        return affine_walk_batch_plain(bband, beta, gamma, delta, mu1p, mu2p)
    return _walk_batch_kernel(
        "walk_affine_batch", bband,
        _device_cases("affine", (beta, gamma, delta), bband.ys.device), mu1p,
        mu2p)


def nonaffine_walk_batch(bband: DeviceBatchBand, gamma, delta, mu1p, mu2p):
    """Non-affine walks of all pairs of a chunk band; as
    :func:`affine_walk_batch`."""
    if bband.ys.device.type == "cpu":
        return nonaffine_walk_batch_plain(bband, gamma, delta, mu1p, mu2p)
    return _walk_batch_kernel(
        "walk_nonaffine_batch", bband,
        _device_cases("nonaffine", (gamma, delta), bband.ys.device), mu1p,
        mu2p)


def _walk_batch_plain(bband: DeviceBatchBand, mu1p, mu2p, walk_pair):
    """The host walk over ``bband.pair(b)`` for each b, packed as the batch
    kernels pack it; ``walk_pair(band, mu1, mu2) -> (trace, done, score)``.
    A pair whose last cell lies outside the chunk band is not walked."""
    _check_batch(bband, mu1p, mu2p)
    B, N, M = bband.ys.shape[0], bband.N, mu1p.shape[2] - 1
    out = np.zeros((B, _HEADER + walk_capacity(N, M)), dtype=np.int32)
    lengths = zip(bband.ns.tolist(), bband.ms.tolist())
    for b, (n, m) in enumerate(lengths):
        if not (0 <= n <= N and 0 <= m <= M and n + m < bband.D):
            out[b, :_HEADER] = (0, 2, INVALID)
            continue
        trace, done, score = walk_pair(
            bband.pair(b), _host(mu1p[b, :n + 1, :m + 1]),
            _host(mu2p[b, :n + 1, :m + 1]))
        codes = [8 * c[0] + 4 * c[1] + 2 * c[2] + c[3]
                 for c in reversed(trace)]
        out[b, :_HEADER] = (len(codes), done, score)
        out[b, _HEADER:_HEADER + len(codes)] = codes
    return torch.from_numpy(out).to(bband.ys.device)


def affine_walk_batch_plain(bband, beta, gamma, delta, mu1p, mu2p):
    """Plain twin of the affine batch walk."""
    def walk_pair(band, mu1, mu2):
        H = band.to_numpy()
        trace, complete = host_tb.affine_traceback(
            H, mu1, mu2, band.max_shift, beta, gamma, delta)
        S = band.max_shift
        score = int(H[:N_STATES, band.n, band.m, S, S].max())
        return trace, 1 if complete else 2, score
    return _walk_batch_plain(bband, mu1p, mu2p, walk_pair)


def nonaffine_walk_batch_plain(bband, gamma, delta, mu1p, mu2p):
    """Plain twin of the non-affine batch walk."""
    def walk_pair(band, mu1, mu2):
        H = band.to_numpy()
        trace = host_tb.nonaffine_traceback(H, mu1, mu2, band.max_shift,
                                            gamma, delta)
        S = band.max_shift
        return trace, 1, int(H[band.n, band.m, S, S])
    return _walk_batch_plain(bband, mu1p, mu2p, walk_pair)


def unpack_walks(out) -> list:
    """A batch walk's output ``[B, 3 + Lmax]`` (a host array) as one
    ``(codes, done, score)`` per pair, ``codes`` the written ones only."""
    out = np.asarray(out)
    return [(row[_HEADER:_HEADER + int(row[0])], int(row[1]), int(row[2]))
            for row in out]
