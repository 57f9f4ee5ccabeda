"""Traceback walks over a filled band: CUDA kernel wrappers and plain twins.

Counterpart of :mod:`bialign_tpu.ops.device_traceback`.  The walk runs on
the device that holds the band (``csrc/walk.cu``, one thread), so only the
trace, O(n+m) column codes, crosses to the host.  Its plain twin is the
host walk :mod:`bialign_tpu_torch.ops.traceback`, which the kernel must
match trace for trace, over ``band.to_numpy()``.

Both return what the JAX package's walks return: ``(trace, complete)``
(affine) or ``trace`` (non-affine), the trace a forward list of column
4-tuples.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import traceback as host_tb
from .band import DeviceBand
from .cuda_dp import affine_case_table, nonaffine_case_table

# Kernel launches per wrapper, for run reports.
LAUNCHES = {"walk_affine": 0, "walk_nonaffine": 0}

_HEADER = 2   # out = [steps, done, codes...] (csrc/walk.cu)


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
