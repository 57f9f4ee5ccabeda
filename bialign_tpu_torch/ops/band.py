"""Handle of a filled DP band held in a torch tensor.

Counterpart of :class:`bialign_tpu.ops.band.DeviceBand`.  The fills of
:mod:`bialign_tpu_torch.ops.cuda_dp` write the band diagonal-major with the
lattice row last, ``ys[d, (q,) sk, sl, i]`` with ``d = i + j``,
``sk = k - i + S`` and ``sl = l - j + S``: the JAX Pallas layout without
its 128-lane padding and bucketed diagonal count.  The band stays on its
device; only the cells asked for, or the score, are copied to the host.

A chunk of a bucket's pairs has one band for all of them,
:class:`DeviceBatchBand`: ``ys[b, d, (q,) sk, sl, i]`` in the bucket's
geometry, each pair's cells where its own single-pair band would have them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Masked-case sentinel, the value of bialign_tpu/ops/xla_dp.py INVALID.
INVALID = -(1 << 30) - (1 << 29)
# The int64 engine's sentinel, the value of bialign_tpu/ops/xla_dp.py
# INVALID64: far below NEG_INF less any path's drift at int64.
INVALID64 = -(1 << 62)


@dataclass(frozen=True)
class DeviceBand:
    """A filled band: ``ys`` is int32 ``[n+m+1, 9, W, W, n+1]`` (affine) or
    ``[n+m+1, W, W, n+1]`` (non-affine), W = 2 * max_shift + 1.  Rows off
    a diagonal's live range ``max(0, d-m) <= i <= min(n, d)`` hold
    ``INVALID`` and are never read."""

    ys: torch.Tensor
    n: int
    m: int
    max_shift: int
    affine: bool

    def cells(self, idxs) -> np.ndarray:
        """Exact values of a batch of cells, in one gather on the device.

        ``idxs``: int array ``[N, 5]`` of (q, i, j, k, l) for affine bands,
        ``[N, 4]`` of (i, j, k, l) otherwise, with absolute k and l as in
        the reference's SparseMatrix4D (pyx:24-41).
        """
        idx = torch.as_tensor(np.asarray(idxs, dtype=np.int64),
                              device=self.ys.device)
        S = self.max_shift
        i, j = idx[:, -4], idx[:, -3]
        sk = idx[:, -2] - i + S
        sl = idx[:, -1] - j + S
        if self.affine:
            vals = self.ys[i + j, idx[:, 0], sk, sl, i]
        else:
            vals = self.ys[i + j, sk, sl, i]
        return vals.cpu().numpy()

    def final_score(self) -> int:
        """Optimal score, read from the final cell (n, m, n, m)."""
        n, m, S = self.n, self.m, self.max_shift
        if self.affine:
            return int(self.ys[n + m, :, S, S, n].max())
        return int(self.ys[n + m, S, S, n])

    def to_numpy(self) -> np.ndarray:
        """The whole band in the oracle layout H[(q,) i, j, sk, sl], int64
        (copies the band to the host: tests and the plain walk only)."""
        ys = self.ys.cpu().numpy()
        n, m = self.n, self.m
        W = 2 * self.max_shift + 1
        if self.affine:
            H = np.empty((ys.shape[1], n + 1, m + 1, W, W), dtype=np.int64)
            for i in range(n + 1):
                H[:, i] = ys[i:i + m + 1, :, :, :, i].swapaxes(0, 1)
        else:
            H = np.empty((n + 1, m + 1, W, W), dtype=np.int64)
            for i in range(n + 1):
                H[i] = ys[i:i + m + 1, :, :, i]
        return H


@dataclass(frozen=True)
class DeviceBatchBand:
    """The filled bands of the B pairs of one chunk of a bucket: ``ys`` is
    int32 ``[B, D, 9, W, W, N+1]`` (affine) or ``[B, D, W, W, N+1]``, D the
    diagonals the fill ran (at least the chunk's largest n_b + m_b + 1);
    ``ns``, ``ms``: int32 ``[B]`` on the band's device.  Pair b's genuine
    cells are its live rows ``max(0, d - m_b) <= i <= min(n_b, d)`` of its
    own diagonals ``d <= n_b + m_b``; every other cell holds whatever the
    memory held or the fill's geometry gave it, and is never read."""

    ys: torch.Tensor
    ns: torch.Tensor
    ms: torch.Tensor
    max_shift: int
    affine: bool

    @property
    def N(self) -> int:
        return self.ys.shape[-1] - 1

    @property
    def D(self) -> int:
        return self.ys.shape[1]

    def genuine(self) -> torch.Tensor:
        """bool mask of the genuine cells, broadcastable against ``ys``:
        ``[B, D, 1, 1, 1, N+1]`` (affine) or ``[B, D, 1, 1, N+1]``."""
        dev = self.ys.device
        d = torch.arange(self.D, device=dev)[None, :, None]
        i = torch.arange(self.N + 1, device=dev)[None, None, :]
        n = self.ns.long()[:, None, None]
        m = self.ms.long()[:, None, None]
        live = (i <= n) & (i <= d) & (d - i <= m)
        return live.reshape(*live.shape[:2], *[1] * (self.ys.dim() - 3),
                            self.N + 1)

    def pair(self, b: int) -> DeviceBand:
        """Pair b's own band ``[n+m+1, (9,) W, W, n+1]`` cut out of the chunk
        band (a copy; the cells that are not genuine set to INVALID, as a
        single-pair fill leaves them).  Reads the pair's lengths from the
        device: for tests and the plain walk, not for the serving path."""
        n, m = int(self.ns[b]), int(self.ms[b])
        if n + m + 1 > self.D:
            raise ValueError(f"pair {b} of lengths ({n}, {m}) has "
                             f"{n + m + 1} diagonals, the chunk band {self.D}")
        cut = torch.where(self.genuine()[b], self.ys[b], INVALID)
        return DeviceBand(ys=cut[:n + m + 1, ..., :n + 1].contiguous(), n=n,
                          m=m, max_shift=self.max_shift, affine=self.affine)
