"""Handle of a filled DP band held in a torch tensor.

Counterpart of :class:`bialign_tpu.ops.band.DeviceBand`.  The fills of
:mod:`bialign_tpu_torch.ops.cuda_dp` write the band diagonal-major with the
lattice row last, ``ys[d, (q,) sk, sl, i]`` with ``d = i + j``,
``sk = k - i + S`` and ``sl = l - j + S``: the JAX Pallas layout without
its 128-lane padding and bucketed diagonal count.  The band stays on its
device; only the cells asked for, or the score, are copied to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
