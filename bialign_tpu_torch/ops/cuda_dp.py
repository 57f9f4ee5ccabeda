"""Single-pair band fills: CUDA kernel wrappers and their plain twins.

Counterpart of the band mode of :mod:`bialign_tpu.ops.pallas_dp` (K1
``_affine_kernel``, K2 ``_nonaffine_kernel``).  Both fills produce a
:class:`~bialign_tpu_torch.ops.band.DeviceBand` in the layout
``[n+m+1, (9,) W, W, n+1]``.

* ``fill_affine_device`` / ``fill_nonaffine_device`` launch the kernels of
  ``csrc/fill_affine.cu`` / ``csrc/fill_nonaffine.cu`` for tables on a
  CUDA device, and run the plain twin only for tables on the CPU, where no
  kernel can run.  The user's choice of engine is made in
  :class:`~bialign_tpu_torch.aligner.BiAligner`, which refuses
  ``engine="cuda"`` on the CPU and so never reaches that branch.
* ``fill_affine_plain`` / ``fill_nonaffine_plain`` are the same recurrence
  in plain PyTorch, after :mod:`bialign_tpu.ops.xla_dp`
  (``_build_affine_step``, ``_build_nonaffine_step``): a loop over
  diagonals, vectorised over rows and shifts, on any device.  They are the
  specification the kernels are held to.

Inputs are the dense score tables ``mu1``, ``mu2``: int32 ``[n+1, m+1]``
tensors on one device (:func:`bialign_tpu_torch.convert.tables_to_torch`).
The caller checks int32 safety first
(:func:`bialign_tpu.ops.cases.check_int32_safe`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bialign_tpu.ops.cases import (
    NEG_INF,
    N_STATES,
    NONAFFINE_COLS,
    STATE_BOTH_MATCH,
    STATES,
    AffineTables,
    NonAffineTables,
    iter_affine_cases,
)

from .. import _build
from .band import DeviceBand

# Masked-case sentinel, the value of bialign_tpu/ops/xla_dp.py INVALID
# (defined again here: that module imports jax).
INVALID = -(1 << 30) - (1 << 29)

# Kernel launches per wrapper (one per fill), for run reports.
LAUNCHES = {"fill_affine": 0, "fill_nonaffine": 0}

# Field order of one packed recursion case; csrc/common.cuh `Field`.
SRC, X0, X1, X2, X3, MU1C, MU2C, CST, SRCA, SRCB, REC = range(11)
N_AFFINE_CASES = 15


def affine_case_table(beta: int, gamma: int, delta: int) -> np.ndarray:
    """int32 ``[9, 15, REC]``: the affine cases of each target state in
    reference order (:func:`~bialign_tpu.ops.cases.iter_affine_cases`:
    9 group A, 3 group B, 3 group C), for the fill and walk kernels."""
    tab = np.zeros((N_STATES, N_AFFINE_CASES, REC), dtype=np.int32)
    for q in range(N_STATES):
        for ci, (src, col, mu1c, mu2c, ng, nb, nd, _g) in enumerate(
            iter_affine_cases(q)
        ):
            s = STATES[src]
            tab[q, ci] = (src, *col, mu1c, mu2c,
                          ng * gamma + nb * beta + nd * delta,
                          s[0] - s[2], s[1] - s[3])
    return tab


def nonaffine_case_table(gamma: int, delta: int) -> np.ndarray:
    """int32 ``[13, REC]``: the non-affine cases in reference order."""
    tabs = NonAffineTables(gamma, delta)
    tab = np.zeros((len(NONAFFINE_COLS), REC), dtype=np.int32)
    for ci, col in enumerate(NONAFFINE_COLS):
        tab[ci, X0:X3 + 1] = col
        tab[ci, MU1C] = tabs.mu1_coef[ci]
        tab[ci, MU2C] = tabs.mu2_coef[ci]
        tab[ci, CST] = tabs.const[ci]
    return tab


def _check_tables(mu1: torch.Tensor, mu2: torch.Tensor, max_shift: int):
    for name, mu in (("mu1", mu1), ("mu2", mu2)):
        if not isinstance(mu, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(mu)}")
        if mu.dtype != torch.int32 or mu.dim() != 2 or not mu.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D int32 tensor, got "
                f"{mu.dtype} {tuple(mu.shape)}"
            )
        if mu.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} on unsupported device {mu.device}")
    if mu1.shape != mu2.shape or mu1.device != mu2.device:
        raise ValueError(
            f"mu1 {tuple(mu1.shape)} on {mu1.device} and mu2 "
            f"{tuple(mu2.shape)} on {mu2.device} differ"
        )
    if max_shift < 0:
        raise ValueError(f"max_shift must be >= 0, got {max_shift}")


# -- kernel wrappers ---------------------------------------------------------

def fill_affine_device(mu1, mu2, max_shift, beta, gamma, delta) -> DeviceBand:
    """Affine band fill (K1 band mode): the CUDA kernel for tables on a
    CUDA device, the plain twin for tables on the CPU."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_affine_plain(mu1, mu2, max_shift, beta, gamma, delta)
    return _fill_kernel("fill_affine", affine_case_table(beta, gamma, delta),
                        mu1, mu2, max_shift, affine=True)


def fill_nonaffine_device(mu1, mu2, max_shift, gamma, delta) -> DeviceBand:
    """Non-affine band fill (K2 band mode): the CUDA kernel for tables on
    a CUDA device, the plain twin for tables on the CPU."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_nonaffine_plain(mu1, mu2, max_shift, gamma, delta)
    return _fill_kernel("fill_nonaffine", nonaffine_case_table(gamma, delta),
                        mu1, mu2, max_shift, affine=False)


def _fill_kernel(name, cases, mu1, mu2, S, *, affine) -> DeviceBand:
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    W = 2 * S + 1
    states = (N_STATES,) if affine else ()
    dev = mu1.device
    band = torch.full((n + m + 1, *states, W, W, n + 1), INVALID,
                      dtype=torch.int32, device=dev)
    cases_t = torch.from_numpy(cases).to(dev)
    _build.launch(f"bialign_{name}", dev, band, mu1, mu2, cases_t, n, m, S)
    LAUNCHES[name] += 1
    return DeviceBand(ys=band, n=n, m=m, max_shift=S, affine=affine)


# -- plain twins -------------------------------------------------------------

def _shift(x, dk: int, dl: int, di: int):
    """out[..., sk, sl, i] = x[..., sk - dk, sl - dl, i - di], INVALID where
    that index falls off the slab (every such position is guarded out)."""
    return F.pad(x, (di, -di, dl, -dl, dk, -dk), value=INVALID)


def _in_slab(idx, W: int):
    return (idx >= 0) & (idx < W)


class _Geometry:
    """Index grids of a diagonal's slab ``[W, W, P]`` and the score tables
    in diagonal layout, ``mu1d[d] = mu1[i, d-i]`` and ``mu2d[d] =
    mu2[k, l]``, 0 outside [0, n] x [0, m] (xla_dp._diag_mu_tables)."""

    def __init__(self, mu1, mu2, S: int):
        n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
        dev = mu1.device
        W, P, D = 2 * S + 1, n + 1, n + m + 1
        self.n, self.m, self.S, self.W = n, m, S, W
        i = self.i = torch.arange(P, device=dev)[None, None, :]
        sk = self.sk = torch.arange(W, device=dev)[:, None, None]
        sl = self.sl = torch.arange(W, device=dev)[None, :, None]
        k = self.k = i + sk - S
        self.t = sk + sl
        self.origin = (i == 0) & (sk == S) & (sl == S)
        j = torch.arange(D, device=dev)[:, None, None, None] - i
        l = j + sl - S                                       # [D, 1, W, P]
        self.live = (j >= 0) & (j <= m)                      # [D, 1, 1, P]
        self.mu1d = torch.where(self.live, mu1[i, j.clamp(0, m)], 0)
        ok = (k >= 0) & (k <= n) & (l >= 0) & (l <= m)
        self.mu2d = torch.where(ok, mu2[k.clamp(0, n), l.clamp(0, m)], 0)
        # the guards' terms in j and l, the only ones that change with d
        self.j_ge = [j >= 0, j >= 1]
        self.l_ge = [l >= 0, l >= 1]


def _index(rows, dev):
    return torch.as_tensor(rows, dtype=torch.long, device=dev)


def fill_affine_plain(mu1, mu2, max_shift, beta, gamma, delta) -> DeviceBand:
    """Affine band fill in plain PyTorch, on the tables' device
    (xla_dp._build_affine_step, with the band layout of the kernel)."""
    _check_tables(mu1, mu2, max_shift)
    S = max_shift
    Q = N_STATES
    g = _Geometry(mu1, mu2, S)
    n, m, W = g.n, g.m, g.W
    i, k, sk, sl = g.i, g.k, g.sk, g.sl
    dev = mu1.device
    tabs = AffineTables(beta, gamma, delta)

    def consts(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)[
            ..., None, None, None]

    a_const = consts(tabs.a_const)         # [Q, Q, 1, 1, 1]
    b_const = consts(tabs.b_const)         # [Q, 3, 1, 1, 1]
    c_const = consts(tabs.c_const)
    b_src = [_index(r, dev) for r in tabs.b_src]
    c_src = [_index(r, dev) for r in tabs.c_src]
    # the guards' terms that do not change with d, per target state
    gA, gC, gB = [], [], []
    for a, b, c, e in STATES:
        gA.append((i >= a) & (k >= c) & _in_slab(sk - c + a, W)
                  & _in_slab(sl - e + b, W))
        gC.append((i >= a) & (sk + a < W) & (sl + b < W))
        gB.append((k >= c) & (sk >= c) & (sl >= e))
    # targets whose group B is live somewhere on shift anti-diagonal t
    b_live = [[q for q, (_a, _b, c, e) in enumerate(STATES)
               if any(sk_ >= c and t - sk_ >= e for sk_ in range(W)
                      if 0 <= t - sk_ < W)]
              for t in range(4 * S + 1)]
    init = torch.full((Q, 1, 1, 1), NEG_INF, dtype=torch.int32, device=dev)
    init[STATE_BOTH_MATCH] = 0
    no_origin = torch.zeros_like(g.origin)

    band = torch.empty((n + m + 1, Q, W, W, n + 1), dtype=torch.int32,
                       device=dev)
    vm1 = vm2 = torch.full((Q, W, W, n + 1), INVALID, dtype=torch.int32,
                           device=dev)
    for d in range(n + m + 1):
        mu1_row, mu2_blk = g.mu1d[d], g.mu2d[d]
        j_ge, l_ge = [x[d] for x in g.j_ge], [x[d] for x in g.l_ge]
        best = torch.empty((Q, W, W, n + 1), dtype=torch.int32, device=dev)
        for q in range(Q):
            a, b, c, e = STATES[q]
            pred = vm1 if a + b == 1 else vm2
            # group A: full column q from all 9 sources (pyx:275-279)
            agg = (_shift(pred, c - a, e - b, a) + a_const[q]).amax(0)
            if tabs.mu1_coef[q]:
                agg = agg + mu1_row
            if tabs.mu2_coef[q]:
                agg = agg + mu2_blk
            cA = torch.where(gA[q] & j_ge[b] & l_ge[e], agg, INVALID)
            # group C: seq-only half column (a, b, 0, 0) (pyx:291-296)
            aggC = (_shift(pred.index_select(0, c_src[q]), -a, -b, a)
                    + c_const[q]).amax(0)
            if tabs.c_mu1_coef[q]:
                aggC = aggC + mu1_row
            cC = torch.where(gC[q] & j_ge[b], aggC, INVALID)
            best[q] = torch.maximum(cA, cC)
        val = torch.where(best == INVALID, NEG_INF, best)
        protect = g.origin if d == 0 else no_origin
        val = torch.where(protect, init, val)

        # group B: str-only half columns (0, 0, c, e) within the diagonal;
        # sources lie at smaller t = sk + sl, so ascending t finalises them
        # before they are read (pyx:281-290)
        for t in range(1, 4 * S + 1):
            commit = (g.t == t) & ~protect
            for q in b_live[t]:
                _a, _b, c, e = STATES[q]
                aggB = (_shift(val.index_select(0, b_src[q]), c, e, 0)
                        + b_const[q]).amax(0)
                if tabs.b_mu2_coef[q]:
                    aggB = aggB + mu2_blk
                bq = torch.maximum(
                    best[q], torch.where(gB[q] & l_ge[e], aggB, INVALID))
                vq = torch.where(bq == INVALID, NEG_INF, bq)
                best[q] = torch.where(commit, bq, best[q])
                val[q] = torch.where(commit, vq, val[q])

        val = torch.where(g.live[d], val, INVALID)
        band[d] = val
        vm1, vm2 = val, vm1
    return DeviceBand(ys=band, n=n, m=m, max_shift=S, affine=True)


def fill_nonaffine_plain(mu1, mu2, max_shift, gamma, delta) -> DeviceBand:
    """Non-affine band fill in plain PyTorch, on the tables' device
    (xla_dp._build_nonaffine_step, with the band layout of the kernel)."""
    _check_tables(mu1, mu2, max_shift)
    S = max_shift
    g = _Geometry(mu1, mu2, S)
    n, m, W = g.n, g.m, g.W
    i, k, sk, sl = g.i, g.k, g.sk, g.sl
    dev = mu1.device
    tab = NonAffineTables(gamma, delta)
    # (column, constant, mu1 and mu2 multiplicities, guard terms fixed in d)
    external, internal = [], []
    for ci, (x0, x1, x2, x3) in enumerate(NONAFFINE_COLS):
        case = ((x0, x1, x2, x3), int(tab.const[ci]), int(tab.mu1_coef[ci]),
                int(tab.mu2_coef[ci]))
        if x0 or x1:
            external.append(case + ((i >= x0) & (k >= x2)
                                    & _in_slab(sk - x2 + x0, W)
                                    & _in_slab(sl - x3 + x1, W),))
        else:
            internal.append(case + ((k >= x2) & (sk >= x2) & (sl >= x3),))
    no_origin = torch.zeros_like(g.origin)

    band = torch.empty((n + m + 1, W, W, n + 1), dtype=torch.int32,
                       device=dev)
    vm1 = vm2 = torch.full((W, W, n + 1), INVALID, dtype=torch.int32,
                           device=dev)
    for d in range(n + m + 1):
        mu1_row, mu2_blk = g.mu1d[d], g.mu2d[d]
        j_ge, l_ge = [x[d] for x in g.j_ge], [x[d] for x in g.l_ge]
        best = torch.full((W, W, n + 1), INVALID, dtype=torch.int32,
                          device=dev)
        for (x0, x1, x2, x3), const, m1c, m2c, fixed in external:
            pred = vm1 if x0 + x1 == 1 else vm2
            contrib = _shift(pred, x2 - x0, x3 - x1, x0) + const
            if m1c:
                contrib = contrib + mu1_row
            if m2c:
                contrib = contrib + mu2_blk
            ok = fixed & j_ge[x1] & l_ge[x3]
            best = torch.maximum(best, torch.where(ok, contrib, INVALID))
        val = torch.where(best == INVALID, NEG_INF, best)
        protect = g.origin if d == 0 else no_origin
        val = torch.where(protect, 0, val)

        # the 4 str-only columns, within the diagonal in ascending t
        for t in range(1, 4 * S + 1):
            commit = (g.t == t) & ~protect
            b2 = best
            for (_x0, _x1, x2, x3), const, _m1c, m2c, fixed in internal:
                contrib = _shift(val, x2, x3, 0) + const
                if m2c:
                    contrib = contrib + mu2_blk
                b2 = torch.maximum(
                    b2, torch.where(fixed & l_ge[x3], contrib, INVALID))
            best = torch.where(commit, b2, best)
            val = torch.where(commit, torch.where(b2 == INVALID, NEG_INF, b2),
                              val)

        val = torch.where(g.live[d], val, INVALID)
        band[d] = val
        vm1, vm2 = val, vm1
    return DeviceBand(ys=band, n=n, m=m, max_shift=S, affine=False)
