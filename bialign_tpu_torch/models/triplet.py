"""Triplet bi-alignment: one copy of A vs two copies of B.

Counterpart of :mod:`bialign_tpu.models.triplet` (the reference's legacy
``BiAlignerTriplet``, bialign_triplet.py:12-153, made to work there).  The
DP is 3-dimensional: ``M[i, j, k]`` with ``i`` over A, ``j``/``k`` over two
copies of B (the sequence-alignment copy and the structure-alignment copy),
banded by ``|k - j| <= max_shift``.

Seven cases per cell (reference order, bialign_triplet.py:28-35), with the
flat (non-affine) gap model of the main aligner:

    (1,1,1)  mu1(i,j) + mu2(i,k)          synchronous match
    (1,0,0)  2*gamma                       A advances alone
    (0,1,1)  2*gamma                       both Bs advance
    (1,1,0)  mu1(i,j) + gamma + Delta      seq-match, str-gap (shift)
    (1,0,1)  mu2(i,k) + gamma + Delta      str-match, seq-gap (shift)
    (0,1,0)  gamma + Delta
    (0,0,1)  gamma + Delta

Engines: the CUDA kernels of ``csrc/triplet.cu`` (:func:`fill_slabs_cuda`,
the counterpart of the JAX package's XLA scan ``fill_xla``: one CTA runs
the anti-diagonal wavefront over ``d = i + j``, a thread its rows, on the
tables in their own layout; route ``"shared"`` keeps the last three
diagonals in shared memory, route ``"global"`` reads them back from the
slabs, for pairs whose ring does not fit one CTA: :func:`triplet_route`),
its plain PyTorch twin on any device (:func:`fill_slabs`, and
:func:`fill_torch` in the oracle's layout), both with the band offset ``sk
= k - j + S`` on a small axis, and a numpy oracle (``fill_oracle``, a copy
of the original).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ops.cases import NEG_INF
from ..ops.cuda_dp import CTA_SHARED_LIMIT

# case columns (di, dj, dk) in reference enumeration order
TRIPLET_COLS = (
    (1, 1, 1),
    (1, 0, 0),
    (0, 1, 1),
    (1, 1, 0),
    (1, 0, 1),
    (0, 1, 0),
    (0, 0, 1),
)

# the sentinel of an empty maximum inside the wavefront (fill_xla's)
INVALID = -(1 << 30) - (1 << 29)

# Launches of csrc/triplet.cu (one a fill), by route, for run reports.
LAUNCHES = {"triplet_fill_shared": 0, "triplet_fill_global": 0}
ROUTES = ("shared", "global")
# Threads of the kernel's one CTA: at most, and a multiple of a warp.
MAX_THREADS, WARP = 1024, 32
# max_shift compiled as constants (csrc/triplet.cu kTripletStaticShifts):
# up to it route "shared" keeps a row's tables in registers
STATIC_SHIFTS = 8


def _case_consts(gamma: int, delta: int):
    """(const, mu1_coef, mu2_coef) per case."""
    return [
        (0, 1, 1),
        (2 * gamma, 0, 0),
        (2 * gamma, 0, 0),
        (gamma + delta, 1, 0),
        (gamma + delta, 0, 1),
        (gamma + delta, 0, 0),
        (gamma + delta, 0, 0),
    ]


def fill_oracle(mu1, mu2, max_shift, gamma, delta):
    """Cell-by-cell fill; returns M[i, j, k] (full (m+1)^2 plane, cells
    outside the band stay 0 and are never read)."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    consts = _case_consts(gamma, delta)

    M = np.zeros((n + 1, m + 1, m + 1), dtype=np.int64)
    for i in range(n + 1):
        for j in range(m + 1):
            for k in range(max(0, j - S), min(m + 1, j + S + 1)):
                if (i, j, k) == (0, 0, 0):
                    continue
                best = None
                for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
                    pi, pj, pk = i - di, j - dj, k - dk
                    if pi < 0 or pj < 0 or pk < 0:
                        continue
                    if abs(pk - pj) > S:
                        continue
                    cst, m1, m2 = consts[ci]
                    val = (
                        M[pi, pj, pk] + cst
                        + m1 * int(mu1[i, j]) + m2 * int(mu2[i, k])
                    )
                    if best is None or val > best:
                        best = val
                M[i, j, k] = best if best is not None else NEG_INF
    return M


def _shift(arr: torch.Tensor, di: int, dsk: int) -> torch.Tensor:
    """``out[i, sk] = arr[i - di, sk - dsk]``, INVALID where that lies off
    the slab."""
    P, W = arr.shape
    out = torch.full_like(arr, INVALID)
    out[max(di, 0):P + min(di, 0), max(dsk, 0):W + min(dsk, 0)] = \
        arr[max(-di, 0):P - max(di, 0), max(-dsk, 0):W - max(dsk, 0)]
    return out


def fill_slabs(mu1, mu2, max_shift, gamma, delta, *, device="cuda"):
    """The wavefront over anti-diagonals d = i + j, in plain PyTorch on
    ``device``; returns the slabs ``ys[d, i, sk]`` int32 ``[n+m+1, n+1,
    2S+1]`` on that device: M[i, d - i, d - i + sk - S].

    Per diagonal the slab is V[P, W] with P = n+1 lattice rows and W = 2S+1
    band offsets sk = k - j + S.  Cases advancing i or j read the two
    previous diagonals; the k-only case (0,0,1) moves *within* the diagonal
    toward larger sk, resolved by a short sweep (dependencies strictly
    increase sk).  Step for step the arithmetic of the JAX package's
    ``fill_xla`` (int32, the same sentinels)."""
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    S = max_shift
    W = 2 * S + 1
    P = n + 1
    D = n + m + 1
    consts = _case_consts(gamma, delta)
    mu1 = np.asarray(mu1)
    mu2 = np.asarray(mu2)

    # diagonal tables: MU1D[d, i] = mu1[i, d-i]; MU2D[d, i, sk] =
    # mu2[i, (d-i)+sk-S]
    d_ = np.arange(D)[:, None]
    i_ = np.arange(P)[None, :]
    j_ = d_ - i_
    ok = (j_ >= 0) & (j_ <= m)
    MU1D = np.where(ok, mu1[np.minimum(i_, n), np.clip(j_, 0, m)], 0)
    k_ = j_[:, :, None] + np.arange(W)[None, None, :] - S
    ok2 = (k_ >= 0) & (k_ <= m) & ok[:, :, None]
    MU2D = np.where(
        ok2, mu2[np.minimum(i_, n)[:, :, None], np.clip(k_, 0, m)], 0
    )
    mu1d = torch.from_numpy(MU1D.astype(np.int32)).to(device)
    mu2d = torch.from_numpy(MU2D.astype(np.int32)).to(device)

    i_ar = torch.arange(P, dtype=torch.int32, device=device)[:, None]
    sk_ar = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    origin = (i_ar == 0) & (sk_ar == S)
    internal = TRIPLET_COLS.index((0, 0, 1))
    # the guards of each case that do not depend on d
    fixed = [(i_ar >= di) & (sk_ar - dk + dj >= 0) & (sk_ar - dk + dj < W)
             for di, dj, dk in TRIPLET_COLS]

    ys = torch.empty((D, P, W), dtype=torch.int32, device=device)
    vm1 = torch.full((P, W), INVALID, dtype=torch.int32, device=device)
    vm2 = vm1.clone()
    for d in range(D):
        j_a = d - i_ar
        k_a = j_a + sk_ar - S
        j_ge = (j_a >= 0, j_a >= 1)
        k_ge = (k_a >= 0, k_a >= 1)
        mu1_row = mu1d[d][:, None]
        mu2_blk = mu2d[d]

        best = torch.full((P, W), INVALID, dtype=torch.int32, device=device)
        # external cases (advance i or j): predecessor diagonal d - di - dj
        for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
            if ci == internal:
                continue  # swept below
            cst, m1, m2 = consts[ci]
            pred = vm1 if di + dj == 1 else vm2
            # sk' = (k-dk) - (j-dj) + S = sk + dj - dk, so the slab
            # shifts by dk - dj along the band axis
            shifted = _shift(pred, di, dk - dj)
            g = fixed[ci] & j_ge[dj] & k_ge[dk]
            contrib = shifted + cst + m1 * mu1_row + m2 * mu2_blk
            best = torch.maximum(best, torch.where(g, contrib, INVALID))

        val = torch.where(best == INVALID, NEG_INF, best)
        protect = origin if d == 0 else torch.zeros_like(origin)
        val = torch.where(protect, 0, val)

        # internal case (0,0,1): k advances within the diagonal
        # (sk' = sk - 1); dependencies strictly increase sk
        cst = consts[internal][0]
        g = k_ge[1] & (sk_ar >= 1)
        for t in range(1, W):
            commit = (sk_ar == t) & ~protect
            contrib = torch.where(g, _shift(val, 0, 1) + cst, INVALID)
            b2 = torch.maximum(best, contrib)
            v2 = torch.where(b2 == INVALID, NEG_INF, b2)
            best = torch.where(commit, b2, best)
            val = torch.where(commit, v2, val)

        ys[d] = val
        vm1, vm2 = val, vm1
    return ys


def _int32(x: int) -> int:
    """``x`` reduced to int32, as torch adds a Python int to an int32
    tensor."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def default_threads(n: int) -> int:
    """The kernel's threads for n+1 rows: a thread a row, in whole warps,
    up to :data:`MAX_THREADS` (beyond, a thread takes every T-th row)."""
    return min(MAX_THREADS, -(-(n + 1) // WARP) * WARP)


def shared_bytes(n: int, max_shift: int, threads=None) -> int:
    """Dynamic shared memory of route ``"shared"`` on n+1 rows at
    ``threads`` threads (default :func:`default_threads`): the ring of the
    last three diagonals ``[3, n+1, W]`` int32, and, when a thread takes
    several rows or max_shift exceeds :data:`STATIC_SHIFTS`, the tables'
    anti-diagonals ``[W+3, n+1]`` (``csrc/triplet.cu``
    ``triplet_shared_bytes``)."""
    threads = default_threads(n) if threads is None else int(threads)
    W = 2 * max_shift + 1
    staged = max_shift > STATIC_SHIFTS or n + 1 > threads
    return 4 * (n + 1) * (3 * W + (W + 3 if staged else 0))


def triplet_route(n: int, max_shift: int, threads=None) -> str:
    """The kernel of a pair of n+1 rows: ``"shared"`` when its
    :func:`shared_bytes` fit one CTA's shared memory, else ``"global"``.
    Chosen from the shape before the launch, never after a failure."""
    fits = shared_bytes(n, max_shift, threads) <= CTA_SHARED_LIMIT
    return "shared" if fits else "global"


def skew_rows(n: int, m: int, max_shift: int) -> int:
    """Rows of route ``"shared"``'s skewed tables (``csrc/triplet.cu``
    ``triplet_skew_rows``): the diagonals e = i + k the kernel reads, with
    room for its loads four diagonals ahead."""
    return n + m + max_shift + 8


def shared_tables(mu1, mu2, max_shift, device) -> tuple:
    """The tables ``[n+1, m+1]`` (numpy or tensors) as route ``"shared"``
    reads them: int32 on ``device``, each skewed, ``X[e, i] = mu[i, e -
    i]`` for :func:`skew_rows` rows e and 0 where ``e - i`` lies outside
    ``[0, m]``, flat.  Row e holds what diagonal e brings to every row, so
    that a warp's rows read it side by side."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    E, P = skew_rows(n, m, int(max_shift)), n + 1
    out = []
    for mu in (mu1, mu2):
        x = torch.zeros(E * P, dtype=torch.int32, device=device)
        # (i, k) at (i + k) P + i: rows P+1 apart, columns P apart
        x.as_strided((P, m + 1), (P + 1, P)).copy_(
            torch.as_tensor(mu).to(device=device, dtype=torch.int32))
        out.append(x)
    return tuple(out)


def fill_slabs_cuda(mu1, mu2, max_shift, gamma, delta, *, device="cuda",
                    threads=None, ys=None, route=None):
    """:func:`fill_slabs` by a CUDA kernel of ``csrc/triplet.cu`` on a CUDA
    ``device``: the tables ``[n+1, m+1]`` (numpy or tensors) go to the card
    once as int32, one launch of one CTA of ``threads`` threads (default
    :func:`default_threads`) fills ``ys`` int32 ``[n+m+1, n+1, 2S+1]`` on
    the card.  ``route`` (default :func:`triplet_route`): ``"shared"``, the
    last three diagonals in shared memory, the tables skewed by
    :func:`shared_tables`; ``"global"``, read back from ``ys``.
    A forced ``"shared"`` that does not fit one CTA raises ``ValueError``.
    Only the cells of the domain (rows ``max(0, d-m) <= i <= min(n, d)``,
    ``0 <= k <= m``) are written, so ``ys`` (default: fresh memory) keeps
    whatever it held elsewhere.  The arguments are checked on any device;
    on a CPU ``device`` the plain twin :func:`fill_slabs` runs instead: no
    kernel runs there."""
    if len(mu1.shape) != 2 or tuple(mu1.shape) != tuple(mu2.shape):
        raise ValueError(f"mu1 {tuple(mu1.shape)} and mu2 "
                         f"{tuple(mu2.shape)} must be one 2-D shape")
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    S = int(max_shift)
    if S < 0:
        raise ValueError(f"max_shift must be >= 0, got {S}")
    threads = default_threads(n) if threads is None else int(threads)
    if not 1 <= threads <= MAX_THREADS:
        raise ValueError(f"threads must be 1-{MAX_THREADS}, got {threads}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got "
                         f"{route!r}")
    if route == "shared" and triplet_route(n, S, threads) != "shared":
        raise ValueError(
            f"route='shared': {n + 1} rows at max_shift {S} on {threads} "
            f"threads need {shared_bytes(n, S, threads)} bytes of shared "
            f"memory, one CTA has {CTA_SHARED_LIMIT}; use route='global'")
    route = triplet_route(n, S, threads) if route is None else route
    device = torch.device(device)
    if device.type == "cpu":
        return fill_slabs(mu1, mu2, max_shift, gamma, delta, device=device)
    if route == "shared":
        t1, t2 = shared_tables(mu1, mu2, S, device)
    else:
        t1, t2 = (torch.as_tensor(mu).to(device=device, dtype=torch.int32)
                  .contiguous() for mu in (mu1, mu2))
    shape = (n + m + 1, n + 1, 2 * S + 1)
    if ys is None:
        ys = torch.empty(shape, dtype=torch.int32, device=device)
    elif (ys.shape != shape or ys.dtype != torch.int32
          or ys.device != t1.device or not ys.is_contiguous()):
        raise ValueError(f"ys must be a contiguous int32 tensor {shape} on "
                         f"{t1.device}, got {ys.dtype} {tuple(ys.shape)} on "
                         f"{ys.device}")
    name = ("bialign_triplet_fill_shared" if route == "shared"
            else "bialign_triplet_fill")
    _build.launch(name, t1.device, ys, t1, t2, n, m, S, _int32(2 * gamma),
                  _int32(gamma + delta), threads)
    LAUNCHES[f"triplet_fill_{route}"] += 1
    return ys


def domain(n: int, m: int, S: int, device="cpu") -> torch.Tensor:
    """bool ``[n+m+1, n+1, 2S+1]``: the cells of the slabs that a fill
    writes and the traceback reads, ``0 <= j = d - i <= m`` and ``0 <= k =
    j + sk - S <= m``."""
    d = torch.arange(n + m + 1, device=device)[:, None, None]
    i = torch.arange(n + 1, device=device)[None, :, None]
    sk = torch.arange(2 * S + 1, device=device)[None, None, :]
    j = d - i
    k = j + sk - S
    return (j >= 0) & (j <= m) & (k >= 0) & (k <= m)


def oracle_layout(ys: np.ndarray, n: int, m: int, S: int) -> np.ndarray:
    """The slabs ``ys[d, i, sk]`` as M[i, j, k] int64 in the oracle's
    layout (full (m+1)^2 plane, 0 outside the band)."""
    W = 2 * S + 1
    i, j, sk = np.meshgrid(np.arange(n + 1), np.arange(m + 1), np.arange(W),
                           indexing="ij")
    k = j + sk - S
    ok = (k >= 0) & (k <= m)
    M = np.zeros((n + 1, m + 1, m + 1), dtype=np.int64)
    M[i[ok], j[ok], k[ok]] = ys[(i + j)[ok], i[ok], sk[ok]]
    return M


def fill_torch(mu1, mu2, max_shift, gamma, delta, *, device="cuda"):
    """:func:`fill_slabs` on ``device``, returned as M in the oracle's
    layout (host numpy int64), the contract of the JAX ``fill_xla``."""
    ys = fill_slabs(mu1, mu2, max_shift, gamma, delta, device=device)
    return oracle_layout(ys.cpu().numpy(), mu1.shape[0] - 1,
                         mu1.shape[1] - 1, max_shift)


class _BandCells:
    """M[i, j, k] read from the slabs ``ys[d, i, sk]`` of
    :func:`fill_slabs` (host numpy): the band without the (n+1)(m+1)^2
    plane of the oracle's layout."""

    def __init__(self, ys: np.ndarray, S: int):
        self.ys = ys
        self.S = S

    def __getitem__(self, cell):
        i, j, k = cell
        return self.ys[i + j, i, k - j + self.S]


class BiAlignerTriplet:
    """Working triplet aligner with the reference's intended surface:
    ``optimize()``, ``traceback()``, ``decode_trace(show_structures=)``,
    ``eval_trace()`` (bialign_triplet.py:44-124).

    ``engine="cuda"`` (default) fills with the CUDA kernel
    (:func:`fill_slabs_cuda`, its route by :func:`triplet_route`) on
    ``device`` (default ``"cuda"``), keeping the band's slabs only; it is
    refused on a CPU ``device`` or where there is no CUDA device, and a
    failed build or launch raises: it never gives way to the twin.
    ``engine="torch"`` fills with the plain twin :func:`fill_slabs` on
    ``device`` (refused on ``"cuda"`` where there is none);
    ``engine="numpy"`` with the host oracle :func:`fill_oracle` (the JAX
    package's default engine), which ignores ``device``."""

    ENGINES = ("cuda", "torch", "numpy")

    def __init__(self, seqA, seqB, strA, strB, *, engine: str = "cuda",
                 device="cuda", **params):
        from ..aligner import PARAM_DEFAULTS
        from .molecule import preprocess_molecule
        from ..scoring.tables import build_score_tables

        if engine not in self.ENGINES:
            raise ValueError(f"engine must be one of {self.ENGINES}, got "
                             f"{engine!r}")
        self._params = dict(PARAM_DEFAULTS)
        self._params.update(params)
        self._engine = engine
        self.device = torch.device(device)
        if engine == "cuda" and self.device.type != "cuda":
            raise RuntimeError(
                f"engine='cuda' runs on a CUDA device, got "
                f"device={str(self.device)!r}; engine='torch' runs the plain "
                "wavefront there")
        if (engine != "numpy" and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"engine={engine!r} on device={str(self.device)!r} needs a "
                "CUDA device (CUDA available: False); engine='torch', "
                "device='cpu' runs the wavefront on the CPU")
        is_rna = self._params["type"] == "RNA"
        self.molA = preprocess_molecule(seqA, strA, is_rna=is_rna)
        self.molB = preprocess_molecule(seqB, strB, is_rna=is_rna)
        self.mu1, self.mu2 = build_score_tables(
            self.molA, self.molB, self._params, is_rna=is_rna
        )
        self.gamma = int(self._params["gap_cost"])
        self.delta = int(self._params["shift_cost"])
        self.max_shift = int(self._params["max_shift"])
        self.M = None

    def optimize(self):
        if self._engine == "numpy":
            self.M = fill_oracle(
                self.mu1, self.mu2, self.max_shift, self.gamma, self.delta
            )
        else:
            fill = fill_slabs_cuda if self._engine == "cuda" else fill_slabs
            ys = fill(self.mu1, self.mu2, self.max_shift, self.gamma,
                      self.delta, device=self.device)
            self.M = _BandCells(ys.cpu().numpy(), self.max_shift)
        n = self.molA["len"]
        m = self.molB["len"]
        return int(self.M[n, m, m])

    def traceback(self):
        """First-match depth-first walk (bialign_triplet.py:62-77),
        iterative."""
        if self.M is None:
            self.optimize()
        S = self.max_shift
        consts = _case_consts(self.gamma, self.delta)
        i, j, k = self.molA["len"], self.molB["len"], self.molB["len"]
        trace = []
        while True:
            advanced = False
            for ci, (di, dj, dk) in enumerate(TRIPLET_COLS):
                pi, pj, pk = i - di, j - dj, k - dk
                if pi < 0 or pj < 0 or pk < 0 or abs(pk - pj) > S:
                    continue
                cst, m1, m2 = consts[ci]
                val = (
                    int(self.M[pi, pj, pk]) + cst
                    + m1 * int(self.mu1[i, j]) + m2 * int(self.mu2[i, k])
                )
                if val == int(self.M[i, j, k]):
                    trace.append((di, dj, dk))
                    i, j, k = pi, pj, pk
                    advanced = True
                    break
            if not advanced:
                break
        return list(reversed(trace))

    def decode_trace(self, trace=None, show_structures=False):
        """Three gapped rows (A, B-seq-copy, B-str-copy); with
        ``show_structures`` each row is preceded by its gapped structure
        (bialign_triplet.py:81-105)."""
        from ..render.decode import transfer_gaps

        if trace is None:
            trace = self.traceback()
        mols = (self.molA, self.molB, self.molB)
        pos = [0] * 3
        alignment = [""] * 3
        for y in trace:
            for s in range(3):
                if y[s] == 0:
                    alignment[s] += "-"
                else:
                    alignment[s] += mols[s]["seq"][pos[s]]
                    pos[s] += 1
        if not show_structures:
            return alignment
        anno = []
        for alistr, mol in zip(alignment, mols):
            anno.append(transfer_gaps(alistr, mol["structure"]))
            anno.append(alistr)
        return anno

    def eval_trace(self, trace=None):
        if trace is None:
            trace = self.traceback()
        consts = _case_consts(self.gamma, self.delta)
        pos = [0] * 3
        for y in trace:
            for s in range(3):
                pos[s] += y[s]
            ci = TRIPLET_COLS.index(tuple(y))
            cst, m1, m2 = consts[ci]
            case_score = (
                cst + m1 * int(self.mu1[pos[0], pos[1]])
                + m2 * int(self.mu2[pos[0], pos[2]])
            )
            total = int(self.M[tuple(pos)])
            yield " ".join(
                str(x) for x in [pos, tuple(y), case_score, "-->", total]
            )
