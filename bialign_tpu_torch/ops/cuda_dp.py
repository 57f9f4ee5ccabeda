"""Band fills and band-free scores of one pair, and the scores or the bands
of a bucket of pairs: CUDA kernel wrappers and their plain twins.

Counterpart of :mod:`bialign_tpu.ops.pallas_dp`: the single-pair kernels K1
``_affine_kernel`` and K2 ``_nonaffine_kernel`` in band mode and in
score-only mode and K3 ``_affine_ms0_kernel`` (affine, ``max_shift`` 0,
score only); the batched kernels K4 ``_affine_batched_kernel`` and K5
``_nonaffine_batched_kernel`` in score mode and in band mode, and in score
mode K6 ``_packed_batched_kernel``, K7 ``_packed_ms0_kernel`` and K8
``_conveyor_kernel``, with the routing of ``_route_batched``; and
``_mu_planes_from_codes``, the tables of a bucket built on the device.

* ``fill_affine_device`` / ``fill_nonaffine_device`` produce a
  :class:`~bialign_tpu_torch.ops.band.DeviceBand` in the layout
  ``[n+m+1, (9,) W, W, n+1]`` (``csrc/fill_affine.cu``,
  ``csrc/fill_nonaffine.cu``).
* ``affine_score`` / ``nonaffine_score`` return the optimal score and keep
  no band: the kernels (``csrc/score_affine.cu``, ``csrc/score_nonaffine.cu``
  and, for ``affine_score`` at ``max_shift`` 0, ``csrc/score_affine_ms0.cu``)
  carry a ring of three diagonal slabs ``[3, (9,) W, W, n+1]``, diagonal
  ``d`` in slab ``d % 3``.  ``*_last_slab`` return the slab of the last
  diagonal, from which the score is read outside the kernel.  K3 has three
  routes (``route=``, :func:`batch_route` at B = 1): ``"cta"``, one launch,
  the ring in one CTA's shared memory, for the pairs of fewer than
  :data:`MS0_RESIDENT_ROWS` rows (and, forced, for any that fits one CTA,
  up to 4096 rows); ``"resident"``, one cooperative launch of up to a CTA
  a SM, each CTA its own rows and the row above them through device
  memory under progress flags, for the longer ones
  (:func:`ms0_resident_shape`); ``"grid"``, one launch per diagonal on the
  ring in device memory, only when forced.
* ``affine_batch_scores`` / ``nonaffine_batch_scores`` return the ``[B]``
  scores of a bucket: a zero-padded stack of tables ``[B, N+1, M+1]`` with
  the pairs' own lengths ``ns``, ``ms``.  Three routes
  (:func:`batch_route`): ``"cta"``, one launch per bucket, one CTA per pair
  with the ring in shared memory, the CTA computing each diagonal with the
  tile kernels' per-value functions (``csrc/cta_scores.cu`` K6; affine at
  ``max_shift`` 0 ``csrc/cta_scores_ms0.cu`` K7, K3's kernel, a thread a
  row), taken when a pair fits one CTA (:func:`cta_fits`);
  ``"conveyor"``, for the other buckets of two pairs or more: the pairs
  stream through a few rings in device memory (``lanes``), one behind the
  other, one launch per step (``csrc/conveyor_scores.cu`` K8); ``"grid"``,
  one launch per bucket diagonal over all pairs, each on its own ring in
  device memory (``csrc/batch_affine.cu`` K4, ``csrc/batch_nonaffine.cu``
  K5).
* ``affine_batch_bands`` / ``nonaffine_batch_bands`` return the bands of a
  bucket's pairs, a :class:`~bialign_tpu_torch.ops.band.DeviceBatchBand`
  ``[B, D, (9,) W, W, N+1]``, with the scores: K4 and K5 in band mode, the
  per-diagonal kernels writing every diagonal into the pair's band, which
  the batched walks of :mod:`~bialign_tpu_torch.ops.device_traceback` read.
* :func:`mu_planes_from_codes` builds a bucket's stacks from the pairs'
  residue and structure codes and a 256 x 256 table, by exact int32
  indexing.
* Each wrapper launches its kernel for tables on a CUDA device, and runs
  the plain twin only for tables on the CPU, where no kernel can run.  The
  user's choice of engine is made in
  :class:`~bialign_tpu_torch.aligner.BiAligner`, which refuses
  ``engine="cuda"`` on the CPU and so never reaches that branch.
* ``*_plain`` are the same recurrences in plain PyTorch, after
  :mod:`bialign_tpu.ops.xla_dp` (``_build_affine_step``,
  ``_build_nonaffine_step``): a loop over diagonals, vectorised over rows
  and shifts, on any device.  Band and score share one per-diagonal step.
  The band fills also run at int64 (``dtype=torch.int64``, the sentinel
  ``INVALID64``): the engine :class:`~bialign_tpu_torch.aligner.BiAligner`
  takes for tables that fail the int32 check, as the JAX package's int64
  XLA fill.
  The batch twins run the same steps with a leading batch axis, in the
  bucket's geometry, and the conveyor twins with a per-row diagonal index,
  in the conveyor's.  They are the specification the kernels are held to.

Inputs are the dense score tables ``mu1``, ``mu2``: int32 ``[n+1, m+1]``
tensors on one device (:func:`bialign_tpu_torch.convert.tables_to_torch`).
The fills' caller checks int32 safety first
(:func:`bialign_tpu_torch.ops.cases.check_int32_safe`); the scores check it
themselves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .band import INVALID, INVALID64, DeviceBand, DeviceBatchBand
from .cases import (
    NEG_INF,
    N_STATES,
    NONAFFINE_COLS,
    STATE_BOTH_MATCH,
    STATES,
    AffineTables,
    NonAffineTables,
    check_int32_safe,
    iter_affine_cases,
)

# Kernel launches per wrapper (one per fill, score or bucket), for run
# reports; "score_affine_ms0" counts K3 on route "cta", "_resident" on the
# cooperative grid, "_grid" on the per-diagonal route, "cta_scores" both
# forms of K6, "conveyor_scores" of K8, "batch_fill_*" K4 and K5 in band
# mode.
LAUNCHES = {"fill_affine": 0, "fill_nonaffine": 0, "score_affine": 0,
            "score_nonaffine": 0, "score_affine_ms0": 0,
            "score_affine_ms0_resident": 0,
            "score_affine_ms0_grid": 0, "batch_affine": 0,
            "batch_nonaffine": 0, "cta_scores": 0, "cta_scores_ms0": 0,
            "conveyor_scores": 0, "batch_fill_affine": 0,
            "batch_fill_nonaffine": 0}

RING = 3      # slabs of the score-only carry; csrc/common.cuh RING

# Field order of one packed recursion case; csrc/common.cuh `Field`.
SRC, X0, X1, X2, X3, MU1C, MU2C, CST, SRCA, SRCB, REC = range(11)
N_AFFINE_CASES = 15

# Shared memory one CTA can have on an H100 (227 KB of the SM's 256 KB),
# which decides the route of a bucket, and its most threads.
CTA_SHARED_LIMIT = 232448
CTA_MAX_THREADS = 1024
# rows one CTA of K3/K7 holds: four a thread (csrc/cta_scores.cuh
# kMs0RowsPerThread), whose table chunks sit in registers
MS0_CTA_ROWS = 4 * CTA_MAX_THREADS
# rows from which one pair's K3 takes route "resident" though one CTA holds
# it (batch_route): in turns on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py --resident-only, PERF.md §6), one CTA took
# 0.65-0.73 ms at 512 x 510, 2.14-2.16 at 1024 x 1014, 7.07-7.09 at 2048 x
# 2038 and 18.86-18.95 at 4000 x 3990; "resident" 1.07-1.15, 1.77-1.81,
# 3.26-3.32 and 6.29-6.35
MS0_RESIDENT_ROWS = 1024
# "resident" is K3's alone: one pair's score at affine max_shift 0
ROUTES = ("grid", "cta", "conveyor", "resident")
# SMs of an H100: the most CTAs of a default cooperative grid, one a SM
# (every such card holds it at once, whatever a CTA's registers)
CARD_SMS = 132
# Threads the card holds at once (132 SMs of 2048): a conveyor gets as many
# lanes as fill it twice, so that a step's launch is about two waves.
CARD_THREADS = 132 * 2048


def affine_case_table(beta: int, gamma: int, delta: int) -> np.ndarray:
    """int32 ``[9, 15, REC]``: the affine cases of each target state in
    reference order (:func:`~bialign_tpu_torch.ops.cases.iter_affine_cases`:
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


def affine_kernel_consts(beta: int, gamma: int, delta: int) -> np.ndarray:
    """int32 ``[9, 15]``: the constant term of each affine case, per target
    state in :func:`~bialign_tpu_torch.ops.cases.iter_affine_cases` order
    (9 group A by source state, 3 group B, 3 group C).  The tile kernels
    take it by value (``AffineConsts``, ``csrc/tile_diag.cuh``); the rest
    of a case is compiled in (``csrc/recurrence.cuh``)."""
    table = affine_case_table(beta, gamma, delta)
    return np.ascontiguousarray(table[..., CST])


def nonaffine_kernel_consts(gamma: int, delta: int) -> np.ndarray:
    """int32 ``[13]``: the constant term of each non-affine column, in
    NONAFFINE_COLS order (``NonaffineConsts``)."""
    return np.ascontiguousarray(nonaffine_case_table(gamma, delta)[:, CST])


@functools.lru_cache(maxsize=64)
def _kernel_consts(affine: bool, params: tuple) -> torch.Tensor:
    """The case constants a kernel takes by value, a CPU tensor: its C
    function reads them on the host (built once a cost set: the cases are
    walked in Python)."""
    consts = (affine_kernel_consts if affine else nonaffine_kernel_consts)(
        *params)
    return torch.from_numpy(consts)


# rows of a tile at max_shift 0-3 (affine, non-affine), 1 above, and the
# threads of its CTA: `rows` and `kThreads` of AffineTile and NonaffineTile
# in csrc/tile_diag.cuh
TILE_ROWS = ((32, 8, 4, 2), (128, 16, 8, 4))
TILE_THREADS = (256, 128)


def tile_rows(max_shift: int, affine: bool) -> int:
    """Rows R of a tile kernel's CTA at ``max_shift``."""
    rows = TILE_ROWS[0 if affine else 1]
    return rows[max_shift] if max_shift < len(rows) else 1


def tile_shared_bytes(max_shift: int, affine: bool) -> int:
    """Shared memory of one CTA of the tile kernels K1, K2, K4, K5, K8 and
    K9-K12 (``csrc/tile_diag.cuh`` ``tile_geometry``): slabs d-1 and d-2
    staged over R + 1 rows, the tile of R rows, R rows of mu2 windows and of
    mu1."""
    states = N_STATES if affine else 1
    R = tile_rows(max_shift, affine)
    W2 = (2 * max_shift + 1) ** 2
    return 4 * (states * W2 * (3 * R + 2) + W2 * R + R)


def _tile_consts(affine: bool, params: tuple, max_shift: int) -> torch.Tensor:
    """The case constants of a tile kernel, a CPU tensor: the kernel's C
    function reads them on the host and passes them by value.  Raises for a
    max_shift whose tile does not fit one CTA's shared memory."""
    need = tile_shared_bytes(max_shift, affine)
    if need > CTA_SHARED_LIMIT:
        kind = "affine" if affine else "non-affine"
        raise ValueError(
            f"max_shift {max_shift}: the {kind} tile kernel needs {need} "
            f"bytes of shared memory a CTA, one CTA has {CTA_SHARED_LIMIT}")
    return _kernel_consts(affine, params)


def _check_tables(mu1: torch.Tensor, mu2: torch.Tensor, max_shift: int,
                  dtype=torch.int32):
    """The tables of one pair: contiguous 2-D tensors of ``dtype`` (int32;
    the int64 engine also takes int64 ones) on one device."""
    dtypes = (torch.int32, dtype)
    for name, mu in (("mu1", mu1), ("mu2", mu2)):
        if not isinstance(mu, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(mu)}")
        if mu.dtype not in dtypes or mu.dim() != 2 or not mu.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D {dtype} tensor, got "
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


def ms0_live_tables(beta: int, gamma: int, delta: int):
    """Live states at ``max_shift`` 0 and their case constants, after
    ``pallas_dp._ms0_live_tables``: ``(live, const[t][s], mu1_coef[t],
    mu2_coef[t])`` with t, s over the three states whose column advances
    both alignment copies in lockstep, in STATES order.  Only the full
    columns of group A between live states survive at ``max_shift`` 0."""
    live = [q for q, (a, b, c, e) in enumerate(STATES) if (a, b) == (c, e)]
    assert len(live) == 3 and STATE_BOTH_MATCH in live
    pos = {q: t for t, q in enumerate(live)}
    const = np.zeros((3, 3), dtype=np.int32)
    mu1c, mu2c = [0] * 3, [0] * 3
    for t, q in enumerate(live):
        for (src, col, m1c, m2c, ng, nb, nd, _g) in iter_affine_cases(q):
            if tuple(col) == STATES[q] and src in pos:
                const[t, pos[src]] = ng * gamma + nb * beta + nd * delta
                mu1c[t], mu2c[t] = m1c, m2c
    return live, const, mu1c, mu2c


@functools.lru_cache(maxsize=64)
def ms0_kernel_consts(beta: int, gamma: int, delta: int) -> torch.Tensor:
    """int32 ``[3, 3]`` on the CPU: the constant of each live target state
    from each live source state (``AffineMs0Consts``,
    ``csrc/affine_ms0_diag.cuh``, which compiles in the rest: the live
    states are STATES 0, 4 and 8)."""
    return torch.from_numpy(np.ascontiguousarray(
        ms0_live_tables(beta, gamma, delta)[1]))


_FAULT = []


def fault_word() -> torch.Tensor:
    """The fault word of the kernels whose CTAs wait on progress flags (the
    split's, the triplet's and K3's routes "resident"): int32 [4] of pinned
    host memory, one a process.  A wait that outlasts its budget writes 1,
    the CTA, the diagonal and which neighbour (1 above, 2 below), then
    traps, and the next synchronisation fails."""
    if not _FAULT:
        _FAULT.append(torch.zeros(4, dtype=torch.int32, pin_memory=True))
    return _FAULT[0]


def _require_int32_safe(mu1, mu2, gamma, delta, beta=0):
    """Refuse tables and costs whose scores could leave the certified int32
    range (:func:`~bialign_tpu_torch.ops.cases.check_int32_safe`, which
    reads a table's largest magnitude and n + m only).  The magnitude is
    taken on the tables' device, and the check is given a column of n + m + 1
    values that carries both: on a stand-in of the tables' own shape numpy
    would walk (n+1)(m+1) values on the host, 146 ms for a 4000x3990 pair."""
    lo, hi = torch.stack([torch.minimum(mu1.min(), mu2.min()),
                          torch.maximum(mu1.max(), mu2.max())]).tolist()
    peak = np.full((mu1.shape[0] + mu1.shape[1] - 1, 1), max(-lo, hi),
                   dtype=np.int64)
    costs = dict(gap_cost=gamma, gap_opening_cost=beta, shift_cost=delta)
    if not check_int32_safe(peak, peak, costs):
        raise NotImplementedError(
            "these scores exceed the certified int32 range; the score-only "
            "and batch entry points run int32 only, the int64 engine is "
            "BiAligner's (ROADMAP.md P2)"
        )


def _ring_shape(mu1, S: int, states: tuple) -> tuple:
    W = 2 * S + 1
    return (RING, *states, W, W, mu1.shape[0])


def _check_ring(ring, shape, mu1, what="ring"):
    if ring is None:
        return
    if (tuple(ring.shape) != shape or ring.dtype != torch.int32
            or ring.device != mu1.device or not ring.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous int32 tensor {shape} on "
            f"{mu1.device}, got {ring.dtype} {tuple(ring.shape)} on "
            f"{ring.device}"
        )


# -- kernel wrappers ---------------------------------------------------------

def fill_affine_device(mu1, mu2, max_shift, beta, gamma, delta, *,
                       band=None) -> DeviceBand:
    """Affine band fill (K1 band mode): the CUDA kernel for tables on a
    CUDA device, the plain twin for tables on the CPU.  ``band``: the
    memory ``[n+m+1, 9, W, W, n+1]`` to fill, whatever it holds: only the
    live rows are written, so the rest keeps its contents (default: fresh
    memory set to INVALID, the band every reader expects)."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_affine_plain(mu1, mu2, max_shift, beta, gamma, delta)
    return _fill_kernel("fill_affine", (beta, gamma, delta), mu1, mu2,
                        max_shift, band, affine=True)


def fill_nonaffine_device(mu1, mu2, max_shift, gamma, delta, *,
                          band=None) -> DeviceBand:
    """Non-affine band fill (K2 band mode): the CUDA kernel for tables on
    a CUDA device, the plain twin for tables on the CPU; ``band`` as in
    :func:`fill_affine_device`, ``[n+m+1, W, W, n+1]``."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return fill_nonaffine_plain(mu1, mu2, max_shift, gamma, delta)
    return _fill_kernel("fill_nonaffine", (gamma, delta), mu1, mu2, max_shift,
                        band, affine=False)


def _fill_kernel(name, params, mu1, mu2, S, band, *, affine) -> DeviceBand:
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    W = 2 * S + 1
    states = (N_STATES,) if affine else ()
    shape = (n + m + 1, *states, W, W, n + 1)
    _check_ring(band, shape, mu1, "band")
    consts = _tile_consts(affine, params, S)
    if band is None:
        band = torch.full(shape, INVALID, dtype=torch.int32,
                          device=mu1.device)
    _build.launch(f"bialign_{name}", mu1.device, band, mu1, mu2, consts, n, m,
                  S)
    LAUNCHES[name] += 1
    return DeviceBand(ys=band, n=n, m=m, max_shift=S, affine=affine)


def affine_last_slab(mu1, mu2, max_shift, beta, gamma, delta, *, ring=None):
    """Slab ``[9, W, W, n+1]`` of the last diagonal n+m of the affine
    recurrence, no band kept (K1 score-only mode): the CUDA kernel for
    tables on a CUDA device, the plain twin for tables on the CPU.  Only
    row n is live on that diagonal.  ``ring``: the carry
    ``[3, 9, W, W, n+1]`` to use, whatever it holds (default: fresh,
    uninitialised memory)."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return affine_last_slab_plain(mu1, mu2, max_shift, beta, gamma, delta,
                                      ring=ring)
    return _score_kernel("score_affine",
                         _tile_consts(True, (beta, gamma, delta), max_shift),
                         mu1, mu2, _ring_shape(mu1, max_shift, (N_STATES,)),
                         ring, max_shift)


def nonaffine_last_slab(mu1, mu2, max_shift, gamma, delta, *, ring=None):
    """Slab ``[W, W, n+1]`` of the last diagonal of the non-affine
    recurrence, no band kept (K2 score-only mode); as
    :func:`affine_last_slab`, ``ring`` being ``[3, W, W, n+1]``."""
    _check_tables(mu1, mu2, max_shift)
    if mu1.device.type == "cpu":
        return nonaffine_last_slab_plain(mu1, mu2, max_shift, gamma, delta,
                                         ring=ring)
    return _score_kernel("score_nonaffine",
                         _tile_consts(False, (gamma, delta), max_shift), mu1,
                         mu2, _ring_shape(mu1, max_shift, ()), ring, max_shift)


def affine_ms0_last_slab(mu1, mu2, beta, gamma, delta, *, ring=None,
                         route=None, ctas=None, threads=None):
    """Slab ``[3, n+1]`` (the three live states) of the last diagonal of
    the affine recurrence at ``max_shift`` 0 (K3); as
    :func:`affine_last_slab`, ``ring`` being ``[3, 3, n+1]``.  ``route``:
    None for the pair's own (:func:`batch_route` at B = 1: ``"cta"``, one
    launch in one CTA, below :data:`MS0_RESIDENT_ROWS` rows, else
    ``"resident"``, one cooperative launch of :func:`ms0_resident_shape`'s
    CTAs), or a forced one (also ``"grid"``, a launch per diagonal;
    ``"cta"`` up to 4096 rows, :func:`cta_fits`); a ``"cta"`` that does not
    fit raises.  ``ctas``
    forces route ``"resident"``'s CTAs and ``threads`` a CTA's threads there
    (a grid the card cannot hold at once raises RuntimeError, error 720).
    On the CPU the route and its shape are checked, then the plain twin
    runs."""
    _check_tables(mu1, mu2, 0)
    if route not in (None, "cta", "resident", "grid"):
        raise ValueError(f"K3's route must be 'cta', 'resident', 'grid' or "
                         f"None, got {route!r}")
    n = mu1.shape[0] - 1
    route = batch_route(n, 0, True, route, B=1)
    if (ctas is not None or threads is not None) and route != "resident":
        raise ValueError(f"ctas= and threads= are route 'resident''s, the "
                         f"route is {route!r}")
    if route == "resident":
        if threads is not None and not 1 <= threads <= CTA_MAX_THREADS:
            raise ValueError(f"threads must be in 1..{CTA_MAX_THREADS}, got "
                             f"{threads}")
        sms = (torch.cuda.get_device_properties(mu1.device)
               .multi_processor_count if mu1.device.type == "cuda"
               else CARD_SMS)
        shape = ms0_resident_shape(n, ctas, threads, sms=sms)
        if shape is None:
            raise ValueError(
                f"route='resident': {n + 1} rows over "
                f"{ctas or min(sms, n + 1)} CTAs leave a thread more than "
                "four rows")
    if mu1.device.type == "cpu":
        return affine_ms0_last_slab_plain(mu1, mu2, beta, gamma, delta,
                                          ring=ring)
    consts = ms0_kernel_consts(beta, gamma, delta)
    ring_shape = (RING, 3, mu1.shape[0])
    if route == "resident":
        G, _rows, t = shape
        m = mu1.shape[1] - 1
        halo = (torch.empty((G - 1, n + m + 1, 3), dtype=torch.int32,
                            device=mu1.device) if G > 1 else None)
        flags = torch.zeros(G, dtype=torch.int32, device=mu1.device)
        return _score_kernel("score_affine_ms0_resident", consts, mu1, mu2,
                             ring_shape, ring, G, t, halo, flags,
                             fault_word())
    name = "score_affine_ms0" + ("" if route == "cta" else "_grid")
    return _score_kernel(name, consts, mu1, mu2, ring_shape, ring)


def ms0_resident_shape(n: int, ctas=None, threads=None, *, sms=CARD_SMS):
    """``(G, rows, threads)`` of K3's route ``"resident"`` on n+1 rows: G
    CTAs of one cooperative launch, ``rows`` = ceil((n+1) / G) rows a CTA
    on ``threads`` threads (default a row a thread in whole warps and two
    warps more, whose last threads copy and publish the halo, up to 1024),
    a thread at most four of them (``csrc/cta_scores.cuh``
    ``cta_ms0<kRows, true>``, its ring [3, 3, rows+1] in shared memory);
    ``None`` where a thread would take more.  ``ctas`` forces G (>= 1; a
    grid the card cannot hold at once is refused at the launch); by
    default G is the most CTAs up to ``sms``, one a SM, that leaves none
    without rows: the fewest rows a CTA.  Pure."""
    if ctas is not None:
        G = int(ctas)
        if G < 1:
            raise ValueError(f"ctas must be >= 1, got {ctas}")
    else:
        G = -(-(n + 1) // -(-(n + 1) // min(sms, n + 1)))
    rows = -(-(n + 1) // G)
    t = (min(CTA_MAX_THREADS, -(-rows // 32) * 32 + 64) if threads is None
         else int(threads))
    return (G, rows, t) if -(-rows // t) <= 4 else None


def _score_kernel(name, consts, mu1, mu2, ring_shape, ring, *more):
    """Launch score-only kernel ``name`` over ``ring`` (fresh memory if
    None); ``consts``: its case constants on the host; ``more`` are the
    kernel's arguments after n and m: max_shift (which K3 lacks), or K3's
    grid on route "resident".  Returns the slab of the last diagonal, a view
    of the ring."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    dev = mu1.device
    _check_ring(ring, ring_shape, mu1)
    if ring is None:
        ring = torch.empty(ring_shape, dtype=torch.int32, device=dev)
    _build.launch(f"bialign_{name}", dev, ring, mu1, mu2, consts, n, m,
                  *more)
    LAUNCHES[name] += 1
    return ring[(n + m) % RING]


def affine_score(mu1, mu2, max_shift, beta, gamma, delta) -> int:
    """Affine optimal score of one pair, no band kept (pallas_dp.py
    ``affine_score``): K3 at ``max_shift`` 0, else K1 in score-only mode.
    The score is the max over the states of the last slab at (S, S, n), one
    small copy to the host."""
    _check_tables(mu1, mu2, max_shift)
    _require_int32_safe(mu1, mu2, gamma, delta, beta)
    n, S = mu1.shape[0] - 1, max_shift
    if S == 0:
        return int(affine_ms0_last_slab(mu1, mu2, beta, gamma, delta)[:, n]
                   .max())
    slab = affine_last_slab(mu1, mu2, S, beta, gamma, delta)
    return int(slab[:, S, S, n].max())


def nonaffine_score(mu1, mu2, max_shift, gamma, delta) -> int:
    """Non-affine optimal score of one pair, no band kept (pallas_dp.py
    ``nonaffine_score``): K2 in score-only mode."""
    _check_tables(mu1, mu2, max_shift)
    _require_int32_safe(mu1, mu2, gamma, delta)
    n, S = mu1.shape[0] - 1, max_shift
    return int(nonaffine_last_slab(mu1, mu2, S, gamma, delta)[S, S, n])


# -- plain twins -------------------------------------------------------------

def _shift(x, dk: int, dl: int, di: int, invalid: int = INVALID):
    """out[..., sk, sl, i] = x[..., sk - dk, sl - dl, i - di], ``invalid``
    where that index falls off the slab (every such position is guarded
    out)."""
    return F.pad(x, (di, -di, dl, -dl, dk, -dk), value=invalid)


def _sentinel(dtype) -> int:
    """The masked-case sentinel of a DP dtype (xla_dp._sentinel)."""
    return INVALID64 if dtype == torch.int64 else INVALID


def _in_slab(idx, W: int):
    return (idx >= 0) & (idx < W)


class _Geometry:
    """Index grids of a diagonal's slab ``[W, W, P]``, and per diagonal
    (:meth:`diag`) the score tables in diagonal layout, 0 outside
    [0, n] x [0, m] (xla_dp._diag_mu_tables).  Nothing here is the size of
    a band.  The tables are ``[n+1, m+1]``, or a stack ``[B, n+1, m+1]``:
    the slabs then carry the batch axis in front (``batch``).

    ``rows=(a, b)``: the slabs of one row shard of the sequence split
    (:mod:`bialign_tpu_torch.parallel.seqsplit`), P = b - a + 2 rows
    a-1 .. b, slot 0 the halo row a-1, which is read as row i-1 of row a and
    never written (it is not live)."""

    def __init__(self, mu1, mu2, S: int, rows=None):
        n, m = mu1.shape[-2] - 1, mu1.shape[-1] - 1
        dev = mu1.device
        a, b = (0, n) if rows is None else rows
        W = 2 * S + 1
        self.mu1, self.mu2 = mu1, mu2
        self.batch = tuple(mu1.shape[:-2])
        self.n, self.m, self.S, self.W = n, m, S, W
        first = a if rows is None else a - 1
        self.P = b - first + 1
        i = self.i = torch.arange(first, b + 1, device=dev)[None, None, :]
        # the halo row of shard 0 (row -1) reads the tables at row 0
        self.i_at = i.clamp(min=0)
        self.owned = None if rows is None else i >= a
        sk = self.sk = torch.arange(W, device=dev)[:, None, None]
        sl = self.sl = torch.arange(W, device=dev)[None, :, None]
        k = self.k = i + sk - S
        self.k_ok = (k >= 0) & (k <= n)
        self.t = sk + sl
        self.origin = (i == 0) & (sk == S) & (sl == S)
        self.no_origin = torch.zeros_like(self.origin)

    def diag(self, d: int):
        """(mu1_row ``[(B,) 1, 1, P]``, mu2_blk ``[(B,) W, W, P]``, j_ge,
        l_ge, live ``[1, 1, P]``, protect ``[W, W, P]``) of diagonal d:
        ``mu1[i, d-i]``, ``mu2[k, l]``, the guards' terms in j and l (the
        only ones that change with d), the rows with 0 <= j <= m, and the
        origin cell, which keeps its initial values."""
        n, m = self.n, self.m
        j = d - self.i                                        # [1, 1, P]
        l = j + self.sl - self.S                              # [1, W, P]
        live = (j >= 0) & (j <= m)
        if self.owned is not None:
            live = live & self.owned
        mu1_row = torch.where(live, self.mu1[..., self.i_at, j.clamp(0, m)],
                              0)
        ok = self.k_ok & (l >= 0) & (l <= m)
        mu2_blk = torch.where(
            ok, self.mu2[..., self.k.clamp(0, n), l.clamp(0, m)], 0)
        protect = self.origin if d == 0 else self.no_origin
        return (mu1_row, mu2_blk, [j >= 0, j >= 1], [l >= 0, l >= 1], live,
                protect)


class _ConveyorGeometry(_Geometry):
    """A bucket's geometry on the conveyor (pallas_dp._conveyor_tables):
    ``lanes`` slabs ``[lanes, (9,) W, W, N+1]``; through lane x stream the
    pairs x, x + lanes, ... one behind the other, ``T0`` steps apart.
    :meth:`diag` takes the global step t: row i then serves stripe
    (t - i) // T0 of its lane at column j = (t - i) % T0, on that pair's own
    diagonal i + j."""

    def __init__(self, mu1p, mu2p, ns, ms, S: int, lanes: int, T0: int):
        super().__init__(mu1p, mu2p, S)
        self.pairs = mu1p.shape[0]
        self.batch = (lanes,)
        self.lanes, self.T0 = lanes, T0
        self.ns, self.ms = ns.long(), ms.long()
        self.lane = torch.arange(lanes, device=mu1p.device)[:, None, None,
                                                            None]
        self.i4 = self.i[None]                                # [1, 1, 1, P]

    def stripes(self, t: int):
        """(pair ``[lanes, 1, 1, P]`` clamped to the bucket, j
        ``[1, 1, 1, P]``, live ``[lanes, 1, 1, P]``) of step t: the pair each
        row serves, its column, and whether (i, j) is a cell of that pair."""
        tr = t - self.i4
        b = self.lane + torch.div(tr, self.T0, rounding_mode="floor") \
            * self.lanes
        j = tr % self.T0
        inside = (tr >= 0) & (b < self.pairs)
        b = b.clamp(0, self.pairs - 1)
        live = inside & (self.i4 <= self.ns[b]) & (j <= self.ms[b])
        return b, j, live

    def diag(self, t: int):
        """As :meth:`_Geometry.diag` at step t, every row on its own pair's
        tables: mu1_row ``[lanes, 1, 1, P]``, mu2_blk ``[lanes, W, W, P]``,
        live ``[lanes, 1, 1, P]``, protect ``[1, W, W, P]``."""
        n, m = self.n, self.m
        b, j, live = self.stripes(t)
        l = j + self.sl - self.S                              # [1, 1, W, P]
        mu1_row = torch.where(live, self.mu1[b, self.i4, j.clamp(0, m)], 0)
        ok = self.k_ok & (l >= 0) & (l <= m)
        mu2_blk = torch.where(
            ok, self.mu2[b, self.k.clamp(0, n), l.clamp(0, m)], 0)
        protect = self.origin & (j == 0)
        return (mu1_row, mu2_blk, [j >= 0, j >= 1], [l >= 0, l >= 1], live,
                protect)


def _index(rows, dev):
    return torch.as_tensor(rows, dtype=torch.long, device=dev)


def _affine_step(g: _Geometry, beta, gamma, delta, dtype=torch.int32):
    """The affine recurrence of one diagonal: ``step(d, vm1, vm2)`` maps
    the slabs ``[(B,) 9, W, W, P]`` of diagonals d-1 and d-2 to (slab of d,
    its live rows); band fill, score and batch share it.  Rows of the
    result off the live range are not meaningful, and rows of vm1/vm2 off
    their own live ranges may hold anything: every case that would read one
    is guarded out (xla_dp._build_affine_step).  ``dtype``: int32, or int64
    for the int64 engine (sentinel ``INVALID64``)."""
    Q = N_STATES
    S, W = g.S, g.W
    i, k, sk, sl = g.i, g.k, g.sk, g.sl
    dev = g.mu1.device
    invalid = _sentinel(dtype)
    tabs = AffineTables(beta, gamma, delta, dtype=np.int64)

    def consts(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)[
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
    init = torch.full((Q, 1, 1, 1), NEG_INF, dtype=dtype, device=dev)
    init[STATE_BOTH_MATCH] = 0

    def step(d, vm1, vm2):
        mu1_row, mu2_blk, j_ge, l_ge, live, protect = g.diag(d)
        best = torch.empty((*g.batch, Q, W, W, g.P), dtype=dtype,
                           device=dev)
        for q in range(Q):
            a, b, c, e = STATES[q]
            pred = vm1 if a + b == 1 else vm2
            # group A: full column q from all 9 sources (pyx:275-279)
            agg = (_shift(pred, c - a, e - b, a, invalid)
                   + a_const[q]).amax(-4)
            if tabs.mu1_coef[q]:
                agg = agg + mu1_row
            if tabs.mu2_coef[q]:
                agg = agg + mu2_blk
            cA = torch.where(gA[q] & j_ge[b] & l_ge[e], agg, invalid)
            # group C: seq-only half column (a, b, 0, 0) (pyx:291-296)
            aggC = (_shift(pred.index_select(-4, c_src[q]), -a, -b, a,
                           invalid) + c_const[q]).amax(-4)
            if tabs.c_mu1_coef[q]:
                aggC = aggC + mu1_row
            cC = torch.where(gC[q] & j_ge[b], aggC, invalid)
            best[..., q, :, :, :] = torch.maximum(cA, cC)
        val = torch.where(best == invalid, NEG_INF, best)
        val = torch.where(protect, init, val)

        # group B: str-only half columns (0, 0, c, e) within the diagonal;
        # sources lie at smaller t = sk + sl, so ascending t finalises them
        # before they are read (pyx:281-290)
        for t in range(1, 4 * S + 1):
            commit = (g.t == t) & ~protect
            for q in b_live[t]:
                _a, _b, c, e = STATES[q]
                aggB = (_shift(val.index_select(-4, b_src[q]), c, e, 0,
                               invalid) + b_const[q]).amax(-4)
                if tabs.b_mu2_coef[q]:
                    aggB = aggB + mu2_blk
                best_q, val_q = best[..., q, :, :, :], val[..., q, :, :, :]
                bq = torch.maximum(
                    best_q, torch.where(gB[q] & l_ge[e], aggB, invalid))
                vq = torch.where(bq == invalid, NEG_INF, bq)
                best_q.copy_(torch.where(commit, bq, best_q))
                val_q.copy_(torch.where(commit, vq, val_q))
        return val, live

    return step


def _nonaffine_step(g: _Geometry, gamma, delta, dtype=torch.int32):
    """The non-affine recurrence of one diagonal, as :func:`_affine_step`
    on slabs ``[(B,) W, W, P]`` (xla_dp._build_nonaffine_step)."""
    W, S = g.W, g.S
    i, k, sk, sl = g.i, g.k, g.sk, g.sl
    dev = g.mu1.device
    invalid = _sentinel(dtype)
    tab = NonAffineTables(gamma, delta, dtype=np.int64)
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

    def step(d, vm1, vm2):
        mu1_row, mu2_blk, j_ge, l_ge, live, protect = g.diag(d)
        best = torch.full((*g.batch, W, W, g.P), invalid, dtype=dtype,
                          device=dev)
        for (x0, x1, x2, x3), const, m1c, m2c, fixed in external:
            pred = vm1 if x0 + x1 == 1 else vm2
            contrib = _shift(pred, x2 - x0, x3 - x1, x0, invalid) + const
            if m1c:
                contrib = contrib + mu1_row
            if m2c:
                contrib = contrib + mu2_blk
            ok = fixed & j_ge[x1] & l_ge[x3]
            best = torch.maximum(best, torch.where(ok, contrib, invalid))
        val = torch.where(best == invalid, NEG_INF, best)
        val = torch.where(protect, 0, val)

        # the 4 str-only columns, within the diagonal in ascending t
        for t in range(1, 4 * S + 1):
            commit = (g.t == t) & ~protect
            b2 = best
            for (_x0, _x1, x2, x3), const, _m1c, m2c, fixed in internal:
                contrib = _shift(val, x2, x3, 0, invalid) + const
                if m2c:
                    contrib = contrib + mu2_blk
                b2 = torch.maximum(
                    b2, torch.where(fixed & l_ge[x3], contrib, invalid))
            best = torch.where(commit, b2, best)
            val = torch.where(commit, torch.where(b2 == invalid, NEG_INF, b2),
                              val)
        return val, live

    return step


def _fill_plain(step, g: _Geometry, states: tuple, affine: bool,
                dtype=torch.int32) -> DeviceBand:
    """Run ``step`` over all diagonals into a band of ``dtype``; rows off a
    diagonal's live range hold the dtype's sentinel (INVALID at int32), as
    in the kernels' band."""
    n, m, W = g.n, g.m, g.W
    dev = g.mu1.device
    invalid = _sentinel(dtype)
    band = torch.empty((n + m + 1, *states, W, W, n + 1), dtype=dtype,
                       device=dev)
    vm1 = vm2 = torch.full((*states, W, W, n + 1), invalid, dtype=dtype,
                           device=dev)
    for d in range(n + m + 1):
        val, live = step(d, vm1, vm2)
        val = torch.where(live, val, invalid)
        band[d] = val
        vm1, vm2 = val, vm1
    return DeviceBand(ys=band, n=n, m=m, max_shift=g.S, affine=affine)


def _ring_plain(step, n: int, m: int, shape: tuple, ring, dev):
    """Run ``step`` over all diagonals on a ring of three slabs, as the
    score-only kernels do: diagonal d reads slabs (d-1) % 3 and (d-2) % 3
    and writes the live rows of slab d % 3, the other rows keeping what
    they held.  Returns the slab of diagonal n+m."""
    if ring is None:
        ring = torch.full(shape, INVALID, dtype=torch.int32, device=dev)
    for d in range(n + m + 1):
        val, live = step(d, ring[(d - 1) % RING], ring[(d - 2) % RING])
        ring[d % RING] = torch.where(live, val, ring[d % RING])
    return ring[(n + m) % RING]


def fill_affine_plain(mu1, mu2, max_shift, beta, gamma, delta, *,
                      dtype=torch.int32) -> DeviceBand:
    """Affine band fill in plain PyTorch, on the tables' device
    (xla_dp._build_affine_step, with the band layout of the kernel).
    ``dtype=torch.int64``: the int64 engine (xla_dp.fill_affine with
    ``int64=True``), for scores the int32 check cannot certify; it takes
    int64 tables too."""
    _check_tables(mu1, mu2, max_shift, dtype)
    g = _Geometry(mu1, mu2, max_shift)
    return _fill_plain(_affine_step(g, beta, gamma, delta, dtype), g,
                       (N_STATES,), affine=True, dtype=dtype)


def fill_nonaffine_plain(mu1, mu2, max_shift, gamma, delta, *,
                         dtype=torch.int32) -> DeviceBand:
    """Non-affine band fill in plain PyTorch, on the tables' device
    (xla_dp._build_nonaffine_step, with the band layout of the kernel);
    ``dtype`` as in :func:`fill_affine_plain`."""
    _check_tables(mu1, mu2, max_shift, dtype)
    g = _Geometry(mu1, mu2, max_shift)
    return _fill_plain(_nonaffine_step(g, gamma, delta, dtype), g, (),
                       affine=False, dtype=dtype)


def affine_last_slab_plain(mu1, mu2, max_shift, beta, gamma, delta, *,
                           ring=None):
    """Plain twin of the K1 score-only kernel: the step of
    :func:`fill_affine_plain` on a ring of three slabs, no band."""
    _check_tables(mu1, mu2, max_shift)
    shape = _ring_shape(mu1, max_shift, (N_STATES,))
    _check_ring(ring, shape, mu1)
    g = _Geometry(mu1, mu2, max_shift)
    return _ring_plain(_affine_step(g, beta, gamma, delta), g.n, g.m, shape,
                       ring, mu1.device)


def nonaffine_last_slab_plain(mu1, mu2, max_shift, gamma, delta, *,
                              ring=None):
    """Plain twin of the K2 score-only kernel: the step of
    :func:`fill_nonaffine_plain` on a ring of three slabs, no band."""
    _check_tables(mu1, mu2, max_shift)
    shape = _ring_shape(mu1, max_shift, ())
    _check_ring(ring, shape, mu1)
    g = _Geometry(mu1, mu2, max_shift)
    return _ring_plain(_nonaffine_step(g, gamma, delta), g.n, g.m, shape,
                       ring, mu1.device)


def _ms0_step(mu1, mu2, beta, gamma, delta):
    """The affine recurrence of one diagonal at ``max_shift`` 0, as
    :func:`_affine_step` on slabs ``[(B,) 3, P]`` of the three live states
    (pallas_dp._make_update_ms0)."""
    n, m = mu1.shape[-2] - 1, mu1.shape[-1] - 1
    dev = mu1.device
    live_states, const, mu1c, mu2c = ms0_live_tables(beta, gamma, delta)
    const_t = torch.as_tensor(const, device=dev)[..., None]     # [3, 3, 1]
    i = torch.arange(n + 1, device=dev)
    init = torch.tensor([0 if q == STATE_BOTH_MATCH else NEG_INF
                         for q in live_states], dtype=torch.int32, device=dev)

    def step(d, vm1, vm2):
        j = d - i
        live = (j >= 0) & (j <= m)
        at = (..., i, j.clamp(0, m))
        m1 = torch.where(live, mu1[at], 0)
        m2 = torch.where(live, mu2[at], 0)
        out = []
        for t, q in enumerate(live_states):
            a, b = STATES[q][:2]
            pred = vm1 if a + b == 1 else vm2
            acc = (F.pad(pred, (a, -a), value=INVALID) + const_t[t]).amax(-2)
            acc = acc + mu1c[t] * m1 + mu2c[t] * m2
            out.append(torch.where((i >= a) & (j >= b), acc, NEG_INF))
        val = torch.stack(out, dim=-2)
        if d == 0:
            val = torch.where(i == 0, init[:, None], val)
        return val, live

    return step


def affine_ms0_last_slab_plain(mu1, mu2, beta, gamma, delta, *, ring=None):
    """Plain twin of the K3 kernel (pallas_dp._make_update_ms0): three live
    states, slabs ``[3, P]``, on a ring of three."""
    _check_tables(mu1, mu2, 0)
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    shape = (RING, 3, n + 1)
    _check_ring(ring, shape, mu1)
    return _ring_plain(_ms0_step(mu1, mu2, beta, gamma, delta), n, m, shape,
                       ring, mu1.device)


def affine_score_plain(mu1, mu2, max_shift, beta, gamma, delta) -> int:
    """Affine optimal score through :func:`affine_last_slab_plain`."""
    n, S = mu1.shape[0] - 1, max_shift
    slab = affine_last_slab_plain(mu1, mu2, S, beta, gamma, delta)
    return int(slab[:, S, S, n].max())


def nonaffine_score_plain(mu1, mu2, max_shift, gamma, delta) -> int:
    """Non-affine optimal score through :func:`nonaffine_last_slab_plain`."""
    n, S = mu1.shape[0] - 1, max_shift
    return int(nonaffine_last_slab_plain(mu1, mu2, S, gamma, delta)[S, S, n])


def affine_ms0_score_plain(mu1, mu2, beta, gamma, delta) -> int:
    """Affine optimal score at ``max_shift`` 0 through
    :func:`affine_ms0_last_slab_plain`."""
    n = mu1.shape[0] - 1
    return int(affine_ms0_last_slab_plain(mu1, mu2, beta, gamma, delta)[:, n]
               .max())


# -- scores of a bucket of pairs ---------------------------------------------

def _check_stacks(mu1p, mu2p, ns, ms, max_shift: int):
    """The arguments every batch function takes: the stacks ``mu1p``,
    ``mu2p`` ``[B, N+1, M+1]`` and the pairs' lengths ``ns``, ``ms``
    ``[B]``, contiguous int32 tensors on one device.  The lengths' values
    are checked where that costs no device sync, on the CPU; the kernels
    leave a pair whose lengths lie outside the bucket untouched (its score
    stays INVALID)."""
    for name, t, dim in (("mu1p", mu1p, 3), ("mu2p", mu2p, 3), ("ns", ns, 1),
                         ("ms", ms, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dim}-D int32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}")
        if t.device != mu1p.device:
            raise ValueError(f"{name} on {t.device}, mu1p on {mu1p.device}")
    if mu1p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stacks on unsupported device {mu1p.device}")
    B, N1, M1 = mu1p.shape
    if mu2p.shape != mu1p.shape or ns.shape != (B,) or ms.shape != (B,):
        raise ValueError(
            f"shapes differ: mu1p {tuple(mu1p.shape)}, mu2p "
            f"{tuple(mu2p.shape)}, ns {tuple(ns.shape)}, ms {tuple(ms.shape)}")
    if N1 < 1 or M1 < 1:
        raise ValueError(f"empty tables {tuple(mu1p.shape)}")
    if max_shift < 0:
        raise ValueError(f"max_shift must be >= 0, got {max_shift}")
    if mu1p.device.type == "cpu" and B and (
            ns.min() < 0 or ns.max() > N1 - 1 or ms.min() < 0
            or ms.max() > M1 - 1):
        raise ValueError(
            f"lengths outside the bucket ({N1 - 1}, {M1 - 1}): ns "
            f"{ns.tolist()}, ms {ms.tolist()}")


def cta_shared_bytes(N: int, max_shift: int, affine: bool) -> int:
    """Dynamic shared memory of one CTA of the one-CTA-per-pair kernels on
    N+1 rows (``csrc/cta_scores.cuh``): K6 (``cta_shared_bytes``), a ring of
    three slabs of ``cells`` values a row, a ring of 4S+2 anti-diagonals of
    mu2 and a double buffer of mu1's; K7 and K3 (affine ``max_shift`` 0,
    ``run_cta_ms0``), the ring of the three live states alone, whose table
    values sit in registers."""
    S = max_shift
    if affine and S == 0:
        return 4 * (N + 1) * RING * 3
    cells = (N_STATES if affine else 1) * (2 * S + 1) ** 2
    return 4 * (N + 1) * (RING * cells + 4 * S + 4)


def cta_fits(N: int, max_shift: int, affine: bool) -> bool:
    """Whether a pair of N+1 rows fits one CTA of the one-CTA-per-pair
    kernels: :func:`cta_shared_bytes` in its shared memory, and for K3/K7
    no more than ``MS0_CTA_ROWS`` rows in its threads' registers."""
    rows_fit = N + 1 <= MS0_CTA_ROWS if affine and max_shift == 0 else True
    return rows_fit and cta_shared_bytes(N, max_shift, affine) <= \
        CTA_SHARED_LIMIT


def batch_route(N: int, max_shift: int, affine: bool, route=None, *,
                B: int) -> str:
    """The route of a bucket of B pairs and N+1 rows
    (pallas_dp._route_batched): ``"cta"`` when a pair fits one CTA
    (:func:`cta_fits`); else ``"conveyor"`` for two pairs or more
    (pallas_dp._use_conveyor), ``"grid"`` for one; but one pair's score at
    affine ``max_shift`` 0 (K3, :func:`affine_ms0_last_slab`) takes
    ``"resident"`` from :data:`MS0_RESIDENT_ROWS` rows on, where it is
    faster than one CTA, and beyond one CTA.  A forced ``route`` is
    returned as it is, but a ``"cta"`` that does not fit raises, and so
    does a ``"resident"`` other than K3's: neither gives way."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got "
                         f"{route!r}")
    k3 = B == 1 and affine and max_shift == 0
    if route == "resident" and not k3:
        raise ValueError(
            "route='resident' is K3's alone: one pair's score at affine "
            f"max_shift 0 (B = {B}, max_shift {max_shift}, affine {affine})")
    fits = cta_fits(N, max_shift, affine)
    if route == "cta" and not fits:
        raise ValueError(
            f"route='cta': {N + 1} rows at max_shift {max_shift} do not fit "
            f"one CTA ({cta_shared_bytes(N, max_shift, affine)} bytes of "
            f"shared memory of {CTA_SHARED_LIMIT}, at max_shift 0 "
            f"{MS0_CTA_ROWS} rows at most); use route='grid'")
    if route is not None:
        return route
    if k3 and N + 1 >= MS0_RESIDENT_ROWS:
        return "resident"
    if fits:
        return "cta"
    return "conveyor" if B >= 2 else "grid"


def _bucket_route(N: int, max_shift: int, affine: bool, route, B: int) -> str:
    """:func:`batch_route` for the bucket wrappers: route ``"resident"`` is
    one pair's K3, so a bucket of one pair keeps K7's ``"cta"`` where it
    fits one CTA and K4's ``"grid"`` beyond, and a forced ``"resident"``
    raises."""
    if route == "resident":
        raise ValueError("route='resident' is K3's (affine_ms0_last_slab), "
                         "not a bucket's")
    route = batch_route(N, max_shift, affine, route, B=B)
    if route == "resident":
        return "cta" if cta_fits(N, max_shift, affine) else "grid"
    return route


def conveyor_T0(M: int) -> int:
    """Steps between two pairs of one conveyor lane
    (pallas_dp._conveyor_T0).  At step t row i of a lane serves stripe
    (t - i) // T0 at column (t - i) % T0, so T0 > M gives every row one
    owner.  A pair on its diagonal d reads rows >= d - M - 2 (its live rows
    of d-1 and d-2) and the pair behind it has by then written rows
    <= d - T0 only; with T0 = M + 3 the two never meet, whichever slab of
    the ring each is on."""
    return M + 3


def conveyor_lanes(B: int, N: int, max_shift: int, affine: bool) -> int:
    """Lanes of a bucket's conveyor: as many as fill the card's threads
    twice when each lane's diagonal covers its N+1 rows with tiles of the
    tile kernel (``tile_rows`` rows, ``TILE_THREADS`` threads a CTA), at
    most one per pair.  More pairs than that stream through the lanes one
    behind the other, so the rings' memory and a step's launch stop growing
    with the bucket.  Two waves, not one: a lane's tiles above its pairs'
    live rows leave at once, and fewer lanes cost steps (PERF.md, the
    conveyor's lanes on the realistic batch)."""
    tiles = -(-(N + 1) // tile_rows(max_shift, affine))
    threads = TILE_THREADS[0 if affine else 1]
    return max(1, min(B, 2 * CARD_THREADS // (tiles * threads)))


def _batch_ring_shape(mu1p, states: tuple, lanes=None) -> tuple:
    return (mu1p.shape[0] if lanes is None else lanes, RING, *states,
            mu1p.shape[1])


# bucket kernel (csrc function bialign_<name>) -> its LAUNCHES counter
_BATCH_COUNTER = {"batch_affine": "batch_affine",
                  "batch_nonaffine": "batch_nonaffine",
                  "batch_fill_affine": "batch_fill_affine",
                  "batch_fill_nonaffine": "batch_fill_nonaffine",
                  "cta_affine": "cta_scores", "cta_nonaffine": "cta_scores",
                  "cta_affine_ms0": "cta_scores_ms0",
                  "conveyor_affine": "conveyor_scores",
                  "conveyor_nonaffine": "conveyor_scores"}

_CASE_TABLES = {"affine": affine_case_table, "nonaffine": nonaffine_case_table}


@functools.lru_cache(maxsize=64)
def _device_cases(kind: str, params: tuple, dev: torch.device):
    """The packed case table of ``params`` on ``dev``, copied there once."""
    return torch.from_numpy(_CASE_TABLES[kind](*params)).to(dev)


def _batch_kernel(name, consts, mu1p, mu2p, ns, ms, ring_shape, ring, d_max,
                  *more):
    """Launch bucket kernel ``name``; ``consts`` are its case constants on
    the host; ``more`` are the kernel's arguments after M: max_shift (which
    K7 lacks), then those of :func:`_route_plan`.
    ``ring`` (any contents) is the carry of the grid and conveyor kernels,
    or the chunk band of the band-mode kernels, allocated here if None, and
    what the CTA kernels start their shared memory from, if given.
    ``d_max``: the largest n_b + m_b, or None for the bucket's N + M.
    Returns the ``[B]`` scores."""
    B, N, M = mu1p.shape[0], mu1p.shape[1] - 1, mu1p.shape[2] - 1
    dev = mu1p.device
    _check_ring(ring, ring_shape, mu1p)
    out = torch.full((B,), INVALID, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if ring is None and not name.startswith("cta_"):
        ring = torch.empty(ring_shape, dtype=torch.int32, device=dev)
    if name.startswith("cta_"):
        extent = ()                   # a CTA loops to its own pair's n + m
    else:
        extent = (N + M if d_max is None else min(int(d_max), N + M),)
    _build.launch(f"bialign_{name}", dev, ring, out, mu1p, mu2p, ns, ms,
                  consts, B, N, M, *more, *extent)
    LAUNCHES[_BATCH_COUNTER[name]] += 1
    return out


def _route_plan(mu1p, route: str, lanes, threads, max_shift: int,
                affine: bool) -> tuple:
    """The kernel arguments a bucket's route adds: (lanes, T0) on the
    conveyor, (threads,) a CTA on "cta" (0: the kernel's own: K6 one a value
    of the widest diagonal up to 512 affine, 256 non-affine, K7 one a row
    up to 1024), () on "grid"."""
    B, N, M = mu1p.shape[0], mu1p.shape[1] - 1, mu1p.shape[2] - 1
    if lanes is not None and route != "conveyor":
        raise ValueError(f"lanes= is the conveyor's, route is {route!r}")
    if threads is not None and route != "cta":
        raise ValueError(f"threads= is route 'cta''s, route is {route!r}")
    if route == "cta":
        if threads is not None and not 1 <= threads <= CTA_MAX_THREADS:
            raise ValueError(f"threads must be in 1..{CTA_MAX_THREADS}, got "
                             f"{threads}")
        return (threads or 0,)
    if route == "grid":
        return ()
    if lanes is None:
        lanes = conveyor_lanes(B, N, max_shift, affine)
    if not 1 <= lanes <= max(B, 1):
        raise ValueError(f"lanes must be in 1..{max(B, 1)}, got {lanes}")
    return lanes, conveyor_T0(M)


def affine_batch_scores(mu1p, mu2p, ns, ms, max_shift, beta, gamma, delta, *,
                        route=None, ring=None, lanes=None, threads=None,
                        d_max=None) -> torch.Tensor:
    """Affine scores ``[B]`` (int32) of a bucket (pallas_dp.py
    ``_affine_pallas_batched_dense`` with ``score_only=True``).  CUDA
    tensors launch K4 (route ``"grid"``), K8 (``"conveyor"``), K6
    (``"cta"``) or, on ``"cta"`` at ``max_shift`` 0, K7; CPU tensors take
    the plain twin of the same route.  ``route``: None for
    :func:`batch_route`'s choice, or a forced one.  ``ring``: a carry to
    use, whatever it holds: ``[B, 3, 9, W, W, N+1]``, ``[B, 3, 3, N+1]``
    where K7 runs, ``[lanes, 3, 9, W, W, N+1]`` on the conveyor.  ``lanes``:
    the conveyor's, None for :func:`conveyor_lanes`; ``threads``: a CTA's
    on route ``"cta"``, None for the kernel's own.  ``d_max``: the largest
    n_b + m_b of the bucket, where the caller knows it on the host; it saves
    the launches of diagonals no pair has (default: the bucket's N + M).

    On a CUDA device the lengths' values are not checked (that would wait
    for the device): a pair whose n_b, m_b lie outside the bucket, or beyond
    ``d_max``, comes back as INVALID.  K4 and K8 run the tile kernel's
    device function and raise ``ValueError`` for a max_shift whose tile
    does not fit one CTA's shared memory (above 17), as K1 does."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    route = _bucket_route(mu1p.shape[1] - 1, S, True, route, mu1p.shape[0])
    plan = _route_plan(mu1p, route, lanes, threads, S, True)
    lanes = plan[0] if route == "conveyor" else None
    ms0 = route == "cta" and S == 0
    states = (3,) if ms0 else (N_STATES, W, W)
    ring_shape = _batch_ring_shape(mu1p, states, lanes)
    params = (beta, gamma, delta)
    if mu1p.device.type == "cpu":
        if ms0:
            return affine_ms0_batch_scores_plain(mu1p, mu2p, ns, ms, *params,
                                                 ring=ring)
        if lanes:
            return affine_conveyor_scores_plain(mu1p, mu2p, ns, ms, S,
                                                *params, lanes=lanes,
                                                ring=ring)
        return affine_batch_scores_plain(mu1p, mu2p, ns, ms, S, *params,
                                         ring=ring)
    if ms0:
        return _batch_kernel("cta_affine_ms0", ms0_kernel_consts(*params),
                             mu1p, mu2p, ns, ms, ring_shape, ring, d_max,
                             *plan)
    name = {"grid": "batch_affine", "cta": "cta_affine",
            "conveyor": "conveyor_affine"}[route]
    consts = (_kernel_consts(True, params) if route == "cta"
              else _tile_consts(True, params, S))
    return _batch_kernel(name, consts, mu1p, mu2p, ns, ms, ring_shape, ring,
                         d_max, S, *plan)


def nonaffine_batch_scores(mu1p, mu2p, ns, ms, max_shift, gamma, delta, *,
                           route=None, ring=None, lanes=None, threads=None,
                           d_max=None) -> torch.Tensor:
    """Non-affine scores ``[B]`` of a bucket (pallas_dp.py
    ``_nonaffine_pallas_batched_dense`` with ``score_only=True``): K5 on
    route ``"grid"``, K8's non-affine form on ``"conveyor"``, K6's on
    ``"cta"``; as :func:`affine_batch_scores`, ``ring`` being
    ``[B, 3, W, W, N+1]``, or ``[lanes, 3, W, W, N+1]`` on the conveyor;
    K5 and K8 refuse a max_shift above 48 on a CUDA device."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    route = _bucket_route(mu1p.shape[1] - 1, S, False, route, mu1p.shape[0])
    plan = _route_plan(mu1p, route, lanes, threads, S, False)
    lanes = plan[0] if route == "conveyor" else None
    ring_shape = _batch_ring_shape(mu1p, (W, W), lanes)
    if mu1p.device.type == "cpu":
        if lanes:
            return nonaffine_conveyor_scores_plain(mu1p, mu2p, ns, ms, S,
                                                   gamma, delta, lanes=lanes,
                                                   ring=ring)
        return nonaffine_batch_scores_plain(mu1p, mu2p, ns, ms, S, gamma,
                                            delta, ring=ring)
    name = {"grid": "batch_nonaffine", "cta": "cta_nonaffine",
            "conveyor": "conveyor_nonaffine"}[route]
    consts = (_kernel_consts(False, (gamma, delta)) if route == "cta"
              else _tile_consts(False, (gamma, delta), S))
    return _batch_kernel(name, consts, mu1p, mu2p, ns, ms, ring_shape, ring,
                         d_max, S, *plan)


def _batch_scores_plain(step, centre, mu1p, ns, ms, ring_shape, ring):
    """Run ``step`` over the bucket's diagonals 0..N+M for all B pairs at
    once, in the bucket's geometry (every pair as long as the bucket, its
    tables zero beyond its own lengths), on rings of three slabs
    ``[B, 3, ...]``; pair b's score is captured when d == n_b + m_b, at row
    n_b, as xla_dp.affine_score_traced does under vmap.  ``centre`` maps a
    slab to ``[B, states, P]`` at the shift position (S, S)."""
    B, N, M = mu1p.shape[0], mu1p.shape[1] - 1, mu1p.shape[2] - 1
    dev = mu1p.device
    _check_ring(ring, ring_shape, mu1p)
    if ring is None:
        ring = torch.full(ring_shape, INVALID, dtype=torch.int32, device=dev)
    out = torch.full((B,), INVALID, dtype=torch.int32, device=dev)
    d_last = ns + ms
    rows = ns.long()[:, None, None]
    for d in range(N + M + 1 if B else 0):
        val, live = step(d, ring[:, (d - 1) % RING], ring[:, (d - 2) % RING])
        ring[:, d % RING] = torch.where(live, val, ring[:, d % RING])
        mid = centre(val)
        at_n = mid.gather(2, rows.expand(B, mid.shape[1], 1)).amax((1, 2))
        out = torch.where(d_last == d, at_n, out)
    return out


def affine_batch_scores_plain(mu1p, mu2p, ns, ms, max_shift, beta, gamma,
                              delta, *, ring=None) -> torch.Tensor:
    """Plain twin of K4 and of K6's affine form: :func:`_affine_step` with
    a batch axis.  ``ring``: ``[B, 3, 9, W, W, N+1]``."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    g = _Geometry(mu1p, mu2p, S)
    return _batch_scores_plain(
        _affine_step(g, beta, gamma, delta), lambda val: val[:, :, S, S],
        mu1p, ns, ms, _batch_ring_shape(mu1p, (N_STATES, W, W)), ring)


def nonaffine_batch_scores_plain(mu1p, mu2p, ns, ms, max_shift, gamma, delta,
                                 *, ring=None) -> torch.Tensor:
    """Plain twin of K5 and of K6's non-affine form: :func:`_nonaffine_step`
    with a batch axis.  ``ring``: ``[B, 3, W, W, N+1]``."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    g = _Geometry(mu1p, mu2p, S)
    return _batch_scores_plain(
        _nonaffine_step(g, gamma, delta), lambda val: val[:, None, S, S],
        mu1p, ns, ms, _batch_ring_shape(mu1p, (W, W)), ring)


def affine_ms0_batch_scores_plain(mu1p, mu2p, ns, ms, beta, gamma, delta, *,
                                  ring=None) -> torch.Tensor:
    """Plain twin of K7: :func:`_ms0_step` with a batch axis.  ``ring``:
    ``[B, 3, 3, N+1]``."""
    _check_stacks(mu1p, mu2p, ns, ms, 0)
    return _batch_scores_plain(
        _ms0_step(mu1p, mu2p, beta, gamma, delta), lambda val: val, mu1p, ns,
        ms, _batch_ring_shape(mu1p, (3,)), ring)


def _conveyor_scores_plain(step, centre, g: _ConveyorGeometry, ring_shape,
                           ring):
    """Run ``step`` over the conveyor's steps on one ring of three slabs
    per lane ``[lanes, 3, ...]``: step t reads slabs (t-1) % 3 and
    (t-2) % 3 and writes the live rows of slab t % 3; a pair's score is
    captured on the step its row n_b stands at column m_b.  ``centre`` as
    in :func:`_batch_scores_plain`."""
    B, dev = g.pairs, g.mu1.device
    _check_ring(ring, ring_shape, g.mu1)
    if ring is None:
        ring = torch.full(ring_shape, INVALID, dtype=torch.int32, device=dev)
    out = torch.full((B,), INVALID, dtype=torch.int32, device=dev)
    per_lane = -(-B // g.lanes)
    for t in range((per_lane - 1) * g.T0 + g.n + g.m + 1 if B else 0):
        val, live = step(t, ring[:, (t - 1) % RING], ring[:, (t - 2) % RING])
        rows = live.reshape(g.lanes, *[1] * (val.dim() - 2), g.n + 1)
        ring[:, t % RING] = torch.where(rows, val, ring[:, t % RING])
        b, j, live = g.stripes(t)
        last = (live & (g.i4 == g.ns[b]) & (j == g.ms[b]))[:, 0, 0]
        out[b[:, 0, 0][last]] = centre(val).amax(1)[last]
    return out


def affine_conveyor_scores_plain(mu1p, mu2p, ns, ms, max_shift, beta, gamma,
                                 delta, *, lanes=None,
                                 ring=None) -> torch.Tensor:
    """Plain twin of K8's affine form: :func:`_affine_step` with a lane
    axis and a diagonal index per row.  ``ring``:
    ``[lanes, 3, 9, W, W, N+1]``."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    lanes, T0 = _route_plan(mu1p, "conveyor", lanes, None, S, True)
    g = _ConveyorGeometry(mu1p, mu2p, ns, ms, S, lanes, T0)
    return _conveyor_scores_plain(
        _affine_step(g, beta, gamma, delta), lambda val: val[:, :, S, S], g,
        _batch_ring_shape(mu1p, (N_STATES, W, W), lanes), ring)


def nonaffine_conveyor_scores_plain(mu1p, mu2p, ns, ms, max_shift, gamma,
                                    delta, *, lanes=None,
                                    ring=None) -> torch.Tensor:
    """Plain twin of K8's non-affine form: :func:`_nonaffine_step` with a
    lane axis and a diagonal index per row.  ``ring``:
    ``[lanes, 3, W, W, N+1]``."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    lanes, T0 = _route_plan(mu1p, "conveyor", lanes, None, S, False)
    g = _ConveyorGeometry(mu1p, mu2p, ns, ms, S, lanes, T0)
    return _conveyor_scores_plain(
        _nonaffine_step(g, gamma, delta), lambda val: val[:, None, S, S], g,
        _batch_ring_shape(mu1p, (W, W), lanes), ring)


# -- bands of a bucket of pairs ----------------------------------------------

def _batch_band_shape(mu1p, states: tuple, d_max) -> tuple:
    """``[B, D, *states, N+1]``: D the diagonals 0..d_max (the largest
    n_b + m_b where the caller knows it), at most the bucket's N + M + 1."""
    B, N, M = mu1p.shape[0], mu1p.shape[1] - 1, mu1p.shape[2] - 1
    last = N + M if d_max is None else min(int(d_max), N + M)
    return (B, last + 1, *states, N + 1)


def _bands_kernel(name, cases, mu1p, mu2p, ns, ms, shape, band, d_max, S,
                  affine):
    _check_ring(band, shape, mu1p, "band")
    if band is None:
        band = torch.empty(shape, dtype=torch.int32, device=mu1p.device)
    scores = _batch_kernel(name, cases, mu1p, mu2p, ns, ms, shape, band,
                           d_max, S)
    return DeviceBatchBand(ys=band, ns=ns, ms=ms, max_shift=S,
                           affine=affine), scores


def affine_batch_bands(mu1p, mu2p, ns, ms, max_shift, beta, gamma, delta, *,
                       d_max=None, band=None):
    """Affine bands and scores of a bucket (pallas_dp.py
    ``_affine_pallas_batched_dense`` with ``score_only=False``): K4 in band
    mode for CUDA tensors, the plain twin for CPU tensors.  Returns
    ``(DeviceBatchBand [B, D, 9, W, W, N+1], scores [B])``; D and ``d_max``
    as in :func:`_batch_band_shape`: a pair with n_b + m_b > ``d_max`` gets
    neither its last diagonals nor a score (INVALID).  ``band``: the memory
    to fill, whatever it holds (default: fresh, uninitialised); only the
    pairs' genuine cells are written, and nothing else is read.  On a CUDA
    device a max_shift above 17 raises ``ValueError`` (the tile's shared
    memory, as for K1)."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    if mu1p.device.type == "cpu":
        return affine_batch_bands_plain(mu1p, mu2p, ns, ms, S, beta, gamma,
                                        delta, d_max=d_max, band=band)
    return _bands_kernel(
        "batch_fill_affine", _tile_consts(True, (beta, gamma, delta), S),
        mu1p, mu2p, ns, ms, _batch_band_shape(mu1p, (N_STATES, W, W), d_max),
        band, d_max, S, True)


def nonaffine_batch_bands(mu1p, mu2p, ns, ms, max_shift, gamma, delta, *,
                          d_max=None, band=None):
    """Non-affine bands ``[B, D, W, W, N+1]`` and scores of a bucket
    (pallas_dp.py ``_nonaffine_pallas_batched_dense`` with
    ``score_only=False``): K5 in band mode; as :func:`affine_batch_bands`."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    if mu1p.device.type == "cpu":
        return nonaffine_batch_bands_plain(mu1p, mu2p, ns, ms, S, gamma,
                                           delta, d_max=d_max, band=band)
    return _bands_kernel(
        "batch_fill_nonaffine", _tile_consts(False, (gamma, delta), S), mu1p,
        mu2p, ns, ms, _batch_band_shape(mu1p, (W, W), d_max), band, d_max, S,
        False)


def _batch_bands_plain(step, centre, mu1p, ns, ms, S, shape, band, affine):
    """Run ``step`` over the chunk band's diagonals for all B pairs at once,
    in the bucket's geometry, as the band-mode kernels do: diagonal d reads
    slabs d-1 and d-2 of the band itself and writes the pairs' genuine cells
    of slab d, every other cell keeping what it held (INVALID in a band
    made here).  The scores are captured as in :func:`_batch_scores_plain`.
    """
    B, dev = shape[0], mu1p.device
    _check_ring(band, shape, mu1p, "band")
    if band is None:
        band = torch.full(shape, INVALID, dtype=torch.int32, device=dev)
    bband = DeviceBatchBand(ys=band, ns=ns, ms=ms, max_shift=S, affine=affine)
    genuine = bband.genuine()
    out = torch.full((B,), INVALID, dtype=torch.int32, device=dev)
    blank = torch.full((B, *shape[2:]), INVALID, dtype=torch.int32,
                       device=dev)
    d_last = ns + ms
    rows = ns.long()[:, None, None]
    for d in range(shape[1] if B else 0):
        val, _live = step(d, band[:, d - 1] if d >= 1 else blank,
                          band[:, d - 2] if d >= 2 else blank)
        band[:, d] = torch.where(genuine[:, d], val, band[:, d])
        mid = centre(val)
        at_n = mid.gather(2, rows.expand(B, mid.shape[1], 1)).amax((1, 2))
        out = torch.where(d_last == d, at_n, out)
    return bband, out


def affine_batch_bands_plain(mu1p, mu2p, ns, ms, max_shift, beta, gamma,
                             delta, *, d_max=None, band=None):
    """Plain twin of K4 in band mode: :func:`_affine_step` with a batch
    axis, the chunk band as its carry."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    g = _Geometry(mu1p, mu2p, S)
    return _batch_bands_plain(
        _affine_step(g, beta, gamma, delta), lambda val: val[:, :, S, S],
        mu1p, ns, ms, S, _batch_band_shape(mu1p, (N_STATES, W, W), d_max),
        band, True)


def nonaffine_batch_bands_plain(mu1p, mu2p, ns, ms, max_shift, gamma, delta,
                                *, d_max=None, band=None):
    """Plain twin of K5 in band mode: :func:`_nonaffine_step` with a batch
    axis, the chunk band as its carry."""
    _check_stacks(mu1p, mu2p, ns, ms, max_shift)
    S, W = max_shift, 2 * max_shift + 1
    g = _Geometry(mu1p, mu2p, S)
    return _batch_bands_plain(
        _nonaffine_step(g, gamma, delta), lambda val: val[:, None, S, S],
        mu1p, ns, ms, S, _batch_band_shape(mu1p, (W, W), d_max), band, False)


# -- a bucket's tables from codes --------------------------------------------

def mu_planes_from_codes(lut, ca, cb, sa, sb, ns, ms, sw: int):
    """The stacks ``(mu1p, mu2p)`` int32 ``[B, N+1, M+1]`` of a bucket from
    its pairs' codes (pallas_dp.py ``_mu_planes_from_codes``), on the codes'
    device: ``mu1p[b, i, j] = lut[ca[b, i], cb[b, j]]`` and ``mu2p[b, i, j]
    = sw`` where ``sa[b, i] == sb[b, j]``, both inside ``1 <= i <= n_b``,
    ``1 <= j <= m_b`` and 0 elsewhere: the host tables of
    :func:`~bialign_tpu_torch.scoring.tables.build_score_tables` for a
    protein pair.  ``lut``: int32 ``[256, 256]``; ``ca``, ``sa``: integer
    codes ``[B, N+1]`` (uint8 as :func:`~bialign_tpu_torch.parallel.batch.
    encode_pair` makes them), ``cb``, ``sb``: ``[B, M+1]``; ``ns``, ``ms``:
    int32 ``[B]``.  The table is applied by indexing, exact for every int32
    value (the JAX package contracts one-hot float32 matrices and so
    refuses entries of 2^24 and more).  Plain tensor code on any device, as
    the original is XLA outside any kernel."""
    if (lut.dtype != torch.int32 or tuple(lut.shape) != (256, 256)):
        raise ValueError(f"lut must be int32 [256, 256], got {lut.dtype} "
                         f"{tuple(lut.shape)}")
    B = ca.shape[0]
    for name, t, like in (("cb", cb, cb), ("sa", sa, ca), ("sb", sb, cb)):
        if t.dim() != 2 or t.shape != like.shape or t.shape[0] != B:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit ca "
                             f"{tuple(ca.shape)}, cb {tuple(cb.shape)}")
    dev = ca.device
    if any(t.device != dev for t in (lut, cb, sa, sb, ns, ms)):
        raise ValueError(f"lut, codes and lengths must lie on one device, "
                         f"ca is on {dev}")
    i = torch.arange(ca.shape[1], device=dev)[None, :, None]
    j = torch.arange(cb.shape[1], device=dev)[None, None, :]
    inside = ((i >= 1) & (i <= ns[:, None, None])
              & (j >= 1) & (j <= ms[:, None, None]))
    # a uint8 index tensor would be read as a mask: index with int64
    mu1 = lut[ca.long()[:, :, None], cb.long()[:, None, :]]
    mu1 = torch.where(inside, mu1, 0)
    same = sa[:, :, None] == sb[:, None, :]
    mu2 = (inside & same).to(torch.int32) * int(sw)
    return mu1.contiguous(), mu2.contiguous()
