"""One protein pair's score tables built on its device from residue codes.

The host tables (:func:`~bialign_tpu_torch.scoring.tables.build_score_tables`)
are O(n*m) ints that a fill on a CUDA device must then check and upload.
For a protein pair both tables are lookups of per-residue codes: mu1 in a
256 x 256 table (a similarity matrix, or match and mismatch), mu2 an
equality of structure codes times the structure weight.  So the device
builds them from the pair's O(n) code vectors, as the stream's codes path
does (:func:`~bialign_tpu_torch.ops.cuda_dp.mu_planes_from_codes`), and the
host keeps what the host tables gave besides the tables:

* the ``KeyError`` of a residue outside the similarity matrix, naming the
  character the host tables name;
* the tables' exact peak magnitude, from which :func:`int32_safe` gives
  :func:`~bialign_tpu_torch.ops.cases.check_int32_safe`'s verdict.

Only a rectangular matrix qualifies (its absent cells are whole rows or
columns): a ragged one keeps the host tables' cell-by-cell ``KeyError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_dp import mu_planes_from_codes
from ..parallel.batch import encode_pair, match_mismatch_lut
from .tables import _sim_lut

_I32 = np.iinfo(np.int32)


class CodeTable:
    """A 256 x 256 int32 mu1 table indexed by residue codes, the codes its
    rows and columns admit (``None``: every code), and its copies on
    devices, each made once."""

    def __init__(self, lut: np.ndarray, rows=None, cols=None):
        self.lut, self.rows, self.cols = lut, rows, cols
        self._on: dict = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self.lut).to(device)
        return t


# id of a host table -> (that table, its CodeTable or None if ragged); the
# entry holds the table, so its id is not reused while the entry lives
_TABLES: dict = {}


@functools.lru_cache(maxsize=16)
def _match_lut(match: int, mismatch: int) -> np.ndarray:
    return match_mismatch_lut(match, mismatch)


def _fits_int32(*values: int) -> bool:
    return all(_I32.min <= v <= _I32.max for v in values)


def code_table(params: dict) -> CodeTable | None:
    """The protein pair's mu1 table as codes index it, or ``None`` where
    codes cannot give the host tables: a ragged similarity matrix, or a
    match, mismatch or structure weight outside int32 (the host tables'
    ``np.int32`` of it raises)."""
    if not _fits_int32(int(params.get("structure_weight", 400))):
        return None
    name = params.get("simmatrix")
    if name:
        lut, valid = _sim_lut(name)
    else:
        costs = (int(params.get("sequence_match_similarity", 100)),
                 int(params.get("sequence_mismatch_similarity", 0)))
        if not _fits_int32(*costs):
            return None
        lut, valid = _match_lut(*costs), None
    kept = _TABLES.get(id(lut))
    if kept is None or kept[0] is not lut:
        rows = cols = None
        ragged = False
        if valid is not None:
            rows, cols = valid.any(axis=1), valid.any(axis=0)
            ragged = not (valid == np.outer(rows, cols)).all()
        table = None if ragged else CodeTable(lut, rows, cols)
        if len(_TABLES) >= 16:
            _TABLES.clear()
        kept = _TABLES[id(lut)] = (lut, table)
    return kept[1]


class PairCodes(NamedTuple):
    """A pair's lengths and codes in one int32 buffer ``[n, m, ca, cb, sa,
    sb]`` (each code vector 1-based, index 0 unused), and the peak
    magnitude of its tables."""

    n: int
    m: int
    buf: np.ndarray
    peak: int


def _abs_max(values: np.ndarray) -> int:
    # as int32_value_bound takes it from the host tables, whose row 0 is 0
    return int(np.abs(values).max(initial=0))


def _present(codes: np.ndarray) -> np.ndarray:
    return np.bincount(codes, minlength=256) > 0


def _check_residues(seqA, seqB, ca, cb, table: CodeTable) -> None:
    """The host tables' ``KeyError``: they scan mu1's cells in row-major
    order and name the first absent cell's row character when its whole
    row is absent, else its column character.  With a rectangular matrix
    that is seqA[0] if its row is absent, else the first residue of seqB
    outside the columns, else the first of seqA outside the rows."""
    if table.rows is None:
        return
    bad_a = ~table.rows[ca]
    if bad_a[0]:
        raise KeyError(seqA[0])
    bad_b = ~table.cols[cb]
    if bad_b.any():
        raise KeyError(seqB[int(np.argmax(bad_b))])
    if bad_a.any():
        raise KeyError(seqA[int(np.argmax(bad_a))])


def encode(molA: dict, molB: dict, table: CodeTable,
           structure_weight: int) -> PairCodes | None:
    """The pair's codes and peak, checked as the host tables check it;
    ``None`` for a character outside latin-1, which has no code (the host
    tables then raise as they do).  An empty sequence raises nothing and
    peaks at 0, as the host tables' zeros do."""
    try:
        ca, cb, sa, sb = encode_pair(molA["seq"], molB["seq"],
                                     molA["structure"], molB["structure"])
    except KeyError:
        return None
    n, m = len(ca) - 1, len(cb) - 1
    peak = 0
    if n and m:
        _check_residues(molA["seq"], molB["seq"], ca[1:], cb[1:], table)
        in_a = np.flatnonzero(_present(ca[1:]))
        in_b = np.flatnonzero(_present(cb[1:]))
        peak = _abs_max(table.lut[np.ix_(in_a, in_b)])
        if (_present(sa[1:]) & _present(sb[1:])).any():
            sw = np.array([int(structure_weight)], np.int32)
            peak = max(peak, _abs_max(sw))
    buf = np.concatenate([np.array([n, m], np.int32), ca, cb, sa, sb],
                         dtype=np.int32)
    return PairCodes(n, m, buf, peak)


def planes(codes: PairCodes, table: CodeTable, structure_weight: int,
           device) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair's (mu1, mu2), contiguous int32 ``[n+1, m+1]`` on
    ``device``, from its codes in one copy and the table put there once."""
    n, m = codes.n, codes.m
    buf = torch.from_numpy(codes.buf).to(device)
    ca, cb, sa, sb = torch.split(buf[2:], (n + 1, m + 1, n + 1, m + 1))
    mu1, mu2 = mu_planes_from_codes(
        table.on(buf.device), ca[None], cb[None], sa[None], sb[None],
        buf[0:1], buf[1:2], int(structure_weight))
    return mu1[0], mu2[0]


def int32_safe(n: int, m: int, peak: int, params: dict) -> bool:
    """:func:`~bialign_tpu_torch.ops.cases.check_int32_safe`'s verdict on
    tables of ``n`` x ``m`` residues whose largest magnitude is ``peak``
    (the formula of :func:`~bialign_tpu_torch.ops.cases.int32_value_bound`)."""
    per_col = (
        2 * abs(params.get("gap_cost", -200))
        + 2 * abs(params.get("gap_opening_cost", 0))
        + 2 * abs(params.get("shift_cost", -250))
        + 2 * peak
    )
    bound = 2 * (n + m + 2) * per_col
    return (-(1 << 30)) - bound > _I32.min + (1 << 20)
