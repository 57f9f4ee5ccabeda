"""Dense integer score tables for the DP engines.

The reference evaluates mu1 (sequence similarity, bialignment.pyx:404-412,
435-436) and mu2 (structure similarity, pyx:414-429, 439-440) per DP cell
through Python calls.  Here dense int32 tables are computed once on the
host instead:

    mu1[i, j]  for i in 0..n, j in 0..m   (1-based residue indices)
    mu2[k, l]  for k in 0..n, l in 0..m

after which the whole DP is pure integer arithmetic.  Row/column 0 are
never read by any guarded recursion case (every case that scores mu1 needs
i,j >= 1 and every case that scores mu2 needs k,l >= 1), so they are zero.

The RNA structure similarity is the "stral-like" float formula
``int(w * (sqrt(upA*upB) + sqrt(downA*downB) + sqrt(unpA*unpB)))``
(pyx:416-423): computed here in float64 with the reference's exact
evaluation order (sqrt is IEEE correctly rounded; the two additions keep
left-to-right association; int() truncates toward zero) so the resulting
integers are bit-identical to CPython's.
"""

from __future__ import annotations

import functools
import os

import numpy as np


def _char_codes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8).astype(np.intp)


def sequence_similarity_table(
    seqA: str,
    seqB: str,
    *,
    simmatrix: dict | None,
    match: int = 100,
    mismatch: int = 0,
) -> np.ndarray:
    """mu1 table: simmatrix lookup or match/mismatch (pyx:404-412)."""
    n, m = len(seqA), len(seqB)
    out = np.zeros((n + 1, m + 1), dtype=np.int32)
    if n == 0 or m == 0:
        return out

    ca = _char_codes(seqA)
    cb = _char_codes(seqB)

    if simmatrix:
        # 256x256 code lookup built from the dict; unknown residues raise
        # KeyError exactly like the reference's dict access.
        lut = np.zeros((256, 256), dtype=np.int32)
        seen = np.zeros((256, 256), dtype=bool)
        for x in sorted(set(seqA)):
            row = simmatrix[x]
            for y in sorted(set(seqB)):
                lut[ord(x), ord(y)] = row[y]
                seen[ord(x), ord(y)] = True
        assert seen[ca[:, None], cb[None, :]].all()
        out[1:, 1:] = lut[ca[:, None], cb[None, :]]
    else:
        out[1:, 1:] = np.where(
            ca[:, None] == cb[None, :],
            np.int32(match),
            np.int32(mismatch),
        )
    return out


def structure_similarity_table_protein(
    strA: str, strB: str, *, structure_weight: int
) -> np.ndarray:
    """mu2 for proteins: weight iff annotation chars equal (pyx:425-428)."""
    n, m = len(strA), len(strB)
    out = np.zeros((n + 1, m + 1), dtype=np.int32)
    if n == 0 or m == 0:
        return out
    ca = _char_codes(strA)
    cb = _char_codes(strB)
    out[1:, 1:] = np.where(
        ca[:, None] == cb[None, :], np.int32(structure_weight), np.int32(0)
    )
    return out


def structure_similarity_table_rna(
    molA: dict, molB: dict, *, structure_weight: int
) -> np.ndarray:
    """mu2 for RNA: the stral-like pairing-profile similarity (pyx:414-423).

    Evaluation order matches the reference exactly:
    ((sqrt(up)+sqrt(down))+sqrt(unp)) * weight, truncated toward zero.
    """
    n, m = molA["len"], molB["len"]
    out = np.zeros((n + 1, m + 1), dtype=np.int32)
    if n == 0 or m == 0:
        return out

    upA = np.asarray(molA["up"], dtype=np.float64)[1:]
    upB = np.asarray(molB["up"], dtype=np.float64)[1:]
    dnA = np.asarray(molA["down"], dtype=np.float64)[1:]
    dnB = np.asarray(molB["down"], dtype=np.float64)[1:]
    unA = np.asarray(molA["unp"], dtype=np.float64)[1:]
    unB = np.asarray(molB["unp"], dtype=np.float64)[1:]

    s = np.sqrt(upA[:, None] * upB[None, :])
    s = s + np.sqrt(dnA[:, None] * dnB[None, :])
    s = s + np.sqrt(unA[:, None] * unB[None, :])
    out[1:, 1:] = np.trunc(structure_weight * s).astype(np.int32)
    return out


@functools.lru_cache(maxsize=16)
def _sim_lut_cached(name: str, scale: int, stat_key):
    """(lut[256, 256] int32, valid[256, 256] bool) for a named/parsed
    similarity matrix.  Streaming corpora build score tables per pair;
    re-parsing the matrix text and rebuilding a lookup per pair costs as
    much as the tables themselves, so the parse + LUT happen once per
    (matrix, scale, file version)."""
    from ..io.simmatrix import read_simmatrix

    sm = read_simmatrix(name, scale=scale)
    lut = np.zeros((256, 256), dtype=np.int32)
    valid = np.zeros((256, 256), dtype=bool)
    for x, row in sm.items():
        ox = ord(x)
        for y, v in row.items():
            lut[ox, ord(y)] = v
            valid[ox, ord(y)] = True
    return lut, valid


def _sim_lut(name: str, scale: int = 100):
    stat_key = None
    if name != "BLOSUM62" and os.path.exists(name):
        st = os.stat(name)
        stat_key = (st.st_mtime_ns, st.st_size)
    return _sim_lut_cached(name, scale, stat_key)


def _sequence_similarity_from_lut(seqA: str, seqB: str, lut, valid):
    """mu1 via the cached 256x256 LUT; missing residues raise KeyError
    exactly like the reference's ``simmatrix[x][y]`` dict access
    (pyx:404-412): the row char when the whole row is absent, the
    column char otherwise."""
    n, m = len(seqA), len(seqB)
    out = np.zeros((n + 1, m + 1), dtype=np.int32)
    if n == 0 or m == 0:
        return out
    ca = _char_codes(seqA)
    cb = _char_codes(seqB)
    ok = valid[ca[:, None], cb[None, :]]
    if not ok.all():
        i, j = np.argwhere(~ok)[0]
        raise KeyError(seqA[i] if not valid[ca[i]].any() else seqB[j])
    out[1:, 1:] = lut[ca[:, None], cb[None, :]]
    return out


def build_score_tables(molA: dict, molB: dict, params: dict, *, is_rna: bool):
    """Build (mu1, mu2) int32 tables from molecules + reference-style params."""
    if params.get("simmatrix"):
        lut, valid = _sim_lut(params["simmatrix"])
        mu1 = _sequence_similarity_from_lut(molA["seq"], molB["seq"],
                                            lut, valid)
    else:
        mu1 = sequence_similarity_table(
            molA["seq"],
            molB["seq"],
            simmatrix=None,
            match=params.get("sequence_match_similarity", 100),
            mismatch=params.get("sequence_mismatch_similarity", 0),
        )
    if is_rna:
        mu2 = structure_similarity_table_rna(
            molA, molB, structure_weight=params.get("structure_weight", 400)
        )
    else:
        mu2 = structure_similarity_table_protein(
            molA["structure"],
            molB["structure"],
            structure_weight=params.get("structure_weight", 400),
        )
    return mu1, mu2
