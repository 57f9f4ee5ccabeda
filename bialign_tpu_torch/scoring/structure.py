"""Secondary-structure utilities: MEA structure, consensus bpp, dot-bracket.

Parity targets in the reference:
* ``mea``            -- bialignment.pyx:836-886 (Nussinov-style maximum
  expected accuracy fold with candidate lists).
* ``consensus_sbpp`` -- bialignment.pyx:926-950 (geometric-mean consensus of
  two gapped base-pair-probability matrices).
* ``parse_dotbracket``   -- bialignment.pyx:911-922.
* ``consensus_sequence`` -- bialignment.pyx:901-908.
* ``highlight_*``        -- bialignment.pyx:890-898, 954-990.

All of this is host-side float64 numpy: these run once per alignment, are not
on the DP hot path, and float semantics must match CPython doubles exactly
(sqrt is IEEE correctly rounded, and every sum/comparison below preserves the
reference's evaluation order, so numpy vectorization is bit-safe).
"""

from __future__ import annotations

import numpy as np


def mea(sbpp, gamma: float = 3, *, brackets: str = "()"):
    """Maximum-expected-accuracy structure from a bpp matrix (1-based).

    Same recurrence and tie-breaking as the reference (pyx:836-886):
    F[i,j] = best of (split at a candidate k with its cached value) and
    (pair (i,j) when j-i > 3, value F[i+1,j-1] + 2*gamma*p_ij); strictly
    better values win, so the earliest candidate wins ties.  Returns
    ``(structure_string, F[1,n])``.
    """
    sbpp = np.asarray(sbpp, dtype=np.float64)
    n = len(sbpp) - 1

    F = np.zeros((n + 1, n + 1), dtype=np.float64)
    T = np.zeros((n + 1, n + 1), dtype=np.intp)

    # candidate arrays per right end j: positions and cached values
    cand_k = [[] for _ in range(n + 1)]
    cand_v = [[] for _ in range(n + 1)]

    for i in reversed(range(1, n + 1)):
        cand_k[i].append(i)
        cand_v[i].append(sbpp[i, i])
        for j in range(i, n + 1):
            ks = np.asarray(cand_k[j], dtype=np.intp)
            vals = F[i, ks - 1] + np.asarray(cand_v[j], dtype=np.float64)
            best = int(np.argmax(vals))
            # strict improvement over the 0-initialised cell, first max wins
            if vals[best] > F[i, j]:
                F[i, j] = vals[best]
                T[i, j] = ks[best]

            if i + 3 >= j:
                continue
            paired = F[i + 1, j - 1] + 2 * gamma * sbpp[i, j]
            if paired > F[i, j]:
                cand_k[j].append(i)
                cand_v[j].append(paired)
                F[i, j] = paired
                T[i, j] = i

    structure = ["."] * (n + 1)
    stack = [(1, n)]
    while stack:
        i, j = stack.pop()
        k = T[i, j]
        if i + 3 >= j or k == 0:
            continue
        if k == j:
            stack.append((i, j - 1))
        elif k == i:
            structure[k] = brackets[0]
            structure[j] = brackets[1]
            stack.append((k + 1, j - 1))
        else:
            stack.append((i, k - 1))
            stack.append((k + 1, j - 1))
            structure[k] = brackets[0]
            structure[j] = brackets[1]

    return ("".join(structure[1:]), F[1, n])


def parse_dotbracket(dbstr: str):
    """Pair table of a dot-bracket string; -1 for unpaired (pyx:911-922)."""
    res = [-1] * len(dbstr)
    stack = []
    for i, sym in enumerate(dbstr):
        if sym == "(":
            stack.append(i)
        elif sym == ")":
            j = stack.pop()
            res[i] = j
            res[j] = i
    return res


def consensus_sequence(alistrA: str, alistrB: str) -> str:
    """Positionwise consensus: the character if equal (upper-cased), else '.'

    (pyx:901-908)."""
    a = alistrA.upper()
    b = alistrB.upper()
    return "".join(x if x == y else "." for x, y in zip(a, b))


def _gapped_positions(alistr: str) -> np.ndarray:
    """1-based molecule position per alignment column; 0 at gap columns."""
    nongap = np.frombuffer(alistr.encode("latin-1"), dtype=np.uint8) != ord("-")
    pos = np.cumsum(nongap)
    return np.where(nongap, pos, 0).astype(np.intp)


def consensus_sbpp(alistrA: str, sbppA, alistrB, sbppB):
    """Consensus bpp of two gapped structures: sqrt(pA*pB) per column pair.

    Vectorized form of reference pyx:926-950: per alignment-column pair
    (c0, c1) look up each molecule's bpp at its (1-based) residue positions,
    zero where either column is a gap, and take the geometric mean.
    """
    sbppA = np.asarray(sbppA, dtype=np.float64)
    sbppB = np.asarray(sbppB, dtype=np.float64)
    L = len(alistrA)

    out = np.zeros((L + 1, L + 1), dtype=np.float64)
    pA = _gapped_positions(alistrA)
    pB = _gapped_positions(alistrB)
    maskA = pA > 0
    maskB = pB > 0

    prA = np.where(
        maskA[:, None] & maskA[None, :], sbppA[pA[:, None], pA[None, :]], 0.0
    )
    prB = np.where(
        maskB[:, None] & maskB[None, :], sbppB[pB[:, None], pB[None, :]], 0.0
    )
    out[1:, 1:] = np.sqrt(prA * prB)
    return out


def highlight_sequence_identity(alistrA: str, alistrB: str):
    """Upper-case identical columns, lower-case the rest (pyx:890-898)."""
    res = ["", ""]
    for x, y in zip(alistrA.lower(), alistrB.lower()):
        if x == y:
            x = x.upper()
            y = x
        res[0] += x
        res[1] += y
    return res


def highlight_structure_identity(alistrA: str, alistrB: str):
    """Mark base pairs shared by two dot-bracket strings (pyx:954-971)."""
    strA = parse_dotbracket(alistrA)
    strB = parse_dotbracket(alistrB)

    res = ["", ""]
    for i, (x, y) in enumerate(zip(alistrA.lower(), alistrB.lower())):
        if strA[i] >= 0 and strB[i] >= 0 and strA[i] == strB[i]:
            x = "[" if strA[i] > i else "]"
            y = x
        res[0] += x
        res[1] += y
    return res


def highlight_structure_similarity(alistrA: str, alistrB: str, *, sbppA, sbppB):
    """Mark MEA-consensus base pairs in both strings (pyx:974-990)."""
    sbpp = consensus_sbpp(alistrA, sbppA, alistrB, sbppB)
    structure = parse_dotbracket(mea(sbpp)[0])

    res = [list(alistrA), list(alistrB)]
    for i in range(len(alistrA)):
        for j in range(i + 1, len(alistrA)):
            if structure[i] == j:
                res[0][i] = "<"
                res[1][i] = "<"
                res[0][j] = ">"
                res[1][j] = ">"
    return ["".join(x) for x in res]
