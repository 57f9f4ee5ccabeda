"""The score tables of a pair, from its raw sequences and structures.

mu1[i, j] (sequence similarity) and mu2[k, l] (structure similarity) for
1-based positions, row and column 0 zero (upstream bialignment.pyx:404-440):

* mu1: the similarity matrix scaled by 100 (``simmatrix``), else ``match``
  where the residues are equal and ``mismatch`` where not;
* mu2, protein: ``structure_weight`` where the structure annotations are
  equal, else 0;
* mu2, RNA: int(w * (sqrt(upA upB) + sqrt(downA downB) + sqrt(unpA unpB)))
  of the pairing profiles, float64 in that order.  For a fixed dot-bracket
  structure the pairing matrix is 0/1: up[i] = 1 where i pairs with some
  p <= i - 2 (upstream sums j in [1, i - 1)), down[i] = 1 where it pairs
  with p > i, unp = 1 - up - down.

Also a reader of the CFSSP files the benchmark's data come in.
"""

from __future__ import annotations

import gzip

import numpy as np

# NCBI BLOSUM62 (public data), the matrix upstream embeds.
BLOSUM62 = """\
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
A  4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
R -1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
N -2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
D -2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
C  0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
Q -1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
E -1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
G  0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
H -2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
I -1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
L -1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
K -1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
M -1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
F -2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
P -1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
S  1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
W -3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
Y -2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
V  0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
B -2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
Z -1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
X  0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
* -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


def blosum62_lut(scale=100):
    """[256, 256] int64 lookup of BLOSUM62 x ``scale``; raises on a residue
    outside the matrix when used through :func:`sequence_table`."""
    lines = BLOSUM62.strip("\n").split("\n")
    cols = lines[0].split()
    lut = np.full((256, 256), np.iinfo(np.int64).min, dtype=np.int64)
    for line in lines[1:]:
        fields = line.split()
        for c, v in zip(cols, fields[1:]):
            lut[ord(fields[0]), ord(c)] = scale * int(v)
    return lut


def _codes(s):
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8).astype(np.intp)


def sequence_table(seqA, seqB, *, simmatrix=None, match=100, mismatch=0):
    out = np.zeros((len(seqA) + 1, len(seqB) + 1), dtype=np.int64)
    a, b = _codes(seqA), _codes(seqB)
    if simmatrix:
        if simmatrix != "BLOSUM62":
            raise ValueError(f"unknown similarity matrix {simmatrix!r}")
        vals = blosum62_lut()[a[:, None], b[None, :]]
        if (vals == np.iinfo(np.int64).min).any():
            raise KeyError("residue outside BLOSUM62")
        out[1:, 1:] = vals
    else:
        out[1:, 1:] = np.where(a[:, None] == b[None, :], match, mismatch)
    return out


def partners(structure):
    """1-based partner of each position of a dot-bracket string (0:
    unpaired), index 0 unused."""
    p = np.zeros(len(structure) + 1, dtype=np.int64)
    stack = []
    for pos, ch in enumerate(structure, start=1):
        if ch == "(":
            stack.append(pos)
        elif ch == ")":
            q = stack.pop()
            p[pos], p[q] = q, pos
    if stack:
        raise ValueError("unbalanced structure")
    return p


def pairing_profile(structure):
    """(up, down, unp) float64 of a fixed structure, 1-based, index 0 the
    upstream value (0, 0, 1)."""
    p = partners(structure)
    pos = np.arange(len(p))
    up = ((p > 0) & (p <= pos - 2)).astype(np.float64)
    down = ((p > 0) & (p > pos)).astype(np.float64)
    up[0] = down[0] = 0.0
    return up, down, 1.0 - up - down


def structure_table(strA, strB, *, rna, weight):
    out = np.zeros((len(strA) + 1, len(strB) + 1), dtype=np.int64)
    if not rna:
        a, b = _codes(strA), _codes(strB)
        out[1:, 1:] = np.where(a[:, None] == b[None, :], weight, 0)
        return out
    ua, da, na = (v[1:] for v in pairing_profile(strA))
    ub, db, nb = (v[1:] for v in pairing_profile(strB))
    s = np.sqrt(ua[:, None] * ub[None, :])
    s = s + np.sqrt(da[:, None] * db[None, :])
    s = s + np.sqrt(na[:, None] * nb[None, :])
    out[1:, 1:] = np.trunc(weight * s).astype(np.int64)
    return out


def tables(rec, params):
    """(mu1, mu2) int64 of a record (seqA, seqB, strA, strB) under the
    configuration's parameters."""
    seqA, seqB, strA, strB = rec
    rna = params["type"] == "RNA"
    mu1 = sequence_table(seqA, seqB, simmatrix=params.get("simmatrix"),
                         match=params.get("sequence_match_similarity", 100),
                         mismatch=params.get("sequence_mismatch_similarity",
                                             0))
    mu2 = structure_table(strA, strB, rna=rna,
                          weight=params["structure_weight"])
    return mu1, mu2


def read_cfssp(path):
    """(sequence, structure) of a gzip'd CFSSP file: the third field of its
    4-field ``Query`` and ``Struc`` lines, joined."""
    parts = {"Query": [], "Struc": []}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            fields = line.split()
            if fields and fields[0] in parts:
                if len(fields) != 4:
                    raise ValueError(f"{path}: cannot parse {line!r}")
                parts[fields[0]].append(fields[2])
    seq, st = "".join(parts["Query"]), "".join(parts["Struc"])
    if not seq or len(seq) != len(st):
        raise ValueError(f"{path}: sequence and structure differ in length")
    return seq, st
