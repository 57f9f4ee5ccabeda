"""Molecule models: RNA / protein preprocessing for bi-alignment.

Parity targets in the reference:
* ``BiAligner._preprocess_seq``            -- bialignment.pyx:340-376
* ``BiAligner._symmetrize_bpps``           -- bialignment.pyx:326-338
* ``BiAligner._bp_matrix_from_fixed_structure`` -- bialignment.pyx:378-392
* ``BiAligner._expected_pairing``          -- bialignment.pyx:394-402

A molecule is a plain dict with keys ``seq``, ``len``, ``structure`` and, for
RNA, ``sbpp`` plus the per-position pairing-probability vectors ``up``,
``down``, ``unp``.  NOTE: ``up[i]`` sums j in [1, i-1) — the reference's
off-by-one (it omits j = i-1) is reproduced on purpose for bit parity
(pyx:367-369).  All sums run left-to-right in float64 to match CPython
double semantics exactly.
"""

from __future__ import annotations

import numpy as np


class MoleculeError(ValueError):
    """Raised on invalid molecule input (the CLI converts this to exit -1)."""


def symmetrize_bpps(bpp) -> np.ndarray:
    """Mirror an upper-triangular bpp matrix; diagonal := unpaired prob.

    1-based like the reference (row/column 0 ignored); pyx:326-338.
    """
    n = len(bpp) - 1
    sbpp = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(1, n + 1):
        for j in range(i + 1, n + 1):
            sbpp[i, j] = bpp[i][j]
            sbpp[j, i] = bpp[i][j]

    for i in range(1, n + 1):
        acc = 0.0
        for j in range(1, n + 1):
            acc += sbpp[i, j]
        sbpp[i, i] = 1.0 - acc
    return sbpp


def bp_matrix_from_fixed_structure(structure: str) -> np.ndarray:
    """0/1 'probability' matrix of a fixed dot-bracket structure; unpaired
    positions get 1 on the diagonal (pyx:378-392)."""
    n = len(structure)
    bpm = np.zeros((n + 1, n + 1), dtype=np.float64)
    stack: list = []
    for i in range(n):
        if structure[i] == "(":
            stack.append(i)
        elif structure[i] == ")":
            j = stack.pop()
            bpm[i + 1, j + 1] = 1.0
            bpm[j + 1, i + 1] = 1.0
        else:
            bpm[i + 1, i + 1] = 1.0
    return bpm


def _pairing_vectors(sbpp: np.ndarray, n: int):
    """Per-position upstream/downstream/unpaired probabilities (1-based).

    up[i] sums j in [1, i-1) — reference off-by-one kept (pyx:367-374).
    Left-to-right accumulation for exact CPython-double parity.
    """
    up = [0.0] * (n + 1)
    down = [0.0] * (n + 1)
    unp = [0.0] * (n + 1)
    for i in range(n + 1):
        acc = 0
        for j in range(1, i - 1):
            acc += sbpp[i, j]
        up[i] = acc
        acc = 0
        for j in range(i + 1, n + 1):
            acc += sbpp[i, j]
        down[i] = acc
        unp[i] = 1.0 - up[i] - down[i]
    return up, down, unp


def expected_pairing(mol: dict) -> list:
    """Expected pairing offset per position (pyx:394-402)."""
    n = mol["len"]
    sbpp = mol["sbpp"]

    def ep(i):
        acc = 0
        for j in range(1, n + 1):
            acc += sbpp[i, j] * (j - i)
        return acc

    return [0] + [ep(i) for i in range(1, n + 1)]


def preprocess_molecule(sequence, structure, *, is_rna: bool) -> dict:
    """Build the molecule dict used by scoring and decoding (pyx:340-376).

    RNA without a structure folds with ViennaRNA (lazy optional import,
    pyx:347-353); RNA with a fixed structure derives a 0/1 bp matrix;
    proteins must come with a structure string.
    """
    mol: dict = {}
    mol["seq"] = str(sequence)
    mol["len"] = len(mol["seq"])

    if structure is None:
        if is_rna:
            try:
                import RNA  # ViennaRNA python bindings (optional)
            except ImportError:
                RNA = None
            from .. import scoring

            if RNA is not None:
                # reference path (pyx:347-353): ViennaRNA ensemble
                fc = RNA.fold_compound(str(sequence))
                mol["mfe"] = fc.mfe()
                mol["pf"] = fc.pf()
                mol["sbpp"] = symmetrize_bpps(fc.bpp())
                mol["structure"] = mol["pf"][0]
            else:
                # standalone fallback: built-in partition function
                # (documented divergence — see scoring/fold.py)
                from ..scoring.fold import partition_bpp

                mol["sbpp"] = partition_bpp(str(sequence))
                ms, _ = scoring.structure.mea(mol["sbpp"])
                mol["structure"] = ms
            mol["mea"] = scoring.structure.mea(mol["sbpp"])
        else:
            raise MoleculeError(
                "Structures have to be provided when aligning proteins"
            )
    else:
        if len(structure) != len(sequence):
            raise MoleculeError(
                "Provided structure and sequence must have the same length."
            )
        mol["structure"] = structure
        if is_rna:
            mol["sbpp"] = bp_matrix_from_fixed_structure(structure)

    n = mol["len"]
    if is_rna:
        up, down, unp = _pairing_vectors(mol["sbpp"], n)
        mol["up"] = up
        mol["down"] = down
        mol["unp"] = unp

    return mol
