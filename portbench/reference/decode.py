"""The 14-line decode of a trace and its output modes: a frozen copy of
upstream's decode (bialignment.pyx:589-743, 836-950) as the JAX package of
this repository writes it (``bialign_tpu/render/decode.py``,
``bialign_tpu/scoring/structure.py``), held here unchanged so that the
benchmark's check does not move with the program.  Plain Python and numpy.
"""

from __future__ import annotations

import numpy as np

from .tables import partners

NL_ROW = 14
OUTMODES = {
    "default": [1, 3, 6, 8, 12, 13],
    "sorted": [0, 1, 5, 3, 2, 4, NL_ROW] + [7, 6, 10, 8, 9, 11, NL_ROW]
    + [12, 13],
}


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


def bp_matrix(structure):
    """0/1 pairing matrix of a fixed structure, 1-based; an unpaired
    position has 1 on the diagonal (pyx:378-392)."""
    n = len(structure)
    p = partners(structure)
    out = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(1, n + 1):
        out[i, p[i] if p[i] else i] = 1.0
    return out


def molecule(seq, structure, *, rna):
    mol = {"seq": seq, "structure": structure}
    if rna:
        mol["sbpp"] = bp_matrix(structure)
    return mol


def transfer_gaps(alistr, seqstr):
    out = []
    pos = 0
    for c in alistr:
        if c == "-":
            out.append("-")
        else:
            out.append(seqstr[pos])
            pos += 1
    return "".join(out)


def shift_string(ali, idx):
    out = []
    for c1, c2 in zip(ali[idx], ali[idx + 2]):
        g1 = c1 == "-"
        g2 = c2 == "-"
        if g1 == g2:
            out.append(".")
        elif g1:
            out.append(">")
        else:
            out.append("<")
    return "".join(out)


def decode_trace_full(trace, molA, molB, *, nameA, nameB, is_rna):
    mols = (molA, molB, molA, molB)
    pos = [0] * 4
    alignment = [[] for _ in range(4)]
    for y in trace:
        for s in range(4):
            if y[s] == 0:
                alignment[s].append("-")
            else:
                alignment[s].append(mols[s]["seq"][pos[s]])
                pos[s] += 1
    alignment = ["".join(rows) for rows in alignment]

    cons_seq = [
        consensus_sequence(alignment[2 * i], alignment[2 * i + 1])
        for i in range(2)
    ]
    anno_ali = []
    for alistr, mol in zip(alignment, mols):
        anno_ali.append(transfer_gaps(alistr, mol["structure"]))
        anno_ali.append(alistr)
    for i, j in [(4, 6), (0, 2)]:
        if is_rna:
            sbpp = consensus_sbpp(
                anno_ali[i], molA["sbpp"], anno_ali[j], molB["sbpp"]
            )
            structure = mea(sbpp, brackets="[]")[0]
        else:
            structure = consensus_sequence(anno_ali[i], anno_ali[j])
        anno_ali.insert(j + 2, structure)

    shift_strings = [shift_string(alignment, i) for i in range(2)]
    rows = anno_ali
    rows.insert(len(rows), cons_seq[1])
    rows.insert(len(rows) // 2, cons_seq[0])
    rows.extend(shift_strings)

    ss = " ss"
    names = [
        nameA + ss, nameA, nameB + ss, nameB, "consensus" + ss, "consensus",
        nameA + ss, nameA, nameB + ss, nameB, "consensus" + ss, "consensus",
        nameA + " shifts", nameB + " shifts",
    ]
    return list(zip(names, rows))


def decode_trace(full_alignment, *, outmode="default"):
    width = max(len(name) for name, _ in full_alignment) + 4
    lines = ["{:{width}}{}".format(name, alistr, width=width)
             for name, alistr in full_alignment]
    lines.append("")
    return [lines[i] for i in OUTMODES[outmode]]


def lines(trace, rec, *, rna, outmode="default", names=("A", "B")):
    """The decoded lines of ``trace`` for the record (seqA, seqB, strA,
    strB), as ``BiAligner.decode_trace`` prints them."""
    seqA, seqB, strA, strB = rec
    full = decode_trace_full(trace, molecule(seqA, strA, rna=rna),
                             molecule(seqB, strB, rna=rna), nameA=names[0],
                             nameB=names[1], is_rna=rna)
    return decode_trace(full, outmode=outmode)
