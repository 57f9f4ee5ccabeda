"""Trace decoding: the 14-line alignment model and output modes.

Parity targets in the reference:
* ``BiAligner._transfer_gaps``     -- bialignment.pyx:589-599
* ``BiAligner._shift_string``      -- bialignment.pyx:601-621
* ``BiAligner.auto_complete``      -- bialignment.pyx:623-630
* ``BiAligner.decode_trace_full``  -- bialignment.pyx:633-707
* ``BiAligner.decode_trace``       -- bialignment.pyx:709-743
* ``BiAligner.outmodes`` / ``nl``  -- bialignment.pyx:168-177

The 14 rows, in order (SURVEY.md §2.3): A ss / A / B ss / B / consensus ss /
consensus for the sequence-alignment copy, the same six for the structure-
alignment copy, then the two shift rows.  Row index 14 is an appended blank
line used by the sorted modes as a block separator.
"""

from __future__ import annotations

from ..scoring.structure import consensus_sbpp, consensus_sequence, mea

NL_ROW = 14

# Row-index orders per output mode (reference bialignment.pyx:169-177).
OUTMODES = {
    "default": [1, 3, 6, 8, 12, 13],
    "sorted": [0, 1, 5, 3, 2, 4, NL_ROW] + [7, 6, 10, 8, 9, 11, NL_ROW] + [12, 13],
    "sorted_sym": [0, 1, 3, 2, 5, 4, NL_ROW]
    + [6, 7, 9, 8, 11, 10, NL_ROW]
    + [12, 13],
    "sorted_terse": [1, 5, 3, 4, NL_ROW] + [6, 10, 8, 11, NL_ROW] + [12, 13],
    "raw": [1, 3, 7, 9],
    "raw_struct": list(range(4)) + list(range(6, 10)),
    "full": range(NL_ROW),
}


def transfer_gaps(alistr: str, seqstr: str) -> str:
    """Copy the gap pattern of ``alistr`` onto ``seqstr`` (pyx:589-599)."""
    out = []
    pos = 0
    for c in alistr:
        if c == "-":
            out.append("-")
        else:
            out.append(seqstr[pos])
            pos += 1
    return "".join(out)


def shift_string(ali, idx: int) -> str:
    """Shift-annotation row from the two copies of molecule ``idx``.

    ``<``/``>`` where exactly one of the copies gaps, ``.`` otherwise
    (pyx:601-621).
    """
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


def auto_complete(x: str, xs) -> str:
    """First (sorted) candidate with prefix ``x``; ``x`` itself if none
    (pyx:623-630)."""
    for y in sorted(xs):
        if y.startswith(x):
            return y
    return x


def decode_trace_full(trace, molA: dict, molB: dict, *, nameA: str,
                      nameB: str, is_rna: bool):
    """Decode a trace into the named 14-line alignment (pyx:633-707).

    ``trace`` is the forward-ordered list of column 4-tuples produced by the
    traceback.  Returns ``[(name, string), ...]`` with 14 entries.
    """
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

    # structure-annotated rows: (ss, seq) per alignment row
    anno_ali = []
    for alistr, mol in zip(alignment, mols):
        anno_ali.append(transfer_gaps(alistr, mol["structure"]))
        anno_ali.append(alistr)

    # consensus-structure rows, str-copy first (insertion order matters:
    # reference iterates [(4, 6), (0, 2)] and inserts at j + 2, pyx:662-673)
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


def decode_trace(full_alignment, *, outmode: str = "default",
                 nodescription: bool = False):
    """Format and reorder the full 14-line alignment (pyx:709-743)."""
    width = max(len(name) for name, _ in full_alignment) + 4

    if not nodescription:
        lines = [
            "{:{width}}{}".format(name, alistr, width=width)
            for name, alistr in full_alignment
        ]
    else:
        lines = [alistr for _, alistr in full_alignment]

    lines.append("")  # row 14: blank separator

    mode = auto_complete(outmode, OUTMODES.keys())
    if mode in OUTMODES:
        order = OUTMODES[mode]
    else:
        print(
            "WARNING: unknown output mode. Expect one of "
            + str(list(OUTMODES.keys()))
        )
        order = OUTMODES["sorted"]

    return [lines[i] for i in order]
