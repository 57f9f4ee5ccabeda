"""DSSP and STRIDE secondary-structure file readers.

The reference ships these parsers only as notebook cells
(``Notebooks/bialign.ipynb`` cells 14-15, outside the installable package);
here they are first-class package modules with the same observable
behaviour, so protein case studies (DSSP-4 / STRIDE annotated PDB chains)
feed straight into :class:`bialign_tpu_torch.BiAligner`.

Both readers return a dict with ``"seq"`` (one-letter residues) and
``"str"`` (one-letter secondary-structure classes, blanks mapped to ``C``
= coil), matching the 3-class-plus alphabet used by the protein scoring
path (H/E/T/C/...), and accept an optional ``chain=`` filter.
"""

from __future__ import annotations

import re

# DSSP data lines carry the one-letter amino acid in column 13 and the
# secondary-structure class in column 16; DSSP 4 mmCIF-derived output also
# repeats the auth chain id at column 152 on its wide (>=190 char) lines,
# which is what the chain filter keys on (same layout the reference
# notebook assumes, bialign.ipynb cell 14).
_DSSP_AA_COL = 13
_DSSP_SS_COL = 16
_DSSP_CHAIN_COL = 152
_DSSP_MIN_LINE = 190

_DSSP_HEADER_RE = re.compile(r"#  RESIDUE AA STRUCTURE")
_STRIDE_CHN_RE = re.compile(r"^CHN\s+\S+\s+(\w)")
_STRIDE_SEQ_RE = re.compile(r"^SEQ\s+(\d+)\s+(\w+)\s+(\d+)")


def read_dssp(text: str, *, chain: str | None = None) -> dict:
    """Parse DSSP output text into ``{"seq": ..., "str": ...}``.

    Counterpart of ``read_dssp_file_content`` (reference
    Notebooks/bialign.ipynb cell 14): residue/SS columns are fixed, lines
    shorter than the wide DSSP-4 layout are skipped, blank SS classes
    become ``C``, and ``chain`` restricts to one auth chain id.
    """
    seq_chars: list[str] = []
    ss_chars: list[str] = []
    in_body = False
    for line in text.split("\n"):
        if not in_body:
            in_body = _DSSP_HEADER_RE.search(line) is not None
            continue
        if len(line) < _DSSP_MIN_LINE:
            continue
        if chain is not None and line[_DSSP_CHAIN_COL] != chain:
            continue
        seq_chars.append(line[_DSSP_AA_COL])
        ss_chars.append(line[_DSSP_SS_COL])
    ss = "".join(ss_chars).replace(" ", "C")
    return {"seq": "".join(seq_chars), "str": ss}


def read_dssp_file(filename: str, *, chain: str | None = None) -> dict:
    with open(filename) as fh:
        return read_dssp(fh.read(), chain=chain)


def read_stride(text: str, *, chain: str | None = None) -> dict:
    """Parse STRIDE output text into ``{"seq": ..., "str": ...}``.

    Counterpart of ``read_stride_file_content`` (reference
    Notebooks/bialign.ipynb cell 15): ``CHN`` records select the current
    chain, each ``SEQ`` record gives the residue range whose width bounds
    the payload slice of itself and the following ``STR`` records, and
    blank SS classes become ``C``.
    """
    seq_chars: list[str] = []
    ss_chars: list[str] = []
    cur_chain: str | None = None
    width = 0
    for line in text.split("\n"):
        m = _STRIDE_CHN_RE.match(line)
        if m:
            cur_chain = m.group(1)
        if chain is not None and cur_chain != chain:
            continue
        m = _STRIDE_SEQ_RE.search(line)
        if m:
            width = int(m.group(3)) - int(m.group(1)) + 1
            seq_chars.append(line[10:10 + width])
        elif line.startswith("STR"):
            ss_chars.append(line[10:10 + width])
    ss = "".join(ss_chars).replace(" ", "C")
    return {"seq": "".join(seq_chars), "str": ss}


def read_stride_file(filename: str, *, chain: str | None = None) -> dict:
    with open(filename) as fh:
        return read_stride(fh.read(), chain=chain)
