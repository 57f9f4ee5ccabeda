"""Similarity-matrix input (BLOSUM-style).

Parity target: reference ``bialignment_nonpyx.py:5-58`` (``read_simmatrix`` and
the embedded BLOSUM62 constant).  Semantics reproduced exactly:

* the literal name ``"BLOSUM62"`` short-circuits to the embedded standard
  NCBI BLOSUM62 matrix (nonpyx:34-35);
* scores are scaled by ``scale`` (default 100) and stored as ints;
* the first whitespace row starting with ``-`` provides the column keys;
* parsing stops after ``len(keys)`` data rows (nonpyx:45-46).

Divergence (documented): on a row/column key mismatch the reference prints a
broken message with a literal ``{filename}`` placeholder (missing f-prefix,
nonpyx:57); we print the actual filename.  Behaviour on well-formed input is
identical.
"""

from __future__ import annotations

# Standard NCBI BLOSUM62 amino-acid substitution matrix (public data; same
# values as reference bialignment_nonpyx.py:5-30 and Data/BLOSUM62.txt).
BLOSUM62_TEXT = """\
-  A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
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

# Kept under the reference's public name as well.
blosum62 = BLOSUM62_TEXT


def materialize_matrix(name: str = "BLOSUM62", directory: str | None = None) -> str:
    """Write a bundled similarity matrix to disk and return its path.

    The reference ships ``Data/BLOSUM62.txt`` (identical to its embedded
    constant, SURVEY.md §2 #24); we keep the single embedded source of
    truth and materialize the file on demand for workflows that want a
    ``--simmatrix <path>`` file (written to ``directory`` or a temp dir).
    """
    import os
    import tempfile

    if name != "BLOSUM62":
        raise ValueError(f"unknown bundled matrix {name!r}")
    if directory is None:
        # private fresh directory, not a fixed world-shared path
        # (symlink/pre-creation tampering on multi-user hosts)
        directory = tempfile.mkdtemp(prefix="bialign_tpu_torch_")
    path = os.path.join(directory, f"{name}.txt")
    with open(path, "w") as fh:
        fh.write(BLOSUM62_TEXT)
    return path


def read_simmatrix(filename: str, scale: int = 100) -> dict:
    """Parse a BLOSUM-style similarity matrix into a dict-of-dict of ints.

    Mirrors reference ``read_simmatrix`` (bialignment_nonpyx.py:33-58): the
    name "BLOSUM62" selects the embedded matrix, every value is multiplied by
    ``scale``, and reading stops after the expected number of data rows.
    """
    if filename == "BLOSUM62":
        lines = BLOSUM62_TEXT.split("\n")
    else:
        with open(filename, "r") as fh:
            lines = fh.readlines()

    col_keys = None
    row_keys = []
    matrix: dict = {}

    for i, line in enumerate(lines):
        if col_keys and i > len(col_keys):
            break
        fields = line.split()
        if not fields:
            continue
        if fields[0] == "-":
            col_keys = fields[1:]
        else:
            row_keys.append(fields[0])
            matrix[fields[0]] = {
                key: scale * int(val) for key, val in zip(col_keys, fields[1:])
            }

    if col_keys != row_keys:
        print(f"ERROR while reading simmatrix {filename}.")
    return matrix
