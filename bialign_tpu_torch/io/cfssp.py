"""CFSSP (Chou-Fasman server output) reader.

Parity target: reference ``bialignment_nonpyx.py:61-95``.  A CFSSP file
contains interleaved 4-field ``Query`` (sequence) and ``Struc`` (secondary
structure) lines whose third field is accumulated.

Divergence (documented): the reference's ``read_molecule_from_file`` calls
``sys.exit`` without importing ``sys`` and therefore dies with a NameError
after printing its message (nonpyx:84-95); we exit cleanly with the same
messages.
"""

from __future__ import annotations

import sys
from collections import defaultdict


def read_molecule(content: str, type: str):
    """Parse CFSSP text into ``[sequence, structure]``.

    Mirrors reference ``read_molecule`` (nonpyx:61-81): Protein only;
    accumulates field 3 of 4-field Query/Struc lines; validates equal,
    non-zero lengths.
    """
    if type != "Protein":
        raise IOError(f"Cannot read files of type {type}")

    result = defaultdict(str)
    keys = ["Query", "Struc"]
    for line in content.split("\n"):
        fields = line.split()
        if not fields:
            continue
        if fields[0] in keys:
            if len(fields) != 4:
                raise IOError("Cannot parse")
            result[fields[0]] += fields[2]

    if len(result[keys[0]]) != len(result[keys[1]]):
        raise IOError("Sequence and structure of unequal length.")
    if len(result[keys[0]]) == 0:
        raise IOError("Input does not contain input sequence and structure.")

    return [result[k] for k in keys]


def read_molecule_from_file(filename: str, type: str):
    """Read a CFSSP file; on error print a message and exit (nonpyx:84-95)."""
    try:
        with open(filename, "r") as fh:
            return read_molecule(fh.read(), type)
    except FileNotFoundError as e:
        print("Input file not found.")
        print(e)
        sys.exit(-1)
    except IOError as e:
        print(f"Cannot read input file {filename}.")
        print(e)
        sys.exit(-1)
