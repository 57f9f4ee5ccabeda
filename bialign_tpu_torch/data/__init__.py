"""Bundled example inputs (reference parity: ``Examples/`` + ``Data/``).

The reference package ships its demonstration inputs — the DNA-Polymerase-1
pair as CFSSP (Chou-Fasman server) output and FASTA (reference
setup.py:49-55, Examples/) — so the README walkthrough, benchmarks, and
tests run without any external checkout.  This package bundles the same
public protein records gzip-compressed and materializes them on demand
into a per-process temporary directory, so the repo is fully standalone.

BLOSUM62 is bundled separately as an embedded constant
(:mod:`bialign_tpu_torch.io.simmatrix`).
"""

from __future__ import annotations

import gzip
import os
import tempfile

from ..io.cfssp import read_molecule_from_file

_DATA_DIR = os.path.dirname(__file__)
_materialized: dict[str, str] = {}

EXAMPLES = (
    "DNAPolymerase1_Escherichia.cfssp",
    "DNAPolymerase1_Xanthomonas.cfssp",
    "DNAPolymerase1_Escherichia.fa",
    "DNAPolymerase1_Xanthomonas.fa",
)


def example_text(name: str) -> str:
    """Contents of a bundled example input file."""
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; have {EXAMPLES}")
    with gzip.open(os.path.join(_DATA_DIR, name + ".gz"), "rt") as fh:
        return fh.read()


def example_path(name: str) -> str:
    """Path of a materialized copy of a bundled example input.

    Files are written once per process into a private ``mkdtemp``
    directory (no fixed world-shared paths).
    """
    if name not in _materialized:
        dirpath = _materialized.get("__dir__")
        if dirpath is None:
            dirpath = tempfile.mkdtemp(prefix="bialign_tpu_torch_examples_")
            _materialized["__dir__"] = dirpath
        path = os.path.join(dirpath, name)
        with open(path, "w") as fh:
            fh.write(example_text(name))
        _materialized[name] = path
    return _materialized[name]


DNAPOL_PAIR = ("DNAPolymerase1_Escherichia.cfssp",
               "DNAPolymerase1_Xanthomonas.cfssp")


def read_example(name: str, mol_type: str = "Protein") -> tuple[str, str]:
    """(sequence, structure) of the bundled example file ``name``."""
    return read_molecule_from_file(example_path(name), mol_type)


def dnapol_pair() -> tuple[str, str, str, str]:
    """(seqA, strA, seqB, strB) of the DNA-Pol-1 pair, E. coli 928 aa
    against Xanthomonas 933 aa."""
    seqA, strA = read_example(DNAPOL_PAIR[0])
    seqB, strB = read_example(DNAPOL_PAIR[1])
    return seqA, strA, seqB, strB
