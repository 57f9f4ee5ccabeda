"""The example molecules bundled with :mod:`bialign_tpu` (``data/*.gz``),
read for the port: the DNA-Polymerase-1 pair of the reference's examples."""

from __future__ import annotations

from bialign_tpu.data import example_path
from bialign_tpu.io.cfssp import read_molecule_from_file

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
