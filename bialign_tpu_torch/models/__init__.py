from .molecule import (
    MoleculeError,
    bp_matrix_from_fixed_structure,
    expected_pairing,
    preprocess_molecule,
    symmetrize_bpps,
)

__all__ = [
    "MoleculeError",
    "bp_matrix_from_fixed_structure",
    "expected_pairing",
    "preprocess_molecule",
    "symmetrize_bpps",
]
