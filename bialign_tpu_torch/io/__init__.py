from .simmatrix import (
    BLOSUM62_TEXT,
    blosum62,
    materialize_matrix,
    read_simmatrix,
)
from .cfssp import read_molecule, read_molecule_from_file
from .fasta import iter_fasta, read_fasta, read_first_sequence
from .structure_files import (
    read_dssp,
    read_dssp_file,
    read_stride,
    read_stride_file,
)

__all__ = [
    "BLOSUM62_TEXT",
    "blosum62",
    "materialize_matrix",
    "read_simmatrix",
    "read_dssp",
    "read_dssp_file",
    "read_stride",
    "read_stride_file",
    "read_molecule",
    "read_molecule_from_file",
    "iter_fasta",
    "read_fasta",
    "read_first_sequence",
]
