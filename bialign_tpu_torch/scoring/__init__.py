from . import structure, tables
from .structure import (
    consensus_sbpp,
    consensus_sequence,
    highlight_sequence_identity,
    highlight_structure_identity,
    highlight_structure_similarity,
    mea,
    parse_dotbracket,
)
from .tables import (
    build_score_tables,
    sequence_similarity_table,
    structure_similarity_table_protein,
    structure_similarity_table_rna,
)

__all__ = [
    "structure",
    "tables",
    "mea",
    "parse_dotbracket",
    "consensus_sequence",
    "consensus_sbpp",
    "highlight_sequence_identity",
    "highlight_structure_identity",
    "highlight_structure_similarity",
    "build_score_tables",
    "sequence_similarity_table",
    "structure_similarity_table_protein",
    "structure_similarity_table_rna",
]
