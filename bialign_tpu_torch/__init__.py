"""bialign_tpu_torch: the bi-alignment DP of :mod:`bialign_tpu` on PyTorch
and CUDA.

The single-pair path, ``BiAligner(...)`` -> ``optimize()`` ->
``traceback()`` -> ``decode_trace()``, runs on an NVIDIA GPU through
hand-written CUDA kernels (``csrc/``: the affine and non-affine band fills
and the traceback walk), built with ``nvcc`` at first use.  The score of
one pair without a band, ``ops.cuda_dp.affine_score`` and
``nonaffine_score``, runs through three more (``csrc/score_*.cu``).
``BiAligner(..., lowmem=True)`` aligns a pair whose band the card cannot
hold through a checkpointed band (``ops/checkpoint_dp.py``).  Batches of
pairs go through ``parallel`` (``score_batch``, ``align_batch``, the codes
path, and the streaming driver ``StreamingAligner`` with its batch CLI
``python -m bialign_tpu_torch.parallel.batch_cli``); the triplet aligner
is ``BiAlignerTriplet`` (``models/triplet.py``; its fill is one more
kernel, ``csrc/triplet.cu``), the plot
``plot_alignment`` (``render/plot.py``).

The package stands alone: it imports ``torch`` and numpy, never ``jax`` and
nothing of :mod:`bialign_tpu`.  Host preprocessing (``models``), score
tables (``scoring``), readers (``io``), the case tables of the recurrence
(``ops/cases.py``), the host walk (``ops/traceback.py``), the decode
(``render``) and the example data (``data``) are its own copies, under the
names they have in :mod:`bialign_tpu`, and the tests hold each copy to its
original.
"""

from .version import __version__

from .aligner import BiAligner
from .config import AlignConfig
from .models.triplet import BiAlignerTriplet
from .io.simmatrix import blosum62, materialize_matrix, read_simmatrix
from .io.cfssp import read_molecule, read_molecule_from_file
from .io.structure_files import (
    read_dssp,
    read_dssp_file,
    read_stride,
    read_stride_file,
)
from .scoring.structure import (
    consensus_sbpp,
    consensus_sequence,
    highlight_sequence_identity,
    highlight_structure_identity,
    highlight_structure_similarity,
    mea,
    parse_dotbracket,
)
from .render.plot import breaklines, fourway_from_full, plot_alignment, runs

__all__ = [
    "__version__",
    "AlignConfig",
    "BiAligner",
    "BiAlignerTriplet",
    "blosum62",
    "materialize_matrix",
    "read_simmatrix",
    "read_molecule",
    "read_molecule_from_file",
    "read_dssp",
    "read_dssp_file",
    "read_stride",
    "read_stride_file",
    "mea",
    "parse_dotbracket",
    "consensus_sequence",
    "consensus_sbpp",
    "highlight_sequence_identity",
    "highlight_structure_identity",
    "highlight_structure_similarity",
    "breaklines",
    "fourway_from_full",
    "plot_alignment",
    "runs",
]
