"""bialign_tpu_torch: the bi-alignment DP of :mod:`bialign_tpu` on PyTorch
and CUDA.

The single-pair path, ``BiAligner(...)`` -> ``optimize()`` ->
``traceback()`` -> ``decode_trace()``, runs on an NVIDIA GPU through
hand-written CUDA kernels (``csrc/``: the affine and non-affine band fills
and the traceback walk), built with ``nvcc`` at first use.  The score of
one pair without a band, ``ops.cuda_dp.affine_score`` and
``nonaffine_score``, runs through three more (``csrc/score_*.cu``).
``BiAligner(..., lowmem=True)`` aligns a pair whose band the card cannot
hold through a checkpointed band (``ops/checkpoint_dp.py``).

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

__all__ = ["AlignConfig", "BiAligner", "__version__"]
