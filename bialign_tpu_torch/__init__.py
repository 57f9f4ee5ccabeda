"""bialign_tpu_torch: the bi-alignment DP of :mod:`bialign_tpu` on PyTorch
and CUDA.

The single-pair path, ``BiAligner(...)`` -> ``optimize()`` ->
``traceback()`` -> ``decode_trace()``, runs on an NVIDIA GPU through
hand-written CUDA kernels (``csrc/``: the affine and non-affine band fills
and the traceback walk), built with ``nvcc`` at first use.  Host
preprocessing, score tables, the case tables of the recurrence and the
decode are imported from :mod:`bialign_tpu`, none of whose imported
modules load JAX; this package never imports ``jax``.
"""

from bialign_tpu.version import __version__

from .aligner import BiAligner

__all__ = ["BiAligner", "__version__"]
