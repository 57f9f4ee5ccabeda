"""Version of bialign_tpu_torch (kept equal to bialign_tpu's).

The CLI reports compatibility with the reference BiAlign 0.3 CLI surface
(reference: bialignment_nonpyx.py:3, bialign.py:7).
"""

__version__ = "0.3"
COMPAT_REFERENCE = "BiAlign 0.3"
