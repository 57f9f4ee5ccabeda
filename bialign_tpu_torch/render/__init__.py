"""Rendering of a trace: the text decode.  The plot of the JAX package
(``bialign_tpu/render/plot.py``) is not ported yet (ROADMAP.md Queue 1 P17).
"""

from . import decode
from .decode import (
    NL_ROW,
    OUTMODES,
    auto_complete,
    decode_trace,
    decode_trace_full,
    shift_string,
    transfer_gaps,
)

__all__ = [
    "decode",
    "NL_ROW",
    "OUTMODES",
    "auto_complete",
    "decode_trace",
    "decode_trace_full",
    "shift_string",
    "transfer_gaps",
]
