"""Rendering of a trace: the text decode (:mod:`.decode`) and the plot
(:mod:`.plot`, matplotlib imported only when a plot is drawn)."""

from . import decode, plot
from .decode import (
    NL_ROW,
    OUTMODES,
    auto_complete,
    decode_trace,
    decode_trace_full,
    shift_string,
    transfer_gaps,
)
from .plot import breaklines, fourway_from_full, plot_alignment, runs

__all__ = [
    "decode",
    "plot",
    "NL_ROW",
    "OUTMODES",
    "auto_complete",
    "decode_trace",
    "decode_trace_full",
    "shift_string",
    "transfer_gaps",
    "breaklines",
    "fourway_from_full",
    "plot_alignment",
    "runs",
]
