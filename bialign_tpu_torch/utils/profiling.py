"""Spans and run statistics.

:class:`span` times a stage of the program where the work happens: the
stream driver's chunks (``stream.*``), the batch layer's stages
(``batch.*``) and the single-pair aligner's (``pair.*``).  Each span adds
its host seconds and a count to one registry of the process, keyed by
name, and its seconds to the child time of the span that encloses it on
the same thread, so a stage's self time is its total less its child time.
:func:`snapshot` and :func:`since` give the registry's deltas over a stretch
of a run.  While a ``torch.profiler`` profile is active a span is also an
annotation ``bialign.<name>`` on the profiler's host timeline, the clock of
its device trace.  A span never waits for the device or allocates on it.

``band_cells`` and ``RunStats`` (the structured-stats accumulator of the
streaming driver) are copies of :mod:`bialign_tpu.utils.profiling`'s.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

try:
    # a host-side profiler annotation (a "cpu_op"): unlike record_function's
    # user annotation, the profiler gives it no copy on the device timeline,
    # where it would count as device work
    from torch._C._profiler import _RecordFunctionFast as _Annotation
except ImportError:      # a PyTorch without it: no annotation
    _Annotation = None

_profiling = torch.autograd._profiler_enabled

_lock = threading.Lock()
_totals: dict = {}          # name -> [ns, count, child ns]
_local = threading.local()  # .stack: the open spans of the thread


class Tally(NamedTuple):
    """A span name's total over a stretch of a run: host seconds, spans
    closed, and the seconds of its children (spans it enclosed)."""

    seconds: float
    count: int
    child_seconds: float

    @property
    def self_seconds(self) -> float:
        return self.seconds - self.child_seconds


class span:
    """``with span("stream.dispatch", chunk=k) as s:`` times the block into
    the registry under its name; ``s.seconds`` is then its duration.
    ``args`` (ints) go with the profiler annotation, such as a chunk's
    ordinal in its stream."""

    __slots__ = ("name", "args", "seconds", "_t0", "_child", "_note")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.seconds = 0.0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._child = 0
        self._note = None
        if _Annotation is not None and _profiling():
            self._note = _Annotation("bialign." + self.name, [], self.args)
            self._note.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._note is not None:
            self._note.__exit__(None, None, None)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += ns
        with _lock:
            tally = _totals.get(self.name)
            if tally is None:
                _totals[self.name] = [ns, 1, self._child]
            else:
                tally[0] += ns
                tally[1] += 1
                tally[2] += self._child
        self.seconds = ns * 1e-9
        return False


def snapshot() -> dict:
    """The registry as it stands, for :func:`since`."""
    with _lock:
        return {name: tuple(t) for name, t in _totals.items()}


def since(before: dict) -> dict:
    """``{name: Tally}`` of the spans closed after the ``snapshot()``
    ``before`` (``{}``: since the process started)."""
    out = {}
    for name, (ns, count, child) in snapshot().items():
        ns0, count0, child0 = before.get(name, (0, 0, 0))
        if count > count0:
            out[name] = Tally((ns - ns0) * 1e-9, count - count0,
                              (child - child0) * 1e-9)
    return out


def band_cells(n: int, m: int, max_shift: int) -> int:
    """4D band size (n+1)(m+1)(2s+1)^2 — the unit of the headline metric."""
    return (n + 1) * (m + 1) * (2 * max_shift + 1) ** 2


@dataclass
class RunStats:
    """Structured per-run counters; render with :meth:`to_json`."""

    pairs: int = 0
    cells: int = 0
    batches: int = 0
    dispatches: int = 0     # kernel dispatches (bucket splits) issued
    seconds: float = 0.0
    bucket_pairs: dict = field(default_factory=dict)  # (N, M) -> count
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def add_batch(self, bucket_key, n_pairs: int, n_cells: int,
                  n_dispatches: int = 1):
        self.pairs += n_pairs
        self.cells += n_cells
        self.batches += 1
        self.dispatches += n_dispatches
        key = str(bucket_key)
        self.bucket_pairs[key] = self.bucket_pairs.get(key, 0) + n_pairs

    @property
    def pairs_per_s(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def cells_per_s(self) -> float:
        return self.cells / self.seconds if self.seconds else 0.0

    @property
    def pairs_per_dispatch(self) -> float:
        """Bucket occupancy: mean pairs per kernel dispatch (bigger =
        better dispatch amortization across the length buckets)."""
        return self.pairs / self.dispatches if self.dispatches else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "pairs": self.pairs,
                "cells": self.cells,
                "batches": self.batches,
                "dispatches": self.dispatches,
                "seconds": round(self.seconds, 4),
                "pairs_per_s": round(self.pairs_per_s, 2),
                "cells_per_s": round(self.cells_per_s, 1),
                "pairs_per_dispatch": round(self.pairs_per_dispatch, 2),
                "bucket_pairs": self.bucket_pairs,
            }
        )
