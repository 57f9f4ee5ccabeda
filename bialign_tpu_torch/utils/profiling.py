"""Tracing and run statistics.

Counterpart of :mod:`bialign_tpu.utils.profiling`: a ``torch.profiler``
trace wrapper for kernel-level inspection, and the structured-stats
accumulator of the streaming driver (DP cells/s and pairs/s are the
framework's first-class metrics).  ``band_cells`` and ``RunStats`` are
copies of the originals.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's when ``device`` is a CUDA device) and write it as a chrome
    trace, ``trace.json`` in ``log_dir`` (open it in chrome://tracing or
    Perfetto).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
