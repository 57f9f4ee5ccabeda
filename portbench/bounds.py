"""The least time the card could take for the DP's kernels: the peaks and
the operation and byte counts behind every roofline share this benchmark
reports.

Peaks of one NVIDIA H100 SXM (data sheet, full 700 W power limit): device
memory 3.35 TB/s; int32 on the CUDA cores 132 SMs x 64 lanes x 1.98 GHz
(boost) = 16.7e12 operations a second (the DP has no tensor-core form).
A bound is the larger of bytes over the first and operations over the
second.  Counts are of genuine cells (no bucket padding): each input byte
read once, each output byte written once, and one add and one max per
(cell, shift position, state, case).  Copied from the repository's
card-side check (``chip_smoke.py``, ``dp_bound`` and its siblings), whose
arithmetic this benchmark keeps as its own yardstick.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

# (cases, states) of each recurrence
AFFINE = (15, 9)
NONAFFINE = (13, 1)


def recurrence(affine):
    return AFFINE if affine else NONAFFINE


def bound_s(nbytes, ops):
    """Seconds the card needs at least to move ``nbytes`` and do ``ops``
    int32 operations."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S)


def dp_bound(n, m, S, cases, states, band):
    """A single pair's fill (``band``) or score: the two tables and the
    band (or the last diagonal's slab) once."""
    cells, W2 = (n + 1) * (m + 1), (2 * S + 1) ** 2
    slab = states * W2 * (n + 1) * 4
    nbytes = 2 * cells * 4 + (n + m + 1 if band else 1) * slab
    return bound_s(nbytes, cells * W2 * states * cases * 2)


def batch_bound(lengths, S, cases, states):
    """Scores of a batch of pairs ``lengths`` [(n, m)]: each pair's tables
    read once and one score written."""
    cells = sum((n + 1) * (m + 1) for n, m in lengths)
    W2 = (2 * S + 1) ** 2
    return bound_s(2 * cells * 4 + 4 * len(lengths),
                   cells * W2 * states * cases * 2)


def band_bound(lengths, S, cases, states):
    """Bands of a batch: as :func:`batch_bound`, and every pair's band cells
    written once."""
    cells = sum((n + 1) * (m + 1) for n, m in lengths)
    W2 = (2 * S + 1) ** 2
    return bound_s(2 * cells * 4 + cells * W2 * states * 4 + 4 * len(lengths),
                   cells * W2 * states * cases * 2)


def walk_bound(steps, cases):
    """Walks of ``steps`` columns in all: per step the cell, its cases'
    predecessors and two table entries read and one code written; one add
    and one compare per case."""
    return bound_s(steps * ((cases + 3) * 4 + 4), steps * cases * 2)


def share(run, kernels, need):
    """Percent of the roofline: ``need(cases, states)``, the least seconds
    for the traced slice's work, over the seconds the trace gives the
    kernels named ``kernels``; None where the run has no trace, no traced
    pairs or none of those kernels' time."""
    t = run.trace
    if t is None or not run.traced_pairs:
        return None
    busy = t.seconds_of(kernels)
    if not busy:
        return None
    return 100.0 * need(*recurrence(run.affine)) / busy
