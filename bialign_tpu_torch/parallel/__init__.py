"""Scaling over independent pairs: batched scores.

Counterpart of :mod:`bialign_tpu.parallel`, of which the tables-input
batched-scores path is ported (:mod:`.batch`).
"""

from .batch import (
    PendingScores,
    PreparedBatch,
    dispatch_score_batch,
    make_buckets_dense,
    score_batch,
)

__all__ = [
    "PendingScores",
    "PreparedBatch",
    "dispatch_score_batch",
    "make_buckets_dense",
    "score_batch",
]
