"""Scaling over independent pairs: batched scores and alignments.

Counterpart of :mod:`bialign_tpu.parallel`, of which the batched scores and
alignments, from tables and from codes, are ported (:mod:`.batch`).
"""

from .batch import (
    PendingAlignments,
    PendingScores,
    PreparedBatch,
    align_batch,
    dispatch_align_batch,
    dispatch_align_batch_codes,
    dispatch_score_batch,
    dispatch_score_batch_codes,
    encode_pair,
    make_buckets_dense,
    match_mismatch_lut,
    score_batch,
)

__all__ = [
    "PendingAlignments",
    "PendingScores",
    "PreparedBatch",
    "align_batch",
    "dispatch_align_batch",
    "dispatch_align_batch_codes",
    "dispatch_score_batch",
    "dispatch_score_batch_codes",
    "encode_pair",
    "make_buckets_dense",
    "match_mismatch_lut",
    "score_batch",
]
