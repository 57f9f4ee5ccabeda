"""Scaling over independent pairs: batched scores and alignments, and the
streaming driver.

Counterpart of :mod:`bialign_tpu.parallel`: the batched scores and
alignments, from tables and from codes (:mod:`.batch`), and the streaming
driver with its batch CLI (:mod:`.driver`, :mod:`.batch_cli`) are ported;
the sequence split (``seqsplit``) and ``mesh=`` are not yet (ROADMAP.md
Queue 1 P15).
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
from .driver import (
    PairRecord,
    ResultSpool,
    StreamingAligner,
    init_distributed,
    merge_spools,
    trace_from_codes,
    trace_to_codes,
)

__all__ = [
    "PairRecord",
    "PendingAlignments",
    "PendingScores",
    "PreparedBatch",
    "align_batch",
    "ResultSpool",
    "StreamingAligner",
    "dispatch_align_batch",
    "dispatch_align_batch_codes",
    "dispatch_score_batch",
    "dispatch_score_batch_codes",
    "encode_pair",
    "init_distributed",
    "make_buckets_dense",
    "match_mismatch_lut",
    "merge_spools",
    "score_batch",
    "trace_from_codes",
    "trace_to_codes",
]
