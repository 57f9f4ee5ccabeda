"""Scaling over independent pairs and over devices: batched scores and
alignments, the streaming driver, and the sequence split of one pair.

Counterpart of :mod:`bialign_tpu.parallel`: the batched scores and
alignments, from tables and from codes (:mod:`.batch`), with ``mesh=``
sharding the buckets over the devices of a :class:`Mesh` (:mod:`.mesh`);
the streaming driver with its batch CLI (:mod:`.driver`, :mod:`.batch_cli`);
and the sequence split, one pair's rows over the devices of a mesh axis
(:mod:`.seqsplit`).
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
from .mesh import Mesh
from .seqsplit import SeqsplitBand, fill_seqsplit, score_seqsplit

__all__ = [
    "Mesh",
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
    "fill_seqsplit",
    "init_distributed",
    "make_buckets_dense",
    "match_mismatch_lut",
    "merge_spools",
    "score_batch",
    "score_seqsplit",
    "SeqsplitBand",
    "trace_from_codes",
    "trace_to_codes",
]
