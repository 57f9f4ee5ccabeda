"""Streaming batch-alignment driver: checkpoint/resume, metrics, several
processes.

Counterpart of :mod:`bialign_tpu.parallel.driver`.  Design:

* input is an iterator of :class:`PairRecord`; pairs are buffered into
  chunks, bucketed by padded shape (:mod:`bialign_tpu_torch.parallel.batch`)
  and scored per bucket on the device;
* every completed chunk is appended to a JSONL results spool with an
  fsync, so a crashed or preempted run resumes exactly where it stopped:
  on restart, already-spooled pair ids are skipped;
* per-chunk structured stats (pairs/s, DP cells/s, bucket occupancy) via
  :class:`bialign_tpu_torch.utils.profiling.RunStats`, and each chunk's
  stages timed in spans (``stream.dispatch`` and its ``stream.encode``,
  ``stream.harvest``; :mod:`bialign_tpu_torch.utils.profiling`);
* several processes: each consumes the pairs whose
  ``index % process_count == process_index`` (round-robin sharding of the
  stream on the host; a pair's DP is local to its device, so no collective
  is needed: each process keeps its share in its own spool, and
  :func:`merge_spools` collects them).  :func:`init_distributed` reads the
  rank and the world size from the environment.

Two serving modes: score-only sweeps (default), and ``alignments=True``:
every pair's traceback runs batched on the device
(:func:`bialign_tpu_torch.parallel.batch.dispatch_align_batch`) and the
compact trace codes are spooled with the score (decode with
:func:`trace_from_codes`).

``engine``, ``device`` and ``mesh`` are those of :mod:`.batch`:
``engine="cuda"`` (default) runs the CUDA kernels and needs a CUDA device,
``"torch"`` their plain PyTorch twins on any device; ``mesh=`` shards every
chunk's buckets over the devices of the mesh's axis "data" (the codes
path's table then on each of them once).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

from ..models.molecule import preprocess_molecule
from ..scoring.tables import build_score_tables
from ..utils.profiling import RunStats, band_cells, span
from . import batch as pbatch


@dataclass
class PairRecord:
    """One alignment job in a stream."""

    id: str
    seqA: str
    seqB: str
    strA: str | None = None
    strB: str | None = None


class ResultSpool:
    """Append-only JSONL spool with resume support."""

    def __init__(self, path: str):
        self.path = path
        self._done: set = set()
        good_bytes = 0
        if os.path.exists(path):
            with open(path, "rb") as f:
                for line in f:
                    if not line.endswith(b"\n"):
                        break  # torn tail from a crash — truncated below
                    try:
                        self._done.add(json.loads(line)["id"])
                    except (ValueError, KeyError):
                        break
                    good_bytes += len(line)
            if good_bytes < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(good_bytes)
        self._f = open(path, "a")

    def is_done(self, pair_id: str) -> bool:
        return pair_id in self._done

    def write(self, pair_id: str, score: int, extra: dict | None = None):
        self.write_many([(pair_id, score, extra)])

    def write_many(self, records):
        """Append many (pair_id, score, extra) records with ONE
        flush+fsync.  Per-record fsync cost dominated chunked streaming
        (an fsync is ~0.1-1 ms; a 256-pair chunk paid it 256 times);
        durability is per chunk — a crash mid-chunk re-scores at most
        one chunk on resume, and a torn final record is truncated by
        the resume scan."""
        lines = []
        ids = []
        for pair_id, score, extra in records:
            rec = {"id": pair_id, "score": int(score)}
            if extra:
                rec.update(extra)
            lines.append(json.dumps(rec) + "\n")
            ids.append(pair_id)
        self._f.write("".join(lines))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._done.update(ids)

    def close(self):
        self._f.close()


class StreamingAligner:
    """Scores (optionally aligns) a stream of pairs in device-efficient
    chunks.

    ``alignments=True`` routes chunks through the batched band fill and the
    batched device walks (:func:`bialign_tpu_torch.parallel.batch.
    dispatch_align_batch`): results then carry the forward trace (spooled
    as its compact int-code list), and :meth:`run` yields
    ``(id, score, trace)`` instead of ``(id, score)``.  Traces are equal to
    the per-pair :class:`~bialign_tpu_torch.BiAligner` walk's.
    """

    def __init__(self, params: dict, *, mesh=None, spool_path: str | None
                 = None, chunk_pairs: int = 256, bucket_quantum: int = 64,
                 process_index: int = 0, process_count: int = 1,
                 alignments: bool = False, codes: str | bool = "auto",
                 engine: str = "cuda", device="cuda"):
        from ..aligner import PARAM_DEFAULTS

        # refuses an unknown engine and engine="cuda" off the card
        self.device = pbatch._resolve(engine, device, mesh)[0]
        self.mesh = mesh
        self.engine = engine
        self.params = dict(PARAM_DEFAULTS)
        self.params.update(params)
        self.spool = ResultSpool(spool_path) if spool_path else None
        self.chunk_pairs = chunk_pairs
        self.bucket_quantum = bucket_quantum
        self.process_index = process_index
        self.process_count = process_count
        self.alignments = alignments
        self.codes = codes
        self.stats = RunStats()
        # host seconds of the chunks' dispatches (tables or codes, packing,
        # queueing): the span stream.dispatch's; the rest of a run is
        # harvest and waiting
        self.dispatch_seconds = 0.0

        self.max_shift = int(self.params["max_shift"])
        beta = int(self.params["gap_opening_cost"])
        gamma = int(self.params["gap_cost"])
        delta = int(self.params["shift_cost"])
        self.affine = beta != 0
        self.ptuple = (beta, gamma, delta) if self.affine else (gamma, delta)
        self.is_rna = self.params["type"] == "RNA"
        self._init_codes_path()

    def _init_codes_path(self):
        """Protein streams score through the codes path: per-pair code
        vectors and a 256 x 256 table kept on the device, the mu tables
        built there, so the host sends O(n) bytes a pair instead of O(n*m)
        table ints and builds no tables.  RNA keeps the host tables
        (float64 mu2 parity).

        ``codes="auto"`` engages on a CUDA device and not on the CPU, where
        building the tables on the host costs no transfer.  ``codes=True``
        forces it anywhere (the CPU tests), ``False`` disables it."""
        self._codes_lut = None
        if self.is_rna or self.codes is False:
            return
        if self.codes == "auto" and self.device.type != "cuda":
            return
        name = self.params.get("simmatrix")
        if name:
            from ..scoring.tables import _sim_lut

            lut, valid = _sim_lut(name)
            rows = valid.any(axis=1)
            cols = valid.any(axis=0)
            if not (valid == np.outer(rows, cols)).all():
                return     # ragged matrix: keep exact dict semantics
            self._valid_rows, self._valid_cols = rows, cols
        else:
            lut = pbatch.match_mismatch_lut(
                int(self.params.get("sequence_match_similarity", 100)),
                int(self.params.get("sequence_mismatch_similarity", 0)),
            )
            self._valid_rows = self._valid_cols = None
        # on the device once: every chunk's dispatch uses it as it is
        self._codes_lut = torch.from_numpy(
            np.ascontiguousarray(lut, dtype=np.int32)).to(self.device)
        self._sw = int(self.params.get("structure_weight", 400))

    def _encode(self, rec: PairRecord):
        """Code vectors for one record, with the tables path's input
        validation (molecule errors + simmatrix KeyError parity)."""
        from ..models.molecule import MoleculeError

        for seq, st in ((rec.seqA, rec.strA), (rec.seqB, rec.strB)):
            if st is None:
                raise MoleculeError(
                    "Structures have to be provided when aligning "
                    "proteins"
                )
            if len(st) != len(seq):
                raise MoleculeError(
                    "Provided structure and sequence must have the "
                    "same length."
                )
        ca, cb, sa, sb = pbatch.encode_pair(rec.seqA, rec.seqB,
                                            rec.strA, rec.strB)
        if self._valid_rows is not None:
            bad = ~self._valid_rows[ca[1:]]
            if bad.any():
                raise KeyError(rec.seqA[int(np.argmax(bad))])
            bad = ~self._valid_cols[cb[1:]]
            if bad.any():
                raise KeyError(rec.seqB[int(np.argmax(bad))])
        return ca, cb, sa, sb

    def _tables(self, rec: PairRecord):
        molA = preprocess_molecule(rec.seqA, rec.strA, is_rna=self.is_rna)
        molB = preprocess_molecule(rec.seqB, rec.strB, is_rna=self.is_rna)
        return build_score_tables(molA, molB, self.params,
                                  is_rna=self.is_rna)

    def takes(self, idx: int, rec: PairRecord) -> bool:
        """Whether :meth:`run` aligns the stream's record ``idx``, ``rec``:
        it is this process's share and not in the spool yet."""
        if idx % self.process_count != self.process_index:
            return False
        return self.spool is None or not self.spool.is_done(rec.id)

    def run(self, records: Iterable[PairRecord]) -> Iterator[tuple]:
        """Consume the stream; yield (id, score) as chunks complete.

        Double-buffered: chunk k+1 is preprocessed, packed and
        DISPATCHED (the kernels are queued on the device's stream and
        run) before chunk k's results are harvested, so host-side table
        building overlaps device compute.  Results are therefore yielded
        one chunk behind the dispatch frontier, in stream order.
        """
        self.stats.start()
        chunk: list[PairRecord] = []
        pending = None
        k = 0               # the chunk's ordinal in this run
        for idx, rec in enumerate(records):
            if not self.takes(idx, rec):
                continue
            chunk.append(rec)
            if len(chunk) >= self.chunk_pairs:
                dispatched = self._dispatch(chunk, k)
                if pending is not None:
                    yield from self._harvest(*pending)
                pending = (chunk, dispatched)
                chunk = []
                k += 1
        if chunk:
            dispatched = self._dispatch(chunk, k)
            if pending is not None:
                yield from self._harvest(*pending)
            pending = (chunk, dispatched)
        if pending is not None:
            yield from self._harvest(*pending)
        self.stats.stop()

    def _dispatch(self, chunk, k):
        """Host side of the chunk ``k`` of a run: build tables (or encode
        codes), pack buckets, LAUNCH the kernels; returns (pending handle,
        band cells, ``k``) without blocking.  Its span, ``stream.dispatch``,
        adds its host seconds to ``dispatch_seconds``."""
        kw = dict(affine=self.affine, bucket_quantum=self.bucket_quantum,
                  engine=self.engine, device=self.device, mesh=self.mesh)
        with span("stream.dispatch", chunk=k) as s:
            if self._codes_lut is not None:
                with span("stream.encode", chunk=k):
                    pairs = [self._encode(r) for r in chunk]
                dispatch = (pbatch.dispatch_align_batch_codes
                            if self.alignments
                            else pbatch.dispatch_score_batch_codes)
                p = dispatch(pairs, self.max_shift, self.ptuple,
                             lut=self._codes_lut, structure_weight=self._sw,
                             **kw)
                cells = sum(
                    band_cells(len(r.seqA), len(r.seqB), self.max_shift)
                    for r in chunk
                )
            else:
                with span("stream.encode", chunk=k):
                    tables = [self._tables(r) for r in chunk]
                dispatch = (pbatch.dispatch_align_batch if self.alignments
                            else pbatch.dispatch_score_batch)
                p = dispatch(tables, self.max_shift, self.ptuple, **kw)
                cells = sum(
                    band_cells(t[0].shape[0] - 1, t[0].shape[1] - 1,
                               self.max_shift)
                    for t in tables
                )
        self.dispatch_seconds += s.seconds
        return p, cells, k

    def _harvest(self, chunk, dispatched):
        """Block on a dispatched chunk, spool it (one fsync), yield its
        results; the span ``stream.harvest`` closes before the first
        yield."""
        p, cells, k = dispatched
        with span("stream.harvest", chunk=k):
            if self.alignments:
                scores, traces, complete = p.get()
                if self.spool is not None:
                    self.spool.write_many(
                        (rec.id, int(score),
                         {"trace": trace_to_codes(traces[pos]),
                          "complete": bool(complete[pos])})
                        for pos, (rec, score) in enumerate(zip(chunk,
                                                               scores))
                    )
                out = [(rec.id, int(score), traces[pos])
                       for pos, (rec, score) in enumerate(zip(chunk, scores))]
            else:
                scores = p.get()
                if self.spool is not None:
                    self.spool.write_many(
                        (rec.id, int(score), None)
                        for rec, score in zip(chunk, scores)
                    )
                out = [(rec.id, int(score))
                       for rec, score in zip(chunk, scores)]
            self.stats.add_batch("chunk", len(chunk), cells,
                                 n_dispatches=p.n_dispatches)
        yield from out


def trace_from_codes(codes) -> list:
    """Spooled int trace codes -> forward trace list of (a, b, c, d),
    the format :meth:`bialign_tpu_torch.BiAligner.traceback` returns."""
    return [((c >> 3) & 1, (c >> 2) & 1, (c >> 1) & 1, c & 1)
            for c in codes]


def trace_to_codes(trace) -> list:
    """Inverse of :func:`trace_from_codes` — the single place the
    column bit-packing convention lives on the host side."""
    return [c0 * 8 + c1 * 4 + c2 * 2 + c3 for (c0, c1, c2, c3) in trace]


def merge_spools(paths) -> dict:
    """Merge per-host spool shards into one ``{id: record}`` dict.

    The multi-host driver gives every process its own spool (modulo
    stream sharding, so shards are disjoint); this is the result-
    collection step.  Only a torn FINAL line (a host crashed mid-write)
    is tolerated, matching ResultSpool's own resume semantics; an
    unparsable line with complete lines after it is mid-file corruption
    and raises instead of silently dropping the rest of the shard.
    Raises ValueError if an id appears in two shards with different
    records — disjointness is the invariant the sharding guarantees.
    """
    merged: dict = {}
    for path in paths:
        # stream (alignment records carry O(n+m) traces; buffering a
        # whole shard was a memory regression); "is this the final
        # line" comes from the newline terminator alone — a torn tail
        # is by definition the unterminated last line
        with open(path, "rb") as fh:
            for ln_no, line in enumerate(fh, start=1):
                if not line.endswith(b"\n"):
                    break  # torn tail: crashed mid-write of last record
                try:
                    rec = json.loads(line)
                    pid = rec["id"]
                except (ValueError, KeyError, TypeError):
                    # a newline-TERMINATED unparsable line is corruption
                    # (not a mid-write tear), wherever it sits — raise
                    raise ValueError(
                        f"corrupt spool record ({path}:{ln_no}); "
                        "refusing to silently drop records"
                    )
                if pid in merged and merged[pid] != rec:
                    raise ValueError(
                        f"conflicting records for pair {pid!r} across "
                        f"spool shards (last: {path})"
                    )
                merged[pid] = rec
    return merged


def init_distributed():
    """(process_index, process_count) of this process from the environment:
    ``RANK`` and ``WORLD_SIZE`` as a launcher such as ``torchrun`` sets
    them; (0, 1) when they are unset.  The stream is shared out by index
    modulo the count, so no process group is formed.  Which card a process
    uses is the caller's choice (``LOCAL_RANK``, else the rank, modulo the
    cards of the host: :func:`bialign_tpu_torch.parallel.batch_cli.
    process_device`)."""
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if rank is None and world is None:
        return 0, 1
    if rank is None or world is None:
        raise ValueError("RANK and WORLD_SIZE must be set together, got "
                         f"RANK={rank!r}, WORLD_SIZE={world!r}")
    rank, world = int(rank), int(world)
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is not in [0, WORLD_SIZE={world})")
    return rank, world
