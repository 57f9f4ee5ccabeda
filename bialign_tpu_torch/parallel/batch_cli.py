"""Corpus batch runner: score (or fully align) a TSV of pairs.

Counterpart of :mod:`bialign_tpu.parallel.batch_cli`.  It streams a TSV
through :class:`bialign_tpu_torch.parallel.driver.StreamingAligner`:
length-bucketed batched fills on the device, optional batched tracebacks,
fsync'd JSONL spooling with resume, and sharing of the stream among
processes (``--distributed``: ``RANK`` and ``WORLD_SIZE`` from the
environment).

Input format: one pair per line, tab-separated::

    id <TAB> seqA <TAB> seqB [<TAB> strA <TAB> strB]

Structures are required for --type Protein (as in the reference) and
predicted via the ViennaRNA path for RNA when omitted.

Usage (on the card; ``--engine torch --device cpu`` runs the plain PyTorch
twins on the CPU)::

    python -m bialign_tpu_torch.parallel.batch_cli pairs.tsv \
        --spool results.jsonl --type Protein --simmatrix BLOSUM62 \
        --structure_weight 800 --gap_opening_cost -150 --gap_cost -50 \
        --shift_cost -150 --max_shift 1 --alignments

Two processes sharing the stream, each writing ``results.jsonl.shard<r>``::

    RANK=0 WORLD_SIZE=2 python -m bialign_tpu_torch.parallel.batch_cli \
        pairs.tsv --spool results.jsonl --distributed ... &
    RANK=1 WORLD_SIZE=2 python -m bialign_tpu_torch.parallel.batch_cli \
        pairs.tsv --spool results.jsonl --distributed ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import deque

import torch


def _iter_pairs(path):
    from .driver import PairRecord

    with open(path) as fh:
        for ln_no, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) not in (3, 5):
                raise SystemExit(
                    f"{path}:{ln_no}: expected 3 or 5 tab-separated "
                    f"fields (id seqA seqB [strA strB]), got {len(parts)}"
                )
            strA = parts[3] if len(parts) == 5 else None
            strB = parts[4] if len(parts) == 5 else None
            yield PairRecord(id=parts[0], seqA=parts[1], seqB=parts[2],
                             strA=strA, strB=strB)


def add_batch_parameters(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("pairs_tsv", help="TSV of pairs: id seqA seqB "
                        "[strA strB]")
    parser.add_argument("--spool", default=None,
                        help="JSONL results spool (enables resume)")
    parser.add_argument("--alignments", action="store_true",
                        help="batched tracebacks too: each emitted JSON "
                        "record carries the packed trace codes (decode "
                        "via bialign_tpu_torch.parallel.driver."
                        "trace_from_codes + render.decode)")
    parser.add_argument("--render", action="store_true",
                        help="with --alignments: also print each pair's "
                        "decoded alignment lines (reference outmode "
                        "rendering) after its JSON record")
    parser.add_argument("--outmode", default="default",
                        help="outmode for --render (reference modes, "
                        "prefix-completed)")
    parser.add_argument("--chunk_pairs", type=int, default=256)
    parser.add_argument("--bucket_quantum", type=int, default=64)
    parser.add_argument("--distributed", action="store_true",
                        help="share the stream among processes: this one "
                        "takes the pairs whose index modulo WORLD_SIZE is "
                        "RANK (both from the environment) and writes the "
                        "spool <spool>.shard<RANK>")
    parser.add_argument("--engine", choices=("cuda", "torch"),
                        default="cuda",
                        help="cuda: the CUDA kernels, on a CUDA device; "
                        "torch: their plain PyTorch twins, on any device")
    parser.add_argument("--device", default="cuda",
                        help="the device to run on (default cuda; with "
                        "--distributed a process takes the card LOCAL_RANK, "
                        "else RANK, modulo the cards of the host)")
    # scoring parameters (reference names, bialign.py:25-96)
    parser.add_argument("--type", default="RNA")
    parser.add_argument("--sequence_match_similarity", type=int,
                        default=100)
    parser.add_argument("--sequence_mismatch_similarity", type=int,
                        default=0)
    parser.add_argument("--structure_weight", type=int, default=400)
    parser.add_argument("--gap_opening_cost", type=int, default=0)
    parser.add_argument("--gap_cost", type=int, default=-200)
    parser.add_argument("--shift_cost", type=int, default=-250)
    parser.add_argument("--max_shift", type=int, default=2)
    parser.add_argument("--simmatrix", default=None)


def process_device(device, rank: int) -> torch.device:
    """The device of process ``rank``: a CUDA device named without an index
    becomes the card ``LOCAL_RANK`` (else ``rank``) modulo the cards of the
    host; any other device is kept as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None \
            or not torch.cuda.is_available():
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _render_one(rec, trace, ns) -> None:
    """Decode one spooled trace to the reference's alignment lines
    (render.decode, same rows/outmodes as the single-pair CLI)."""
    from ..models.molecule import preprocess_molecule
    from ..render import decode as rd

    is_rna = ns.type == "RNA"
    molA = preprocess_molecule(rec.seqA, rec.strA, is_rna=is_rna)
    molB = preprocess_molecule(rec.seqB, rec.strB, is_rna=is_rna)
    full = rd.decode_trace_full(trace, molA, molB, nameA=rec.id + ".A",
                                nameB=rec.id + ".B", is_rna=is_rna)
    for line in rd.decode_trace(full, outmode=ns.outmode):
        print(line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Batch bi-alignment of a pair corpus."
    )
    add_batch_parameters(parser)
    ns = parser.parse_args(argv)

    from .driver import StreamingAligner, init_distributed, trace_to_codes

    pidx, pcount = (0, 1)
    if ns.distributed:
        pidx, pcount = init_distributed()

    params = {
        k: getattr(ns, k)
        for k in (
            "type", "sequence_match_similarity",
            "sequence_mismatch_similarity", "structure_weight",
            "gap_opening_cost", "gap_cost", "shift_cost", "max_shift",
            "simmatrix",
        )
    }
    spool = ns.spool
    if spool and pcount > 1:
        spool = f"{spool}.shard{pidx}"
    if ns.render and not ns.alignments:
        parser.error("--render requires --alignments")
    sa = StreamingAligner(
        params, spool_path=spool, chunk_pairs=ns.chunk_pairs,
        bucket_quantum=ns.bucket_quantum, process_index=pidx,
        process_count=pcount, alignments=ns.alignments, engine=ns.engine,
        device=process_device(ns.device, pidx),
    )
    # The records that --render needs are kept only between dispatch and
    # harvest (about two chunks, the driver's double buffer), only those
    # this process aligns (StreamingAligner.takes), in a queue per id:
    # results come back in stream order, so the k-th result of an id is its
    # k-th record, and a repeated id is rendered with its own sequences.
    pending: dict = {}

    def tracked(records):
        for idx, r in enumerate(records):
            if ns.render and sa.takes(idx, r):
                pending.setdefault(r.id, deque()).append(r)
            yield r

    n_done = 0
    for result in sa.run(tracked(_iter_pairs(ns.pairs_tsv))):
        if ns.alignments:
            pid, score, trace = result
            rec = {"id": pid, "score": score,
                   "trace": trace_to_codes(trace)}
        else:
            pid, score = result
            rec = {"id": pid, "score": score}
        print(json.dumps(rec))
        if ns.render:
            queue = pending[pid]
            _render_one(queue.popleft(), trace, ns)
            if not queue:
                del pending[pid]
        n_done += 1
    print(f"# {n_done} pairs done (process {pidx}/{pcount})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
