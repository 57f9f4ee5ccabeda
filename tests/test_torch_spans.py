"""Spans of the port (``bialign_tpu_torch.utils.profiling``): the registry
(nesting, child time, counts, deltas, threads), the profiler annotations,
and the spans of the stream driver, the batch layer and the single-pair
aligner on the CPU (``engine="torch"``)."""

import json
import sys
import threading
import time

import pytest
import torch

import golden as G
from bialign_tpu_torch import BiAligner, aligner
from bialign_tpu_torch.parallel.driver import PairRecord, StreamingAligner
from bialign_tpu_torch.utils import profiling as P

CPU = dict(engine="torch", device="cpu")
PARAMS = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
              gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
              max_shift=1)
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _records(k=6):
    base = "RAKLPLKEKKLTATANYHPGIRYIMTG"
    return [PairRecord(f"p{i}", base[:10 + i], base[1:11 + i],
                       "H" * (10 + i), "H" * (10 + i)) for i in range(k)]


def _children(got, names):
    return sum(got[n].seconds for n in names if n in got)


# -- the registry --------------------------------------------------------------

def test_nesting_child_time_and_counts():
    before = P.snapshot()
    with P.span("t.outer") as outer:
        time.sleep(0.002)
        for _ in range(3):
            with P.span("t.inner"):
                time.sleep(0.001)
    got = P.since(before)
    assert set(got) == {"t.outer", "t.inner"}
    assert got["t.outer"].count == 1 and got["t.inner"].count == 3
    assert got["t.inner"].child_seconds == 0
    # the outer span's child time is exactly its children's seconds
    assert got["t.outer"].child_seconds == got["t.inner"].seconds
    assert got["t.inner"].seconds >= 0.003
    assert got["t.outer"].self_seconds >= 0.002
    assert outer.seconds == pytest.approx(got["t.outer"].seconds)


def test_since_gives_the_deltas_of_a_stretch():
    with P.span("t.delta"):
        pass
    before = P.snapshot()
    assert "t.delta" not in P.since(before)
    for _ in range(2):
        with P.span("t.delta"):
            time.sleep(0.001)
    middle = P.snapshot()
    with P.span("t.delta"):
        pass
    first, last = P.since(before)["t.delta"], P.since(middle)["t.delta"]
    assert first.count == 3 and last.count == 1
    assert first.seconds >= 0.002 > last.seconds
    assert P.since({})["t.delta"].count >= 4


def test_a_span_that_raises_is_counted_and_closed():
    before = P.snapshot()
    with pytest.raises(KeyError):
        with P.span("t.raises"):
            raise KeyError("x")
    with P.span("t.after"):
        pass
    got = P.since(before)
    assert got["t.raises"].count == 1
    # the span that raised left the stack: the next one has no parent
    assert got["t.raises"].child_seconds == 0
    assert not P._local.stack


def test_threads_keep_their_own_stacks_and_lose_no_update():
    before = P.snapshot()
    threads, rounds = 16, 200

    def work():
        for _ in range(rounds):
            with P.span("t.thread.outer"):
                with P.span("t.thread.inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = P.since(before)
    assert got["t.thread.outer"].count == threads * rounds
    assert got["t.thread.inner"].count == threads * rounds
    # an inner span is charged to its own thread's outer one only
    assert got["t.thread.outer"].child_seconds == \
        got["t.thread.inner"].seconds


# -- the profiler's annotations ------------------------------------------------

def test_an_annotation_is_entered_only_under_a_profiler(monkeypatch):
    made = []

    class Note:
        def __init__(self, name, values, kwargs):
            made.append((name, dict(kwargs)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(P, "_Annotation", Note)
    with P.span("t.quiet", chunk=1):
        pass
    assert made == []
    with torch.profiler.profile(activities=CPU_ONLY):
        with P.span("t.loud", chunk=7):
            pass
    assert made == [("bialign.t.loud", {"chunk": 7})]


def test_annotations_are_host_ops_on_the_profilers_clock(tmp_path):
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with P.span("t.traced"):
            with P.span("t.traced.inner"):
                torch.ones(4).sum()
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert "bialign.t.traced" in names and "bialign.t.traced.inner" in names
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {ev["name"]: ev.get("cat") for ev in events
            if ev.get("name", "").startswith("bialign.")}
    # not "user_annotation", which the profiler copies onto the device's
    # timeline, where a reader of device work would count it as busy
    assert cats == {"bialign.t.traced": "cpu_op",
                    "bialign.t.traced.inner": "cpu_op"}


# -- the stream driver and the batch layer -------------------------------------

DISPATCH_CHILDREN = ("stream.encode", "batch.pack", "batch.upload",
                     "batch.planes", "batch.launch")
HARVEST_CHILDREN = ("batch.wait", "batch.unpack")


@pytest.mark.parametrize("alignments", [False, True])
@pytest.mark.parametrize("codes", [False, True])
def test_stream_spans(codes, alignments):
    before = P.snapshot()
    drv = StreamingAligner(PARAMS, chunk_pairs=4, bucket_quantum=8,
                           codes=codes, alignments=alignments, **CPU)
    out = list(drv.run(_records()))
    assert len(out) == 6
    got = P.since(before)
    want = {"stream.dispatch", "stream.encode", "stream.harvest",
            "batch.pack", "batch.upload", "batch.launch", "batch.wait"}
    if codes:
        want.add("batch.planes")
    if alignments:
        want.add("batch.unpack")
    assert set(got) == want
    assert got["stream.dispatch"].count == got["stream.harvest"].count == 2
    assert got["stream.encode"].count == 2
    # the spans under a chunk's dispatch and harvest are its children only
    dispatch, harvest = got["stream.dispatch"], got["stream.harvest"]
    assert dispatch.child_seconds == pytest.approx(
        _children(got, DISPATCH_CHILDREN), rel=1e-9)
    assert harvest.child_seconds == pytest.approx(
        _children(got, HARVEST_CHILDREN), rel=1e-9)
    assert dispatch.child_seconds <= dispatch.seconds
    assert harvest.child_seconds <= harvest.seconds
    for name in want:
        assert got[name].seconds > 0
    # one timer: dispatch_seconds is the span's total
    assert drv.dispatch_seconds == pytest.approx(dispatch.seconds, rel=1e-12)


def test_stream_annotations_carry_the_chunk():
    with torch.profiler.profile(activities=CPU_ONLY,
                                record_shapes=True) as prof:
        out = list(StreamingAligner(PARAMS, chunk_pairs=2, alignments=True,
                                    codes=True, **CPU).run(_records(5)))
    assert len(out) == 5
    chunks = {}
    for ev in prof.events():
        if ev.name.startswith("bialign.stream."):
            chunks.setdefault(ev.name, []).append(ev.kwinputs["chunk"])
    assert {k: sorted(v) for k, v in chunks.items()} == {
        "bialign.stream.dispatch": [0, 1, 2],
        "bialign.stream.encode": [0, 1, 2],
        "bialign.stream.harvest": [0, 1, 2]}


# -- the single-pair aligner ---------------------------------------------------

@pytest.mark.parametrize("lowmem", [False, True])
def test_pair_spans(lowmem):
    before = P.snapshot()
    ba = BiAligner(**G.TOY_PROTEIN, lowmem=lowmem, **G.TOY_PROTEIN_PARAMS,
                   **CPU)
    assert ba.optimize() == G.TOY_PROTEIN_SCORE
    ba.decode_trace(ba.traceback())
    got = P.since(before)
    assert set(got) == {"pair.setup", "pair.molecules", "pair.tables",
                        "pair.fill", "pair.check", "pair.upload",
                        "pair.launch", "pair.score", "pair.walk",
                        "pair.decode"}
    assert all(t.count == 1 for t in got.values())
    setup, fill = got["pair.setup"], got["pair.fill"]
    assert setup.child_seconds == pytest.approx(
        _children(got, ("pair.molecules", "pair.tables")), rel=1e-9)
    assert fill.child_seconds == pytest.approx(
        _children(got, ("pair.check", "pair.upload", "pair.launch",
                        "pair.score")), rel=1e-9)
    assert setup.child_seconds <= setup.seconds
    assert fill.child_seconds <= fill.seconds
    # a decode given its trace walks nothing again
    assert got["pair.decode"].child_seconds == 0


@pytest.mark.parametrize("lowmem", [False, True])
def test_pair_spans_on_the_device_route(lowmem, monkeypatch):
    """The tables built from codes (the route of a CUDA device, forced on
    the CPU): ``pair.tables`` holds ``pair.encode`` and ``pair.planes``,
    and the fill uploads nothing."""
    monkeypatch.setattr(aligner, "_builds_on_device", lambda device: True)
    before = P.snapshot()
    ba = BiAligner(**G.TOY_PROTEIN, lowmem=lowmem, **G.TOY_PROTEIN_PARAMS,
                   **CPU)
    assert ba.optimize() == G.TOY_PROTEIN_SCORE
    ba.decode_trace(ba.traceback())
    got = P.since(before)
    assert set(got) == {"pair.setup", "pair.molecules", "pair.tables",
                        "pair.encode", "pair.planes", "pair.fill",
                        "pair.check", "pair.launch", "pair.score",
                        "pair.walk", "pair.decode"}
    assert all(t.count == 1 for t in got.values())
    tables, fill = got["pair.tables"], got["pair.fill"]
    assert tables.child_seconds == pytest.approx(
        _children(got, ("pair.encode", "pair.planes")), rel=1e-9)
    assert fill.child_seconds == pytest.approx(
        _children(got, ("pair.check", "pair.launch", "pair.score")),
        rel=1e-9)
    assert tables.child_seconds <= tables.seconds


@pytest.mark.parametrize("mol,params,share", [
    (G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS, 1.0),
    (G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS, 0.0),
], ids=["protein", "rna"])
def test_the_share_of_pairs_on_the_device_route(mol, params, share,
                                                monkeypatch):
    """``pair.planes``'s count over ``pair.tables``': every protein pair
    on a device that builds tables, no RNA pair."""
    monkeypatch.setattr(aligner, "_builds_on_device", lambda device: True)
    before = P.snapshot()
    for _ in range(3):
        BiAligner(**mol, **params, **CPU)
    got = P.since(before)
    planes = got["pair.planes"].count if "pair.planes" in got else 0
    assert planes / got["pair.tables"].count == share
