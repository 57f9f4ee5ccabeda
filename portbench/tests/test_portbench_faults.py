"""A run on the CPU (the program's plain twins, the card's look skipped)
with the timed path broken underneath: ``correct`` must come out false for
each fault a cell can have, and true when nothing is broken."""

import numpy as np
import pytest

from portbench.tests.tiny import run_tiny, tiny_cell

STREAMS = ["readme-dnapol1.scores", "readme-dnapol1.align"]
PAIRS = ["readme-dnapol1.pair", "cli-defaults-rna.pair16s"]


@pytest.mark.parametrize("workload", STREAMS + PAIRS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(tmp_path, workload, trace):
    res = run_tiny(tiny_cell(tmp_path, workload), trace=trace)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0
    assert list(res)[-1] == "check"
    assert all(v["value"] <= v["limit"] for k, v in res["check"].items()
               if k != "compared")


def _swapped(trace):
    """The trace with its first two different columns swapped: as long,
    as decodable, another alignment."""
    t = list(trace)
    for i in range(len(t) - 1):
        if t[i] != t[i + 1]:
            t[i], t[i + 1] = t[i + 1], t[i]
            break
    return t


def _stream_faults(monkeypatch, fault, alignments):
    from bialign_tpu_torch.parallel import batch, driver

    harvest = driver.StreamingAligner._harvest
    if fault == "stale":
        last = {}

        def stale(self, chunk, dispatched):
            outs = list(harvest(self, chunk, dispatched))
            prev = last.get("outs", outs)
            last["outs"] = outs
            for out, old in zip(outs, prev):
                yield (out[0],) + tuple(old[1:])
        monkeypatch.setattr(driver.StreamingAligner, "_harvest", stale)
    elif fault == "half":
        def half(self, chunk, dispatched):
            outs = list(harvest(self, chunk, dispatched))
            yield from outs[:len(outs) // 2]
        monkeypatch.setattr(driver.StreamingAligner, "_harvest", half)
    elif fault == "altered" and not alignments:
        get = batch.PendingScores.get
        monkeypatch.setattr(batch.PendingScores, "get",
                            lambda self: get(self) + 1)
    elif fault == "altered":
        get = batch.PendingAlignments.get

        def altered(self):
            scores, traces, complete = get(self)
            return scores, [_swapped(t) for t in traces], complete
        monkeypatch.setattr(batch.PendingAlignments, "get", altered)


@pytest.mark.parametrize("workload", STREAMS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_stream_fault_is_caught(tmp_path, monkeypatch, workload, fault):
    cell = tiny_cell(tmp_path, workload)
    _stream_faults(monkeypatch, fault, bool(cell.mix.get("alignments")))
    res = run_tiny(cell)
    assert not res["correct"], res["check"]


def _pair_faults(monkeypatch, fault):
    from bialign_tpu_torch import aligner

    BA = aligner.BiAligner
    if fault == "stale":
        optimize, last = BA.optimize, {}

        def stale(self):
            score = optimize(self)
            prev = last.get("score", score)
            last["score"] = score
            return prev
        monkeypatch.setattr(BA, "optimize", stale)
    elif fault == "score":
        optimize = BA.optimize
        monkeypatch.setattr(BA, "optimize", lambda self: optimize(self) + 1)
    elif fault == "trace":
        traceback = BA.traceback

        monkeypatch.setattr(BA, "traceback",
                            lambda self: _swapped(traceback(self)))
    elif fault == "lines":
        decode = BA.decode_trace

        def altered(self, trace=None):
            out = list(decode(self, trace))
            out[1] = out[1][:-1] + ("-" if out[1][-1] != "-" else "A")
            return out
        monkeypatch.setattr(BA, "decode_trace", altered)
    elif fault == "tables":
        init = BA.__init__

        def altered(self, *a, **kw):
            init(self, *a, **kw)
            self.mu1 = np.array(self.mu1)
            self.mu1[1, 1] += 1
        monkeypatch.setattr(BA, "__init__", altered)


@pytest.mark.parametrize("workload", PAIRS)
@pytest.mark.parametrize("fault", ["stale", "score", "trace", "lines",
                                   "tables"])
def test_pair_fault_is_caught(tmp_path, monkeypatch, workload, fault):
    cell = tiny_cell(tmp_path, workload)
    _pair_faults(monkeypatch, fault)
    res = run_tiny(cell, seconds=0.3)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("workload", STREAMS + PAIRS[:1])
def test_control_is_caught(tmp_path, workload):
    """The control (the reference in int16 in the program's place), judged
    by the run's own check, comes out not correct (each cell's; the tiny
    RNA pairs score under 2^15)."""
    import torch

    res = run_tiny(tiny_cell(tmp_path, workload), control=torch.int16)
    assert not res["correct"], res["check"]
    assert res["check"]["wrong_scores"]["value"] > 0
