"""The program's own spans (``bialign_tpu_torch.utils.profiling``) beside
the benchmark's: they are host annotations that change nothing the device
trace reads, and the benchmark's readers read the same numbers from the
same run whether the program has spans or not."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import devtrace, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


class _Ev:
    def __init__(self, name, a, b, dev):
        self.v = (name, a, b, dev)


KERNELS = [_Ev("void bialign::(anonymous namespace)::conveyor_tile<9>", 200,
               300, True),
           _Ev("bialign::(anonymous namespace)::walk_affine_batch", 350, 450,
               True),
           _Ev("Memcpy HtoD (Pinned -> Device)", 600, 700, True)]
BENCHMARK_SPANS = [_Ev("pb.slice", 0, 1000, False),
                   _Ev("pb.slice", 0, 1000, True)]
PROGRAM_SPANS = [_Ev("bialign.stream.dispatch", 50, 650, False),
                 _Ev("bialign.stream.encode", 60, 190, False),
                 _Ev("bialign.batch.launch", 190, 640, False),
                 _Ev("bialign.stream.harvest", 650, 990, False)]


def test_program_spans_change_no_reading_of_the_trace(monkeypatch):
    """The program's spans are host ops: busy time, the operations' times
    and the gaps' labels are those of the trace without them; kernels
    whose names begin with the program's namespace stay device work."""
    monkeypatch.setattr(devtrace, "_fields", lambda ev: ev.v)
    plain = devtrace.reduce(BENCHMARK_SPANS + KERNELS)
    spanned = devtrace.reduce(BENCHMARK_SPANS + PROGRAM_SPANS + KERNELS)
    assert spanned == plain
    assert plain.busy_s == pytest.approx(300e-9)
    assert len(plain.ops) == 3 and plain.device_events == 3


def _fixed_run(workload):
    cell = harness.load_cell(ROOT, BENCH, workload)
    run = harness.Run(cell=cell, setup_s=9.5, window_s=51.25, answered=1400,
                      memory_peak_bytes=9 * 2**30 + 12345)
    run.spans = {"tables": [0.016] * 1400, "fill": [0.0125] * 1400,
                 "walk": [0.0015] * 1400, "decode": [0.001] * 1400}
    run.request_s = [0.030 + k * 1e-5 for k in range(1400)]
    run.counters = {"dispatch_seconds": 46.5, "records_seconds": 0.4}
    run.traced_pairs = [(300, 302), (928, 933)] * 8
    run.traced_steps = 9000
    run.trace = devtrace.Trace(
        window_s=2.0, busy_s=1.5, device_events=9000,
        ops={"conveyor_tile": 1.2, "batch_tile": 0.2, "cta_scores": 0.05,
             "tile_diag": 0.1, "walk_affine_batch": 0.05})
    return run


# each reader's value on a fixed run, at the time the program's spans came:
# what a later change to a reader or its sources has to answer for
FIXED = {
    "readme-dnapol1.scores": {
        "pairs_per_s": 27.317073170731707, "setup_s": 9.5,
        "dispatch_share.scores": 90.73170731707317,
        "bucket_roofline.scores": 0.07685595076944998,
        "device_idle.scores": 25.0},
    "readme-dnapol1.pair": {
        "pair_ms": 36.607142857142854, "setup_s": 9.5,
        "pair_ms_p95.host": 43.2905, "tables_ms.pair": 16.0,
        "fill_ms.pair": 12.5, "fill_roofline.pair": 1.4971525635820897,
        "walk_decode_ms.pair": 2.5, "device_idle.pair": 25.0},
    "readme-dnapol1.align": {
        "alignments_per_s": 27.317073170731707, "setup_s": 9.5,
        "dispatch_share.align": 90.73170731707317,
        "band_roofline.align": 0.4458461861046009,
        "device_idle.align": 25.0,
        "peak_gib.align": 9.000011497177184},
}


@pytest.mark.parametrize("workload", sorted(FIXED))
def test_existing_readers_on_a_fixed_run(workload):
    run = _fixed_run(workload)
    cell = run.cell
    got = {m["name"]: harness.reader(ROOT, m["name"])(run)
           for m in cell.end_to_end + cell.per_layer}
    assert got == pytest.approx(FIXED[workload], rel=1e-12)


@pytest.mark.card
def test_program_spans_have_no_device_copy(card):
    """On the card, a traced stream's raw events hold the program's spans
    on the host only: the profiler gives them no copy on the device's
    timeline, which devtrace would count as device work."""
    code = r"""
import sys
sys.path.insert(0, ".")
import torch
from portbench import devtrace
from bialign_tpu_torch.parallel.driver import PairRecord, StreamingAligner
params = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
              gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
              max_shift=1)
base = "RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR"
recs = [PairRecord(f"p{i}", base[:20 + i], base[1:21 + i], "H" * (20 + i),
                   "C" * (20 + i)) for i in range(8)]
sa = StreamingAligner(params, chunk_pairs=4, alignments=True)
list(sa.run(recs))
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    list(sa.run(recs))
    torch.cuda.synchronize()
host = dev = 0
for ev in prof.profiler.kineto_results.events():
    name, _a, _b, on_device = devtrace._fields(ev)
    if name.startswith("bialign."):
        dev += on_device
        host += not on_device
print(host, dev)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    host, dev = map(int, out.stdout.split()[-2:])
    assert host > 0 and dev == 0
