"""On the card only (the ``card`` marker and fixture; skipped elsewhere):
a short run of each cell through the command the driver runs, and the
control at a cell's own size.  ``python3 -m pytest portbench/tests -m card``
on the card's machine."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_wrong_at_cell_size(card, cell):
    import time

    import torch

    from portbench import harness

    c = harness.load_cell(ROOT, BENCH, cell)
    res = harness.run_cell(c, 2**31 + 3, 3.0, 0, t0=time.perf_counter(),
                           control=torch.int16, log=lambda _s: None)[0]
    assert not res["correct"], res["check"]
    assert res["check"]["wrong_scores"]["value"] > 0
