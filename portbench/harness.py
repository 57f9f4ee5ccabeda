"""One run of one cell of the benchmark: set-up, the measured window, an
optional traced slice, the check against the plain reference, the result.

A cell names a configuration (``configs/<name>.json``: the program's
parameters, the data, the deployment it stands for) and a traffic mix
(``traffic/<name>.json``: the entry it drives, the records it feeds, the
check's sample, the traced slice); each metric is a reader
(``metrics/<name>.py``, ``read(run)`` -> a number or None).  All are found
by the names in ``BENCHMARK.json``.

The mix names the entry it drives (``entries/<entry>.py``, its class
``Entry``: ``warm``, ``window``, ``slice``, ``close``, ``sample``,
``answer_with``, ``check``) and the kind of its records
(``records/<kind>.py``); both are found by name, as the metric readers are.
A reader ``metrics/<name>.<group>.py`` that is not there falls back to
``metrics/<name>.py``.

The program's answers in the window (a seeded sample of them, the longest
among them, and every copy of the configuration's whole pair) are compared
with the reference's once the window and the slice are over, the card's
peak memory read and the program's state freed; every number compared must
be 0.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import devtrace, generator

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bialign_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list          # metric entries of BENCHMARK.json
    per_layer: list
    chips: int = 1


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    answered: int = 0
    spans: dict = field(default_factory=dict)      # name -> [seconds]
    request_s: list = field(default_factory=list)  # a pair's seconds each
    counters: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: devtrace.Trace | None = None
    traced_pairs: list = field(default_factory=list)   # [(n, m)]
    traced_steps: int = 0

    @property
    def affine(self):
        return int(self.cell.config["params"]["gap_opening_cost"]) != 0

    @property
    def max_shift(self):
        return int(self.cell.config["params"]["max_shift"])

    def mean_span_s(self, *names):
        if not self.answered:
            return None
        return sum(sum(self.spans.get(n, ())) for n in names) / self.answered


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root, bench, workload):
    """The cell ``workload`` of the benchmark ``bench`` (BENCHMARK.json's
    contents), its files read from under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(Path(root) / configs[w["config"]]["file"])
    mix = _load_json(Path(root) / "portbench" / "traffic"
                     / f"{w['traffic']}.json")
    return Cell(name=workload, config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                chips=int(w["chips"]))


def reader(root, name):
    """The ``read`` function of the metric ``name``: its own file, else that
    of the name before its group suffix (``device_idle.pair`` ->
    ``device_idle``)."""
    folder = Path(root) / "portbench" / "metrics"
    if not (folder / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return generator.load_file(root, "metrics", name).read


def entry_class(root, name):
    """The class ``Entry`` of the entry ``name``."""
    return generator.load_file(root, "entries", name).Entry


@contextmanager
def span(run, name):
    """A host span: seconds added to ``run.spans[name]``, and the profiler
    annotation ``pb.<name>`` (seen only while a slice is traced)."""
    with torch.profiler.record_function(f"pb.{name}"):
        t = time.perf_counter()
        try:
            yield
        finally:
            run.spans.setdefault(name, []).append(time.perf_counter() - t)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Keep:
    """Seeded choice of the answers kept whole for the check: the first 64,
    then one in ``every``."""

    def __init__(self, seed, every):
        self.rng = generator.rng_of(seed, 4)
        self.every = every
        self.bits = np.zeros(0, dtype=bool)

    def __call__(self, k):
        if k <= 64:
            return True
        while k >= len(self.bits):
            self.bits = np.concatenate(
                [self.bits, self.rng.random(4096) < 1 / self.every])
        return bool(self.bits[k])


BATCH = 32          # pairs a reference fill takes at once


# -- one run -------------------------------------------------------------


def run_cell(cell, seed, seconds, trace, *, t0, root=ROOT, engine="cuda",
             device="cuda", log=print, control=None):
    """Run the cell once; returns (result dict, check lines).  ``log``
    takes the lines written to standard error.  With ``control`` (a torch
    integer type), the answers the check compares are the plain
    reference's computed in that type, put in the program's place once the
    window is over: the check's control, judged by the same check."""
    marks = [("imports", time.perf_counter())]
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.init()
        marks.append(("cuda init", time.perf_counter()))
    entry = entry_class(root, cell.mix["entry"])(cell, seed, root, engine,
                                                 device)
    marks.append(("entry", time.perf_counter()))
    if is_cuda:
        from bialign_tpu_torch import _build

        _build.load()
        marks.append(("library", time.perf_counter()))
    entry.warm()
    sync(device)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{k} {b - a:.3f} s" for (k, b), a in
        zip(marks, [t0] + [m[1] for m in marks[:-1]])))
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell=cell)
    t_start = time.perf_counter()
    run.setup_s = t_start - t0
    entry.window(run, seconds)
    sync(device)
    if trace:
        _out, run.trace = devtrace.capture(
            lambda: entry.slice(run, float(cell.mix["trace_seconds"])))
    sync(device)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if is_cuda else 0)
    entry.close()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    log(stages(run))
    tc = time.perf_counter()
    params = dict(cell.config["params"])
    if control is not None:
        entry.answer_with(params, device, control)
    nums, compared = entry.check(params, device)
    limits = {k: 0 for k in nums}
    correct = compared > 0 and all(nums[k] <= limits[k] for k in nums)
    log(f"check took {time.perf_counter() - tc:.3f} s over {compared} "
        f"answers (the reference's decode {getattr(entry, 'decode_s', 0):.3f}"
        f" s of it)")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if is_cuda:
        dev["power_limit"] = power_limit()
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    # a request that raises ends the run without a result: none fails
    result = {"correct": bool(correct), "attempted": run.answered,
              "failed": 0, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    check = {k: {"value": nums[k], "limit": limits[k]} for k in nums}
    check["compared"] = {"value": compared, "limit": 1}
    result["check"] = check
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in check.items()]
    return result, lines


def stages(run):
    """One line of where the window's time went on the host: each span's
    mean milliseconds a request and each counter's share of the window."""
    parts = [f"{k} {1e3 * sum(v) / run.answered:.3f} ms"
             for k, v in run.spans.items() if run.answered]
    parts += [f"{k} {100 * v / run.window_s:.3f}%"
              for k, v in run.counters.items() if run.window_s]
    return (f"window {run.window_s:.3f} s, {run.answered} answers; "
            + ", ".join(parts))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules():
    """Top-level names of loaded modules the port must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def main(argv, t0):
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def err(text):
        print(text, file=sys.stderr, flush=True)

    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        err(f"no {bench_path}")
        return 2
    cell = load_cell(ROOT, _load_json(bench_path), args.workload)
    if not torch.cuda.is_available():
        err("no CUDA device: this benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        err(f"{cell.name} needs {cell.chips} cards, found "
            f"{torch.cuda.device_count()}")
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, args.trace,
                             t0=t0, log=err)
    found = forbidden_modules()
    if found:
        err(f"modules the port must not load are loaded: {found}")
        return 3
    for line in lines:
        err(line)
    print(json.dumps(result), flush=True)
    return 0
