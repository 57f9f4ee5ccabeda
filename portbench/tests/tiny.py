"""Cells shrunk to what the CPU runs in seconds through the program's plain
PyTorch twins (engine "torch"): the toy protein pair as the base pair,
windows of 6-14 residues, RNA pairs of 30-40 nt.  A cell that
BENCHMARK.json does not name (the RNA pair's mix, kept for a later cell) is
built from its configuration's and its mix's files."""

import copy
import gzip
import json
from pathlib import Path

from portbench import harness
from portbench.tests import cases

ROOT = Path(__file__).resolve().parents[2]


def write_cfssp(path, seq, st):
    with gzip.open(path, "wt") as fh:
        fh.write(f"Query 1 {seq} {len(seq)}\nStruc 1 {st} {len(st)}\n")


def file_cell(bench, workload, like):
    """A cell ``<config>.<traffic>`` from its files alone (a mix kept for a
    later cell, not in BENCHMARK.json), with the metrics of the cell
    ``like``."""
    config, traffic = workload.split(".")
    like = harness.load_cell(ROOT, bench, like)
    return harness.Cell(
        name=workload,
        config=json.loads((ROOT / f"portbench/configs/{config}.json")
                          .read_text()),
        mix=json.loads((ROOT / f"portbench/traffic/{traffic}.json")
                       .read_text()),
        end_to_end=like.end_to_end, per_layer=like.per_layer)


def tiny_cell(tmp_path, workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload in {w["name"] for w in bench["workloads"]}:
        cell = harness.load_cell(ROOT, bench, workload)
    else:
        cell = file_cell(bench, workload, "readme-dnapol1.pair")
    cell = copy.deepcopy(cell)
    seqA, seqB, strA, strB = cases.TOY_PROTEIN
    a, b = tmp_path / "a.cfssp.gz", tmp_path / "b.cfssp.gz"
    write_cfssp(a, seqA, strA)
    write_cfssp(b, seqB, strB)
    if "data" in cell.config and "pair" in cell.config["data"]:
        cell.config["data"]["pair"] = [str(a), str(b)]
    rec = cell.mix["records"]
    if cell.mix["entry"] == "stream":
        rec.update(length=[6, 14], full_every=16)
        cell.mix.update(chunk_pairs=8, trace_seconds=0.2)
        cell.mix["check"]["sample"] = 6
    elif rec["kind"] == "homolog":
        rec["trim"] = [0, 3]
    else:
        rec["length"] = [30, 40]
    return cell


def run_tiny(cell, seed=12345, trace=0, seconds=0.5, control=None):
    import time

    return harness.run_cell(cell, seed, seconds, trace,
                            t0=time.perf_counter(), engine="torch",
                            device="cpu", log=lambda _s: None,
                            control=control)[0]
