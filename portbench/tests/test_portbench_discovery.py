"""A configuration, a traffic mix, a kind of records, an entry and a metric
added as files alone, with their entries in BENCHMARK.json, are found by
name: no file of the harness changes."""

import json
import shutil
import time
from pathlib import Path

from portbench import harness
from portbench.tests.tiny import run_tiny, tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}

    base = tiny_cell(tmp_path, "readme-dnapol1.pair")
    config = dict(base.config, name="toy-protein")
    (root / "portbench/configs/toy-protein.json").write_text(
        json.dumps(config))
    mix = dict(base.mix, why="a mix added as a data file",
               entry="toy_pair")
    mix["records"] = dict(mix["records"], trim=[1, 2], kind="toy_homolog")
    (root / "portbench/records/toy_homolog.py").write_text(
        '"""Homologs, each id marked."""\n\n'
        'from portbench import generator\n\n\n'
        'def records(spec, config, seed, root):\n'
        '    base = generator.load_file(root, "records", "homolog")\n'
        '    for rec in base.records(spec, config, seed, root):\n'
        '        yield ("toy-" + rec[0],) + rec[1:]\n')
    (root / "portbench/entries/toy_pair.py").write_text(
        '"""The pair entry, counting its windows."""\n\n'
        'from portbench import generator\n\n'
        'Pair = generator.load_file(__file__.rsplit("/", 3)[0], "entries",\n'
        '                           "pair").Entry\n\n\n'
        'class Entry(Pair):\n'
        '    def window(self, run, seconds):\n'
        '        super().window(run, seconds)\n'
        '        assert next(self.records)[0].startswith("toy-h-")\n'
        '        run.counters["toy_windows"] = 1\n')
    (root / "portbench/traffic/toy-homologs.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/answered_count.toy.py").write_text(
        '"""Pairs the window ran, through the entry added."""\n\n\n'
        'def read(run):\n'
        '    assert run.counters["toy_windows"] == 1\n'
        '    return float(run.answered)\n')
    bench["configs"].append({
        "name": "toy-protein", "source": "upstream README.md:117-152",
        "file": "portbench/configs/toy-protein.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "toy-protein.toy-homologs", "config": "toy-protein",
        "traffic": "toy-homologs", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "answered_count.toy", "unit": "pairs", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["toy-protein.toy-homologs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(root, bench, "toy-protein.toy-homologs")
    assert cell.config["name"] == "toy-protein"
    assert cell.mix["why"] == "a mix added as a data file"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "answered_count.toy"}
    res = harness.run_cell(cell, 99, 0.3, 0, t0=time.perf_counter(),
                           root=root,
                           engine="torch", device="cpu",
                           log=lambda _s: None)[0]
    assert res["correct"], res["check"]
    assert res["metrics"]["answered_count.toy"]["value"] == res["attempted"]
    assert res["metrics"]["answered_count.toy"]["value"] > 0
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
