"""The port's three examples (``examples/*_torch.py``) on the CPU, each in
a process of its own at toy size, against the JAX package's examples and
API on the same inputs: the README walkthrough's whole output equal to
``examples/readme_walkthrough.py``'s; the DNA-Pol-1 pipeline on a prefix of
the pair (its SCORE and lines equal to ``bialign_tpu.BiAligner``'s, the
plot written); the stream's spool equal to the JAX ``StreamingAligner``'s
over the same pairs.  On the card ``chip_smoke.py`` runs all three."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

from bialign_tpu import BiAligner as JaxBiAligner
from bialign_tpu.data import example_path
from bialign_tpu.io.cfssp import read_molecule_from_file
from bialign_tpu.parallel import driver as jdriver

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(script, *args) -> str:
    proc = subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_readme_walkthrough_prints_what_the_jax_example_prints():
    got = _run("readme_walkthrough_torch.py", "--device", "cpu")
    assert got.startswith("SCORE: 6800\n") and "SCORE: 48500\n" in got
    assert got == _run("readme_walkthrough.py", "xla")


def test_dnapol_pipeline_on_a_prefix_equals_the_jax_aligner(tmp_path):
    prefix = 60
    svg = tmp_path / "dnapol.svg"
    out = _run("dnapol_pipeline_torch.py", "--device", "cpu", "--prefix",
               str(prefix), "--plot", str(svg)).splitlines()
    seqA, strA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
    seqB, strB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
    ba = JaxBiAligner(seqA[:prefix], seqB[:prefix], strA[:prefix],
                      strB[:prefix], engine="xla", type="Protein",
                      shift_cost=-150, structure_weight=800,
                      simmatrix="BLOSUM62", gap_opening_cost=-150,
                      gap_cost=-50, max_shift=1)
    score = ba.optimize()
    assert out[0].startswith(f"SCORE: {score}  (fill ")
    lines = [line[:100] for line in ba.decode_trace()]
    assert out[1:1 + len(lines)] == lines
    assert out[1 + len(lines)] == f"wrote {svg}"
    assert "<svg" in svg.read_text()


def test_batch_streaming_spools_what_the_jax_driver_spools(tmp_path):
    n_pairs = 8
    spool = tmp_path / "torch.jsonl"
    out = _run("batch_streaming_torch.py", str(n_pairs), "--device", "cpu",
               "--spool", str(spool)).splitlines()
    assert out[0] == "1 device(s); mesh=None"
    assert json.loads(out[1])["pairs"] == n_pairs

    spec = importlib.util.spec_from_file_location(
        "batch_streaming_torch", EXAMPLES / "batch_streaming_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    recs = [jdriver.PairRecord(r.id, r.seqA, r.seqB, r.strA, r.strB)
            for r in example.records(n_pairs)]
    want = tmp_path / "jax.jsonl"
    driver = jdriver.StreamingAligner(example.PARAMS, spool_path=str(want),
                                      chunk_pairs=32)
    for _ in driver.run(recs):
        pass

    def spooled(path):
        return sorted((json.loads(line) for line in open(path)),
                      key=lambda r: r["id"])

    got = spooled(spool)
    assert sorted(r["id"] for r in got) == sorted(
        f"pair{i}" for i in range(n_pairs))
    assert got == spooled(want)
