"""The port's streaming driver, batch CLI and warmup against the JAX
package's, on the CPU (``engine="torch"``, ``device="cpu"``): the same
records give the same scores, traces, spools, resumes and merged shards
(tolerance 0: ints and strings compared for equality).  The JAX side runs
as its own tests run it, its tables path on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bialign_tpu.parallel.batch_cli as JC
import bialign_tpu.parallel.driver as JD
import golden as G

import bialign_tpu_torch as T
import bialign_tpu_torch.parallel.batch_cli as TC
import bialign_tpu_torch.parallel.driver as TD
from bialign_tpu_torch.utils.warmup import main as warmup_main
from bialign_tpu_torch.utils.warmup import prewarm

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(engine="torch", device="cpu")

# tests/test_driver.py's parameters and records
PARAMS = dict(
    type="Protein", structure_weight=800, simmatrix="BLOSUM62",
    gap_opening_cost=-150, gap_cost=-50, shift_cost=-150, max_shift=1,
)
PRO = G.TOY_PROTEIN
CLI_ARGS = ["--type", "Protein", "--simmatrix", "BLOSUM62",
            "--structure_weight", "800", "--gap_opening_cost", "-150",
            "--gap_cost", "-50", "--shift_cost", "-150", "--max_shift", "1"]


def _records(mod, k=6):
    base = "RAKLPLKEKKLTATANYHPGIRYIMTG"
    out = []
    for i in range(k):
        a = base[: 10 + i]
        b = base[1: 11 + i]
        out.append(mod.PairRecord(
            id=f"p{i}", seqA=a, seqB=b,
            strA="H" * len(a), strB="H" * len(b),
        ))
    return out


def _rna_records(mod, k=10):
    """tests/test_multihost.py's stream."""
    base = "GCGGGGGAUAUCCCCAUCG"
    out = []
    for i in range(k):
        seqB = base[i % 4:] or base
        out.append(mod.PairRecord(id=f"p{i:02d}", seqA=base, seqB=seqB,
                                  strA="." * len(base), strB="." * len(seqB)))
    return out


@pytest.fixture(scope="module")
def jax_scores():
    """The JAX driver's scores of the six records."""
    return dict(JD.StreamingAligner(PARAMS, chunk_pairs=4, bucket_quantum=8)
                .run(_records(JD)))


@pytest.mark.parametrize("codes", [False, True])
def test_streaming_scores_match_jax(jax_scores, codes):
    drv = TD.StreamingAligner(PARAMS, chunk_pairs=4, bucket_quantum=8,
                              codes=codes, **CPU)
    assert (drv._codes_lut is not None) == codes
    got = dict(drv.run(_records(TD)))
    assert got == jax_scores
    assert drv.stats.pairs == 6
    assert drv.stats.cells > 0
    stats = json.loads(drv.stats.to_json())
    assert stats["pairs"] == 6 and stats["batches"] == 2
    assert 0 < drv.dispatch_seconds <= drv.stats.seconds


def _resume(mod, spool, **kw):
    recs = _records(mod)
    drv = mod.StreamingAligner(PARAMS, spool_path=str(spool), chunk_pairs=3,
                               bucket_quantum=8, **kw)
    first = dict(drv.run(recs[:3]))
    drv2 = mod.StreamingAligner(PARAMS, spool_path=str(spool), chunk_pairs=3,
                                bucket_quantum=8, **kw)
    second = dict(drv2.run(recs))
    return first, second, spool.read_text()


@pytest.mark.parametrize("codes", [False, True])
def test_resume_skips_spooled_as_jax(tmp_path, codes):
    want = _resume(JD, tmp_path / "jax.jsonl")
    got = _resume(TD, tmp_path / "port.jsonl", codes=codes, **CPU)
    assert got == want
    assert set(got[1]) == {f"p{i}" for i in range(3, 6)}


def test_stream_sharding_partitions_as_jax():
    for p in range(3):
        kw = dict(chunk_pairs=4, bucket_quantum=8, process_index=p,
                  process_count=3)
        want = list(JD.StreamingAligner(PARAMS, **kw).run(_records(JD, 7)))
        got = list(TD.StreamingAligner(PARAMS, **kw, **CPU)
                   .run(_records(TD, 7)))
        assert got == want
        assert {pid for pid, _ in got} == {f"p{i}" for i in range(7)
                                           if i % 3 == p}


def _torn_tail(mod, spool):
    spool.write_text('{"id": "a", "score": 1}\n{"id": "b", "sco')
    rs = mod.ResultSpool(str(spool))
    done = (rs.is_done("a"), rs.is_done("b"))
    rs.write("b", 2)
    rs.close()
    return done, spool.read_text()


def test_spool_ignores_torn_tail_as_jax(tmp_path):
    want = _torn_tail(JD, tmp_path / "j.jsonl")
    assert _torn_tail(TD, tmp_path / "t.jsonl") == want
    assert want[0] == (True, False)


def _merge_outcome(mod, paths):
    try:
        return mod.merge_spools([str(p) for p in paths])
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("shards", [
    # conflicting records
    [json.dumps({"id": "x", "score": 1}) + "\n",
     json.dumps({"id": "x", "score": 2}) + "\n"],
    # identical duplicates and a torn tail
    [json.dumps({"id": "x", "score": 1}) + "\n",
     json.dumps({"id": "x", "score": 1}) + "\n"
     + json.dumps({"id": "y", "score": 3}) + "\n" + '{"torn'],
    # mid-file corruption
    [json.dumps({"id": "a", "score": 1}) + "\n" + '{"corrupt mid-file\n'
     + json.dumps({"id": "b", "score": 2}) + "\n"],
    # a newline-terminated corrupt final line
    [json.dumps({"id": "a", "score": 1}) + "\n" + '{"id": "b", "sco\n'],
], ids=["conflict", "duplicate-and-torn", "midfile", "terminated-final"])
def test_merge_spools_as_jax(tmp_path, shards):
    paths = []
    for idx, text in enumerate(shards):
        paths.append(tmp_path / f"s{idx}.jsonl")
        paths[-1].write_text(text)
    got = _merge_outcome(TD, paths)
    assert got == _merge_outcome(JD, paths)
    if len(shards) == 2 and "torn" in shards[1]:
        assert got == {"x": {"id": "x", "score": 1},
                       "y": {"id": "y", "score": 3}}
    else:
        assert got[0] == "ValueError"


def _aligned(mod, spool, **kw):
    recs = [mod.PairRecord(id=f"p{i}", seqA=PRO["seqA"], seqB=PRO["seqB"],
                           strA=PRO["strA"], strB=PRO["strB"])
            for i in range(3)]
    sa = mod.StreamingAligner(PARAMS, spool_path=str(spool),
                              alignments=True, **kw)
    results = [(pid, score, [tuple(c) for c in trace])
               for pid, score, trace in sa.run(recs)]
    return results, spool.read_text()


@pytest.mark.parametrize("codes", [False, True])
def test_alignments_mode_as_jax(tmp_path, codes):
    want = _aligned(JD, tmp_path / "j.jsonl")
    got = _aligned(TD, tmp_path / "t.jsonl", codes=codes, **CPU)
    assert got == want
    assert [s for _, s, _ in got[0]] == [48500] * 3
    spooled = [json.loads(ln) for ln in got[1].splitlines()]
    assert all(r["complete"] for r in spooled)
    assert [tuple(c) for c in TD.trace_from_codes(spooled[0]["trace"])] \
        == got[0][0][2]


def _batch_cli_outputs(main, tmp_path, capsys, tag, extra=()):
    """tests/test_cli.py::test_batch_cli_scores_and_alignments through
    ``main``: the outputs of its four runs."""
    seqs = (PRO["seqA"], PRO["seqB"], PRO["strA"], PRO["strB"])
    tsv = tmp_path / f"{tag}.tsv"
    tsv.write_text("".join(f"p{i}\t" + "\t".join(seqs) + "\n"
                           for i in range(3)))
    outs = []
    for name, more in (("s", []), ("s", []), ("a", ["--alignments"]),
                       ("r", ["--alignments", "--render"])):
        spool = tmp_path / f"{tag}.{name}.jsonl"
        args = [str(tsv), "--spool", str(spool), *CLI_ARGS, *more, *extra]
        assert main(args) == 0
        outs.append(capsys.readouterr().out)
    return outs


def test_batch_cli_scores_and_alignments_as_jax(tmp_path, capsys):
    want = _batch_cli_outputs(JC.main, tmp_path, capsys, "jax")
    got = _batch_cli_outputs(TC.main, tmp_path, capsys, "port",
                             ["--engine", "torch", "--device", "cpu"])
    assert got == want
    scores, resumed, aligned, rendered = got
    assert [json.loads(ln)["score"] for ln in scores.splitlines()] \
        == [48500] * 3
    assert resumed.strip() == ""
    assert all(json.loads(ln)["trace"] for ln in aligned.splitlines())
    assert "p0.A " in rendered and "p0.B ss" in rendered \
        and "p2.A shifts" in rendered


def test_batch_cli_renders_a_repeated_id_with_its_own_pair(tmp_path,
                                                           capsys):
    """Two records with the id "p0" in one chunk: each is rendered with its
    own sequences (the JAX batch CLI renders the first with the second's),
    and every line equals BiAligner's decode of the same pair."""
    other = ("RAKLPLKEKKLTATANYHPG", "KAKLPLKEKKLTRTANYHPG",
             "CHHHHHHHHHHHHHCCCCTC", "HHHHHHHHHHHHCCCCCCTC")
    toy = (PRO["seqA"], PRO["seqB"], PRO["strA"], PRO["strB"])
    stream = [("p0", toy), ("p1", other), ("p0", other)]
    tsv = tmp_path / "dup.tsv"
    tsv.write_text("".join(f"{pid}\t" + "\t".join(rec) + "\n"
                           for pid, rec in stream))
    assert TC.main([str(tsv), *CLI_ARGS, "--alignments", "--render",
                    "--chunk_pairs", "2", "--engine", "torch",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    want = []
    for pid, rec in stream:
        ba = T.BiAligner(*rec, nameA=f"{pid}.A", nameB=f"{pid}.B", **CPU,
                         **PARAMS)
        score = ba.optimize()
        want.append(json.dumps({"id": pid, "score": score,
                                "trace": TD.trace_to_codes(ba.traceback())}))
        want += list(ba.decode_trace())
    assert out == want


def _rank_env(rank, world):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               PYTHONPATH=str(ROOT))
    env.pop("LOCAL_RANK", None)
    return env


def test_two_processes_share_the_stream(tmp_path):
    """tests/test_multihost.py's stream, as two batch CLI processes with
    RANK 0/1 and WORLD_SIZE 2: disjoint shards whose merge equals one
    process's spool and the JAX driver's scores."""
    recs = _rna_records(TD)
    tsv = tmp_path / "rna.tsv"
    tsv.write_text("".join(f"{r.id}\t{r.seqA}\t{r.seqB}\t{r.strA}\t{r.strB}\n"
                           for r in recs))
    spool = tmp_path / "out.jsonl"
    cmd = [sys.executable, "-m", "bialign_tpu_torch.parallel.batch_cli",
           str(tsv), "--spool", str(spool), "--distributed", "--chunk_pairs",
           "3", "--bucket_quantum", "8", "--engine", "torch", "--device",
           "cpu"]
    procs = [subprocess.Popen(cmd, env=_rank_env(rank, 2), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    shards = [str(spool) + f".shard{rank}" for rank in range(2)]
    ids = [{json.loads(ln)["id"] for ln in Path(s).read_text().splitlines()}
           for s in shards]
    assert not ids[0] & ids[1]
    assert ids[0] == {f"p{i:02d}" for i in range(0, 10, 2)}
    merged = TD.merge_spools(shards)

    one = tmp_path / "one.jsonl"
    list(TD.StreamingAligner(dict(type="RNA"), spool_path=str(one),
                             chunk_pairs=10, bucket_quantum=8, **CPU)
         .run(recs))
    assert merged == TD.merge_spools([str(one)])
    want = dict(JD.StreamingAligner(dict(type="RNA"), chunk_pairs=10,
                                    bucket_quantum=8).run(_rna_records(JD)))
    assert {pid: rec["score"] for pid, rec in merged.items()} == want


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1)),
    ({"RANK": "1", "WORLD_SIZE": "2"}, (1, 2)),
    ({"RANK": "0", "WORLD_SIZE": "1"}, (0, 1)),
    ({"RANK": "2", "WORLD_SIZE": "2"}, ValueError),
    ({"RANK": "0"}, ValueError),
])
def test_init_distributed_reads_the_environment(monkeypatch, env, want):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if want is ValueError:
        with pytest.raises(ValueError, match="RANK"):
            TD.init_distributed()
    else:
        assert TD.init_distributed() == want


def test_process_device_keeps_a_cpu_device():
    assert TC.process_device("cpu", 3) == TC.torch.device("cpu")


def test_mesh_is_not_ported():
    """mesh= is ported (tests/test_torch_mesh.py runs a stream over one):
    it takes a bialign_tpu_torch Mesh, and refuses anything else."""
    with pytest.raises(TypeError, match="Mesh"):
        TD.StreamingAligner(PARAMS, mesh=object(), **CPU)
    mesh = T.parallel.Mesh(["cpu"] * 2, ("data",))
    assert TD.StreamingAligner(PARAMS, mesh=mesh, **CPU).mesh is mesh


def test_cuda_engine_refuses_a_cpu_device(tmp_path):
    spool = tmp_path / "never.jsonl"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TD.StreamingAligner(PARAMS, spool_path=str(spool), engine="cuda",
                            device="cpu")
    assert not spool.exists()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prewarm([(5, 5)], params={}, engine="cuda", device="cpu")


def test_the_defaults_are_the_card(monkeypatch, tmp_path):
    """StreamingAligner, the batch CLI and prewarm default to engine="cuda"
    on device "cuda", BiAlignerTriplet to engine="torch" on device "cuda",
    and each refuses to run where there is none."""
    monkeypatch.setattr(TC.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TD.StreamingAligner(PARAMS)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prewarm([(5, 5)], params={})
    tsv = tmp_path / "one.tsv"
    tsv.write_text("p0\tACD\tAC\tHHC\tHC\n")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TC.main([str(tsv), *CLI_ARGS])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        T.BiAlignerTriplet("ACGGCU", "ACGCU", "((..))", "((.))")


@pytest.mark.parametrize("params", [
    dict(gap_opening_cost=-150, gap_cost=-50, shift_cost=-150),
    dict(gap_cost=-200, shift_cost=-250),
])
def test_prewarm_returns_its_timings(params):
    lines = []
    timings = prewarm([(6, 5), (6, 5), (3, 4)], params=params, max_shift=1,
                      traceback=True, streaming=True, streaming_batch=3,
                      log=lines.append, **CPU)
    kind = "affine" if "gap_opening_cost" in params else "nonaffine"
    assert [desc for desc, _ in timings] == [
        f"{kind} score n=6 m=5 ms=1", f"{kind} band n=6 m=5 ms=1",
        "codes batch n=6 m=5 B=3 ms=1", "traceback n=6 m=5 ms=1",
        f"{kind} score n=3 m=4 ms=1", f"{kind} band n=3 m=4 ms=1",
        "codes batch n=3 m=4 B=3 ms=1", "traceback n=3 m=4 ms=1"]
    assert all(dt >= 0 for _, dt in timings)
    assert len(lines) == len(timings)


def test_warmup_main(capsys):
    warmup_main(["--lengths", "4x5", "3", "--max-shift", "0", "1",
                 "--gap_opening_cost", "-150", "--traceback", "--engine",
                 "torch", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("prewarmed ") for ln in out) == 12
    assert out[-1].startswith("prewarm total ")
