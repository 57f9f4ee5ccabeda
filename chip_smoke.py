#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bialign_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA card and nvcc; imports no JAX.  Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/*.cu into build/bialign_tpu_torch/;
3. kernels: each CUDA kernel against its plain PyTorch twin on the card,
   on random tables at small to medium shapes (bands and traces exact);
4. goldens: the toy RNA/protein goldens and the DNA-Pol-1 prefix-150 score
   through bialign_tpu_torch.BiAligner, and one CLI run in a subprocess;
5. full size: the DNA-Pol-1 928x933 pair, affine max_shift 1 (SCORE 761500
   and the six md5 row anchors of tests/test_dnapol.py), and at the CLI
   defaults (non-affine, max_shift 2) against the plain twins; end-to-end
   times, kernel times against the plain twins', band bytes, peak memory;
6. launch counts of phases 4-5, each of which must be > 0;
7. profile: where the time of the DNA-Pol-1 runs goes, stage by stage on
   the host clock and from a torch.profiler trace (device busy and idle
   time, per-kernel times); traces and report in build/profile/.

Then one JSON line of per-kernel results, and last the line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
nonzero and that line is not printed.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ast
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bialign_tpu_torch import BiAligner, _build
from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.data import dnapol_pair
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb

ROOT = Path(__file__).resolve().parent
SEED = 0

# (n, m, max_shift) of phase 3
SHAPES = [(1, 1, 1), (5, 7, 1), (8, 8, 2), (12, 3, 1), (7, 9, 0),
          (33, 40, 3), (150, 150, 1), (300, 257, 2), (0, 5, 1), (6, 0, 2)]
AFFINE_PARAMS = (-150, -50, -150)       # beta, gamma, delta
NONAFFINE_PARAMS = (-200, -250)         # gamma, delta

DNAPOL_FULL = dict(type="Protein", shift_cost=-150, structure_weight=800,
                   simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
                   max_shift=1)                     # tests/test_dnapol.py:76-82
DNAPOL_PREFIX = dict(type="Protein", shift_cost=-210, structure_weight=800,
                     simmatrix="BLOSUM62", gap_opening_cost=-200,
                     gap_cost=-50, max_shift=1)     # tests/test_dnapol.py:15-23
DNAPOL_CLI_DEFAULTS = dict(type="Protein")         # non-affine, max_shift 2

KERNELS = {
    # name: (source, the TPU-side program it replaces)
    "fill_affine": ("bialign_tpu_torch/csrc/fill_affine.cu",
                    "bialign_tpu/ops/pallas_dp.py:542"),
    "fill_nonaffine": ("bialign_tpu_torch/csrc/fill_nonaffine.cu",
                       "bialign_tpu/ops/pallas_dp.py:414"),
    "walk_affine": ("bialign_tpu_torch/csrc/walk.cu",
                    "bialign_tpu/ops/device_traceback.py:85"),
    "walk_nonaffine": ("bialign_tpu_torch/csrc/walk.cu",
                       "bialign_tpu/ops/device_traceback.py:304"),
}


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **found) -> None:
    print(f"[{phase}] " + json.dumps(found), flush=True)


def counts() -> dict:
    return {**cuda_dp.LAUNCHES, **dtb.LAUNCHES}


def reset_counts() -> None:
    for table in (cuda_dp.LAUNCHES, dtb.LAUNCHES):
        for key in table:
            table[key] = 0


def load_golden():
    spec = importlib.util.spec_from_file_location(
        "golden", ROOT / "tests" / "golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dnapol_md5() -> dict:
    """FULL_MD5 of tests/test_dnapol.py, read without importing the test."""
    tree = ast.parse((ROOT / "tests" / "test_dnapol.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "FULL_MD5"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise RuntimeError("FULL_MD5 not found in tests/test_dnapol.py")


def rand_tables(rng, n, m, scale=100):
    """Random score tables in the style of tests/test_pallas.py:13-18."""
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * scale
    return mu1, mu2


def cuda_ms(fn, reps: int) -> tuple[float, object]:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events on
    the current stream; returns (ms, last result)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def band_err(a, b) -> int:
    check(a.ys.shape == b.ys.shape, f"band shapes {a.ys.shape} {b.ys.shape}")
    return int((a.ys.long() - b.ys.long()).abs().max())


def trace_err(ta, tb) -> int:
    check(len(ta) == len(tb), f"trace lengths {len(ta)} != {len(tb)}")
    enc = [np.asarray([8 * c[0] + 4 * c[1] + 2 * c[2] + c[3] for c in t],
                      dtype=np.int64) for t in (ta, tb)]
    return int(np.abs(enc[0] - enc[1]).max(initial=0))


def phase_kernels(dev, errs: dict) -> None:
    """Each kernel against its plain twin on random tables."""
    beta, gamma, delta = AFFINE_PARAMS
    g2, d2 = NONAFFINE_PARAMS
    for n, m, S in SHAPES:
        rng = np.random.default_rng(SEED + 1000 * n + 10 * m + S)
        t1, t2 = tables_to_torch(*rand_tables(rng, n, m), dev)

        bk = cuda_dp.fill_affine_device(t1, t2, S, beta, gamma, delta)
        bp = cuda_dp.fill_affine_plain(t1, t2, S, beta, gamma, delta)
        e = band_err(bk, bp)
        check(e == 0, f"fill_affine band ({n}, {m}, {S}): max |err| {e}")
        check(bk.final_score() == bp.final_score(), f"affine score {n, m, S}")
        errs["fill_affine"] = max(errs["fill_affine"], e)
        tk, ck = dtb.affine_traceback(bk, beta, gamma, delta, t1, t2)
        tp, cp = dtb.affine_traceback_plain(bp, beta, gamma, delta, t1, t2)
        e = trace_err(tk, tp)
        check(e == 0 and ck == cp, f"walk_affine trace ({n}, {m}, {S})")
        errs["walk_affine"] = max(errs["walk_affine"], e)

        bk = cuda_dp.fill_nonaffine_device(t1, t2, S, g2, d2)
        bp = cuda_dp.fill_nonaffine_plain(t1, t2, S, g2, d2)
        e = band_err(bk, bp)
        check(e == 0, f"fill_nonaffine band ({n}, {m}, {S}): max |err| {e}")
        check(bk.final_score() == bp.final_score(),
              f"nonaffine score {n, m, S}")
        errs["fill_nonaffine"] = max(errs["fill_nonaffine"], e)
        tk = dtb.nonaffine_traceback(bk, g2, d2, t1, t2)
        tp = dtb.nonaffine_traceback_plain(bp, g2, d2, t1, t2)
        e = trace_err(tk, tp)
        check(e == 0, f"walk_nonaffine trace ({n}, {m}, {S})")
        errs["walk_nonaffine"] = max(errs["walk_nonaffine"], e)
    torch.cuda.synchronize()
    say("3 kernels", shapes=SHAPES, bands_equal=True, traces_equal=True,
        max_abs_err=errs)


def phase_goldens(G) -> None:
    """Goldens through BiAligner on the card, and one CLI subprocess."""
    cases = [
        ("toy_rna_affine", G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS,
         G.TOY_RNA_AFFINE_SCORE, G.TOY_RNA_AFFINE_DEFAULT_OUT),
        ("toy_rna_nonaffine", G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS,
         G.TOY_RNA_NONAFFINE_SCORE, G.TOY_RNA_NONAFFINE_DEFAULT_OUT),
        ("toy_protein_sorted", G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS,
         G.TOY_PROTEIN_SCORE, G.TOY_PROTEIN_SORTED_OUT),
    ]
    found = {}
    for name, mol, params, score, lines in cases:
        ba = BiAligner(**mol, **params)
        got = ba.optimize()
        check(got == score, f"{name} score {got} != {score}")
        check(list(ba.decode_trace()) == lines, f"{name} lines")
        # the verbose replay; non-affine, it reads band cells on the card
        last = list(ba.eval_trace())[-1]
        check(last.split(" --> ")[-1] == str(score), f"{name} eval_trace")
        found[name] = got

    seqA, strA, seqB, strB = dnapol_pair()
    ba = BiAligner(seqA[:150], seqB[:150], strA[:150], strB[:150],
                   **DNAPOL_PREFIX)
    got = ba.optimize()
    check(got == 117180, f"dnapol prefix-150 score {got} != 117180")
    last = list(ba.eval_trace())[-1]
    check(last.split(" --> ")[-1] == "117180", f"eval_trace ends {last!r}")
    found["dnapol_prefix150"] = got

    mol, p = G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS
    argv = [mol["seqA"], mol["seqB"], "--strA", mol["strA"],
            "--strB", mol["strB"],
            "--structure_weight", str(p["structure_weight"]),
            "--gap_opening_cost", str(p["gap_opening_cost"]),
            "--gap_cost", str(p["gap_cost"]),
            "--max_shift", str(p["max_shift"]),
            "--shift_cost", str(p["shift_cost"])]
    proc = subprocess.run(
        [sys.executable, "-m", "bialign_tpu_torch.cli", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    want = (["Input:"]
            + [f"{k}\t {mol[k]}" for k in ("seqA", "seqB", "strA", "strB")]
            + [f"SCORE: {G.TOY_RNA_AFFINE_SCORE}", ""]
            + G.TOY_RNA_AFFINE_DEFAULT_OUT)
    check(proc.returncode == 0,
          f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stdout.splitlines() == want,
          f"CLI stdout {proc.stdout!r}")
    found["cli_toy_rna_affine"] = "stdout equal"
    say("4 goldens", **found)


def run_e2e(mol, params, **kw):
    """One end-to-end run; returns (seconds, score, lines, aligner)."""
    seqA, strA, seqB, strB = mol
    t0 = time.perf_counter()
    ba = BiAligner(seqA, seqB, strA, strB, **params, **kw)
    score = ba.optimize()
    lines = list(ba.decode_trace())
    return time.perf_counter() - t0, score, lines, ba


def phase_full_main(mol, md5) -> dict:
    """The DNA-Pol-1 pair through the main path (counted launches)."""
    torch.cuda.reset_peak_memory_stats()
    cold, score, lines, ba = run_e2e(mol, DNAPOL_FULL)
    peak_affine = torch.cuda.max_memory_allocated()     # one run alone
    affine_band_bytes = ba._band.ys.numel() * 4
    del ba
    check(score == 761500, f"dnapol full score {score} != 761500")
    got = {line[:16].rstrip(): hashlib.md5(line[16:].encode()).hexdigest()
           for line in lines}
    check(got == md5, f"dnapol md5 anchors {got}")
    warm = [run_e2e(mol, DNAPOL_FULL)[0] for _ in range(3)]

    t_k, score_k, _lines, bak = run_e2e(mol, DNAPOL_CLI_DEFAULTS)
    trace_k = bak.traceback()
    t_p, score_p, _lines, bap = run_e2e(mol, DNAPOL_CLI_DEFAULTS,
                                        engine="torch", device="cuda")
    trace_p = bap.traceback()
    check(score_k == score_p, f"nonaffine score {score_k} != {score_p}")
    check(trace_k == trace_p, "nonaffine trace differs from the plain twin")
    return dict(
        affine_score=score, md5_anchors="all 6 equal",
        affine_e2e_cold_s=cold, affine_e2e_warm_s=warm,
        affine_band_bytes=affine_band_bytes,
        affine_max_memory_allocated=peak_affine,
        nonaffine_score=score_k, nonaffine_e2e_cuda_s=t_k,
        nonaffine_e2e_torch_s=t_p,
        nonaffine_band_bytes=bak._band.ys.numel() * 4,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )


def phase_full_timing(mol, errs: dict) -> dict:
    """Kernels against plain twins at the DNA-Pol-1 shapes (not counted)."""
    seqA, strA, seqB, strB = mol
    times = {}
    for name, params in (("affine", DNAPOL_FULL),
                         ("nonaffine", DNAPOL_CLI_DEFAULTS)):
        ba = BiAligner(seqA, seqB, strA, strB, engine="torch",
                       device="cuda", **params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, "cuda")
        S = ba.max_shift
        if name == "affine":
            p = (ba.beta, ba.gamma, ba.delta)
            kern, plain = cuda_dp.fill_affine_device, cuda_dp.fill_affine_plain
        else:
            p = (ba.gamma, ba.delta)
            kern = cuda_dp.fill_nonaffine_device
            plain = cuda_dp.fill_nonaffine_plain
        kern(t1, t2, S, *p)                                   # warm-up
        ms_k, bk = cuda_ms(lambda: kern(t1, t2, S, *p), reps=5)
        ms_p, bp = cuda_ms(lambda: plain(t1, t2, S, *p), reps=1)
        e = band_err(bk, bp)
        check(e == 0, f"fill_{name} DNA-Pol band: max |err| {e}")
        errs[f"fill_{name}"] = max(errs[f"fill_{name}"], e)
        times[f"fill_{name}"] = (ms_k, ms_p)

        if name == "affine":
            walk = lambda: dtb.affine_traceback(bk, *p, t1, t2)[0]  # noqa
            t0 = time.perf_counter()
            tp = dtb.affine_traceback_plain(bp, *p, t1, t2)[0]
        else:
            walk = lambda: dtb.nonaffine_traceback(bk, *p, t1, t2)  # noqa
            t0 = time.perf_counter()
            tp = dtb.nonaffine_traceback_plain(bp, *p, t1, t2)
        ms_wp = (time.perf_counter() - t0) * 1e3
        walk()                                                # warm-up
        ms_w, tk = cuda_ms(walk, reps=5)
        e = trace_err(tk, tp)
        check(e == 0, f"walk_{name} DNA-Pol trace differs")
        errs[f"walk_{name}"] = max(errs[f"walk_{name}"], e)
        times[f"walk_{name}"] = (ms_w, ms_wp)
    return times


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # device activity
PROFILED = (("affine_ms1", DNAPOL_FULL),
            ("nonaffine_ms2_cli_defaults", DNAPOL_CLI_DEFAULTS))


def staged_run(mol, params) -> dict:
    """One end-to-end run timed stage by stage on the host clock, each
    stage closed by a device sync: molecules and tables (host), fill (with
    the tables' copy to the card), score, walk (with its one copy back),
    decode (host)."""
    seqA, strA, seqB, strB = mol
    clock = time.perf_counter
    torch.cuda.synchronize()
    t = [clock()]
    ba = BiAligner(seqA, seqB, strA, strB, **params)
    t.append(clock())
    ba._fill()
    torch.cuda.synchronize()
    t.append(clock())
    score = ba._band.final_score()
    t.append(clock())
    trace = ba.traceback()
    t.append(clock())
    list(ba.decode_trace(trace))
    t.append(clock())
    stages = ("tables_s", "fill_s", "score_s", "walk_s", "decode_s")
    return dict(zip(stages, np.diff(t).tolist()), score=score)


def kernel_name(name: str) -> str:
    """A traced device event's name without its argument list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:80].strip()


def profiled_run(mol, params, trace_path: Path) -> dict:
    """One end-to-end run under torch.profiler.  From the exported trace:
    the device's busy time (the union of its kernel, memcpy and memset
    intervals) and idle share inside the run's window, each kernel's count
    and time, and for the fill kernels (one per diagonal d, in order) the
    gaps between them and their mean time by live rows on the diagonal."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("e2e"):
            _t, _score, _lines, ba = run_e2e(mol, params)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (win,) = [e for e in events
              if e["name"] == "e2e" and e.get("cat") == "user_annotation"]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], kernel_name(e["name"]))
                 for e in events if e.get("cat") in DEVICE_CATS)
    busy, covered = 0.0, w0
    for s, f, _name in dev:
        s, f = max(s, covered), min(f, w1)
        if f > s:
            busy += f - s
            covered = f
    kernels = {}
    for s, f, name in dev:
        k = kernels.setdefault(name, {"count": 0, "total_us": 0.0})
        k["count"] += 1
        k["total_us"] += f - s
    fills = [(s, f) for s, f, name in dev if "fill_" in name]
    n, m = ba._band.n, ba._band.m
    check(len(fills) == n + m + 1, f"{len(fills)} fill kernels traced")
    dur = np.array([f - s for s, f in fills])
    gaps = np.array([b[0] - a[1] for a, b in zip(fills, fills[1:])])
    d = np.arange(n + m + 1)
    rows = np.minimum(n, d) - np.maximum(0, d - m) + 1
    return dict(
        window_us=w1 - w0, device_busy_us=busy,
        device_idle_share=1 - busy / (w1 - w0),
        fill=dict(kernels=len(fills), mean_us=dur.mean(),
                  mean_gap_us=gaps.mean(),
                  busy_share_of_fill_span=dur.sum()
                  / (fills[-1][1] - fills[0][0]),
                  mean_us_rows_le_128=dur[rows <= 128].mean(),
                  mean_us_rows_ge_800=dur[rows >= 800].mean()),
        kernels=kernels,
    )


def phase_profile(mol, out: Path) -> None:
    """Where the time goes in the DNA-Pol-1 runs: three staged runs and one
    profiled run per configuration, after a warm-up run."""
    out.mkdir(parents=True, exist_ok=True)
    report = {}
    for name, params in PROFILED:
        run_e2e(mol, params)
        report[name] = dict(
            staged=[staged_run(mol, params) for _ in range(3)],
            profile=profiled_run(mol, params, out / f"trace_{name}.json"))
    (out / "profile.json").write_text(json.dumps(report, indent=1))
    say("7 profile", out=str(out), **{
        name: dict(staged=r["staged"],
                   **{k: v for k, v in r["profile"].items()
                      if k != "kernels"})
        for name, r in report.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    say("1 device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(dev),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    report = _build.build()
    _build.load()
    resources = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say("2 build", seconds=time.perf_counter() - t0,
        library=str(_build.LIB_PATH), ptxas=resources)

    errs = dict.fromkeys(KERNELS, 0)
    phase_kernels(dev, errs)

    G = load_golden()
    mol = dnapol_pair()
    md5 = dnapol_md5()
    reset_counts()
    phase_goldens(G)
    full = phase_full_main(mol, md5)
    launches = counts()
    say("5 full size", **full)

    times = phase_full_timing(mol, errs)
    say("5 kernel times", nvidia_smi=smi,
        ms_kernel_vs_plain={k: {"kernel_ms": v[0], "plain_ms": v[1]}
                            for k, v in times.items()})

    say("6 launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} not launched by the path")
    phase_profile(mol, ROOT / "build" / "profile")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
