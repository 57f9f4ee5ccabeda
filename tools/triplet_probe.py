#!/usr/bin/env python3
"""Where route "shared" of the triplet fill spends its diagonals, on one card.

    python3 tools/triplet_probe.py      # from the root of a checkout

Builds ``bialign_tpu_torch/csrc/triplet.cu`` as it is and in variants made
by text substitution (a library each, one ``nvcc`` each, all at once) and
times each variant's route "shared" (``bialign_triplet_fill_shared``) by
CUDA events, warm, in turns (as_is first and last): at the DNA-Pol-1 pair
(max_shift 1, flat gaps, 960 threads: a row a thread, the tables in
registers) and on a pair of one row (0 x 4000, the same threads: one row's
chain and the barrier, diagonal after diagonal).  The variants:

  as_is     the kernel;
  no_store  without its stores to ys;
  no_table  without the tables' loads after the first four diagonals;
  stamped   the kernel with clock64() stamps per warp before and after
            each diagonal's barrier.  A warp's clock is its own (those of
            two warps may differ), so only a warp's own differences count:
            its work (its release from the barrier to its next arrival)
            and its wait (its arrival to its release).

no_store and no_table compute wrong slabs: they say what the stores and
the tables' advance cost, nothing else.  Prints one JSON line per variant,
then the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bialign_tpu_torch import BiAlignerTriplet, _build  # noqa: E402
from bialign_tpu_torch.data import dnapol_pair  # noqa: E402
from bialign_tpu_torch.models import triplet as trip  # noqa: E402

OUT = ROOT / "build" / "triplet_probe"
PARAMS = dict(type="Protein", shift_cost=-150, structure_weight=800,
              simmatrix="BLOSUM62", gap_cost=-50, max_shift=1)
THREADS, ONE_ROW_M, TURNS, STAMPED_D = 960, 4000, 3, 4096

STORE = ("      here[sk] = v;\n      out[sk] = v;\n",
         "      here[sk] = v;\n")
STORE_INSIDE = ("    here[sk] = v;\n    out[sk] = v;\n",
                "    here[sk] = v;\n")
TABLE = ("        next1 = skewed_quad(mu1, e, P, t);\n"
         "        next2 = skewed_quad(mu2, e + 1 + S, P, t);\n", "")
STAMP_AT = ("      end_diagonal();\n      return ++d <= n + m;",
            "      stamp(g_arrive, d);\n      end_diagonal();\n"
            "      stamp(g_release, d);\n      return ++d <= n + m;")
STAMP_DEFS = ("namespace bialign {\nnamespace {\n",
              f"__device__ long long g_arrive[{STAMPED_D}][32];\n"
              f"__device__ long long g_release[{STAMPED_D}][32];\n"
              "__device__ __forceinline__ void stamp(long long (*at)[32], "
              "int d) {\n"
              f"  if ((threadIdx.x & 31) == 0 && d < {STAMPED_D})\n"
              "    at[d][threadIdx.x >> 5] = clock64();\n}\n"
              'extern "C" int probe_copy(long long* a, long long* r) {\n'
              "  cudaMemcpyFromSymbol(a, g_arrive, sizeof(g_arrive));\n"
              "  return (int)cudaMemcpyFromSymbol(r, g_release, "
              "sizeof(g_release));\n}\n"
              "namespace bialign {\nnamespace {\n")
VARIANTS = {"as_is": [], "no_store": [STORE, STORE_INSIDE],
            "no_table": [TABLE], "stamped": [STAMP_DEFS, STAMP_AT]}


def build_all() -> dict:
    """variant -> its loaded library, after one nvcc each, all at once."""
    jobs = []
    for name, subs in VARIANTS.items():
        src_dir = OUT / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        text = (src_dir / "triplet.cu").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source moved ({old!r})")
            text = text.replace(old, new)
        (src_dir / "triplet.cu").write_text(text)
        lib = src_dir / "libtriplet.so"
        jobs.append((name, lib, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(src_dir), "-o",
             str(lib), str(src_dir / "triplet.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, job in jobs:
        out = job.communicate()[0]
        if job.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].bialign_triplet_fill_shared.argtypes = \
            _build._SIGNATURES["bialign_triplet_fill_shared"]
    return libs


def launcher(lib, mu1, mu2, S, gamma, delta, dev):
    """A call of the variant's route "shared" on fixed tables and slabs."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    t1, t2 = trip.shared_tables(mu1, mu2, S, dev)
    ys = torch.empty((n + m + 1, n + 1, 2 * S + 1), dtype=torch.int32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = lib.bialign_triplet_fill_shared(
            ys.data_ptr(), t1.data_ptr(), t2.data_ptr(), n, m, S,
            trip._int32(2 * gamma), trip._int32(gamma + delta), THREADS,
            dev.index, stream)
        if err:
            raise RuntimeError(f"bialign_triplet_fill_shared: error {err}")
    return call


def ms(call) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def stamps(lib, call, diagonals: int) -> dict:
    """Cycles of the stamped run: a diagonal (warp 0's releases), and over
    the diagonals the mean of the largest and of the median work of a
    warp, and of the median wait at the barrier."""
    call()
    torch.cuda.synchronize()
    arrive = np.zeros((STAMPED_D, 32), np.int64)
    release = np.zeros((STAMPED_D, 32), np.int64)
    lib.probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if lib.probe_copy(arrive.ctypes.data, release.ctypes.data):
        raise RuntimeError("probe_copy failed")
    D, warps = min(diagonals, STAMPED_D), -(-THREADS // 32)
    arrive, release = arrive[:D, :warps], release[:D, :warps]
    inner = slice(10, D - 10)
    work = (arrive[1:] - release[:-1])[inner]
    wait = (release - arrive)[inner]
    return {"cycles_a_diagonal": float(np.diff(release[:, 0])[inner].mean()),
            "slowest_warp_work": float(work.max(1).mean()),
            "median_warp_work": float(np.median(work, 1).mean()),
            "median_wait": float(np.median(wait, 1).mean())}


def main() -> int:
    if not torch.cuda.is_available():
        print("triplet_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all()
    seqA, strA, seqB, strB = dnapol_pair()
    ba = BiAlignerTriplet(seqA, seqB, strA, strB, engine="torch",
                          device="cpu", **PARAMS)
    one = np.zeros((1, ONE_ROW_M + 1), np.int32)
    shapes = {"dnapol": (ba.mu1, ba.mu2), "one_row": (one, one)}
    calls = {(name, shape): launcher(lib, *tables, ba.max_shift, ba.gamma,
                                     ba.delta, dev)
             for name, lib in libs.items()
             for shape, tables in shapes.items()}
    for call in calls.values():
        call()
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    found = {name: {shape: [] for shape in shapes} for name in VARIANTS}
    for _ in range(TURNS):
        for name in order:
            for shape in shapes:
                found[name][shape].append(ms(calls[name, shape]))
    diagonals = {"dnapol": len(seqA) + len(seqB) + 1,
                 "one_row": ONE_ROW_M + 1}
    for name, by_shape in found.items():
        line = {"variant": name}
        for shape, times in by_shape.items():
            line[f"{shape}_ms"] = sorted(times)
            line[f"{shape}_us_per_diagonal"] = (min(times) * 1e3
                                                / diagonals[shape])
        if name == "stamped":
            for shape in shapes:
                line[f"{shape}_cycles"] = stamps(
                    libs[name], calls[name, shape], diagonals[shape])
        print(json.dumps(line), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
