#!/usr/bin/env python3
"""Where routes "shared" and "cluster" of the triplet fill spend their
diagonals, on one card.

    python3 tools/triplet_probe.py      # from the root of a checkout

Builds ``bialign_tpu_torch/csrc/triplet.cu`` as it is and in variants made
by text substitution (a library each, one ``nvcc`` each, all at once) and
times each variant by CUDA events, warm, in turns (as_is first and last),
on three pairs: the DNA-Pol-1 pair (max_shift 1, flat gaps; route "shared"
on 960 threads, a row a thread, and route "cluster" on 2, 4 and 8 CTAs),
a pair of one row (0 x 4000: one row's chain and the barrier, diagonal
after diagonal; "shared" and a "cluster" of 2, whose second CTA has no
row) and the 1500 x 1490 pair at max_shift 8 (chip_smoke.py TRIPLET_BIG:
the DNA-Pol-1 sequences continued by their starts; "cluster" on 2, 4, 8
and 16 CTAs, 16 where the card makes it resident).  Route "cluster" takes
the threads of models.triplet.cluster_shape.  The variants:

  as_is          the kernel;
  no_store       without its stores to ys;
  no_table       without the tables' loads after the first four diagonals
                 (a row a thread);
  no_halo        without the stores of a CTA's last row to the next CTA's
                 halo (route "cluster");
  barriers_only  without the rows' work and the stores: the same diagonals,
                 each ended by its barrier (the CTA's or the cluster's);
  four_steps     a group's four diagonals as four inlined steps (a row a
                 thread), not one call site in a loop;
  no_fence       without the fence of the halo's thread (route "cluster");
  release        the cluster barrier's arrive with release semantics in
                 every thread (csrc/cluster_barrier.cuh), not relaxed after
                 the CTA's barrier and a fence in the halo's thread;
  stamped        the kernel with clock64() stamps per warp before and after
                 each diagonal's barrier.  A warp's clock is its SM's (those
                 of two warps may differ), so only a warp's own differences
                 count: its work (its release from the barrier to its next
                 arrival) and its wait (its arrival to its release).

no_store, no_table, no_halo and barriers_only compute wrong slabs, and
no_fence may: they say what the stores, the tables' advance, the halo,
the rest of the rows' work and the fence cost, nothing else.  Prints one JSON line per variant, then
the card's name and power limit.  Needs a CUDA card and nvcc.
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
THREADS, ONE_ROW_M, TURNS, STAMPED_D, WARPS = 960, 4000, 3, 4096, 64
BIG = (1500, 1490, 8)                  # chip_smoke.py TRIPLET_BIG
# (route, CTAs) timed on each pair
CONFIGS = {"dnapol": [("shared", None), ("cluster", 2), ("cluster", 4),
                      ("cluster", 8)],
           "one_row": [("shared", None), ("cluster", 2)],
           "big": [("cluster", 2), ("cluster", 4), ("cluster", 8),
                   ("cluster", 16)]}

STORE = ("      if (k >= 0 && k <= m) to[x] = from[x];\n", "")
STORE_ROW = ("    if (live && out != nullptr) out[sk] = v;\n", "")
STORE_INSIDE = ("    if (out != nullptr) out[sk] = v;\n", "")
HALO_ROW = ("    if (live && halo != nullptr) halo[sk] = v;\n", "")
HALO_INSIDE = ("    if (halo != nullptr) halo[sk] = v;\n", "")
TABLE = ("        next1 = skewed_quad(mu1, e, P, i);\n"
         "        next2 = skewed_quad(mu2, e + 1 + S, P, i);\n", "")
FOUR_STEPS = ("      if constexpr (kW <= kInlinedStepsW) {",
              "      if constexpr (true) {")
NO_ROWS = ("    const int at = (i - first + kHalo) * W;\n",
           "    if (d >= 0) return;\n"
           "    const int at = (i - first + kHalo) * W;\n")
RELEASE = ("cluster_barrier.cuh", "barrier.cluster.arrive.relaxed;",
           "barrier.cluster.arrive.release;")
NO_FENCE = ("    if (halo) cluster_fence();\n", "")
STAMP_AT = ("      end_diagonal(d);\n      return ++d <= d_last;",
            "      stamp(g_arrive, d);\n      end_diagonal(d);\n"
            "      stamp(g_release, d);\n      return ++d <= d_last;")
STAMP_DEFS = ("namespace bialign {\nnamespace {\n",
              f"__device__ long long g_arrive[{STAMPED_D}][{WARPS}];\n"
              f"__device__ long long g_release[{STAMPED_D}][{WARPS}];\n"
              f"__device__ __forceinline__ void stamp(long long (*at)[{WARPS}],"
              " int d) {\n"
              "  const int w = blockIdx.x * (blockDim.x >> 5) + "
              "(threadIdx.x >> 5);\n"
              f"  if ((threadIdx.x & 31) == 0 && d < {STAMPED_D} && "
              f"w < {WARPS})\n"
              "    at[d][w] = clock64();\n}\n"
              'extern "C" int probe_copy(long long* a, long long* r) {\n'
              "  cudaMemcpyFromSymbol(a, g_arrive, sizeof(g_arrive));\n"
              "  return (int)cudaMemcpyFromSymbol(r, g_release, "
              "sizeof(g_release));\n}\n"
              "namespace bialign {\nnamespace {\n")
# substitutions in triplet.cu, or (file, old, new) in another source
VARIANTS = {"as_is": [], "no_store": [STORE, STORE_ROW, STORE_INSIDE],
            "no_table": [TABLE], "no_halo": [HALO_ROW, HALO_INSIDE],
            "barriers_only": [NO_ROWS, STORE], "release": [RELEASE],
            "four_steps": [FOUR_STEPS], "no_fence": [NO_FENCE],
            "stamped": [STAMP_DEFS, STAMP_AT]}
ENTRY = {"shared": "bialign_triplet_fill_shared",
         "cluster": "bialign_triplet_fill_cluster"}


def build_all() -> dict:
    """variant -> its loaded library, after one nvcc each, all at once."""
    jobs = []
    for name, subs in VARIANTS.items():
        src_dir = OUT / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        for sub in subs:
            path = src_dir / (sub[0] if len(sub) == 3 else "triplet.cu")
            old, new = sub[-2:]
            text = path.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source moved ({old!r})")
            path.write_text(text.replace(old, new))
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
        for entry in ENTRY.values():
            getattr(libs[name], entry).argtypes = _build._SIGNATURES[entry]
    return libs


def launcher(lib, route, cluster, mu1, mu2, S, gamma, delta, dev):
    """A call of the variant's route on fixed tables and slabs; None where
    the card cannot make the cluster resident (its launch is refused)."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    t1, t2 = trip.shared_tables(mu1, mu2, S, dev)
    ys = torch.empty((n + m + 1, n + 1, 2 * S + 1), dtype=torch.int32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    threads, more = THREADS, ()
    if route == "cluster":
        _, threads, _ = trip.cluster_shape(n, S, cluster)
        more = (cluster,)

    def call():
        err = getattr(lib, ENTRY[route])(
            ys.data_ptr(), t1.data_ptr(), t2.data_ptr(), n, m, S,
            trip._int32(2 * gamma), trip._int32(gamma + delta), threads,
            *more, dev.index, stream)
        if err:
            raise RuntimeError(f"{ENTRY[route]}: error {err}")
    try:
        call()
    except RuntimeError:
        if route == "cluster" and cluster > trip.CLUSTER_PORTABLE:
            return None
        raise
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


def stamps(lib, call, diagonals: int, warps: int) -> dict:
    """Cycles of the stamped run: a diagonal (warp 0's releases), and over
    the diagonals the mean of the largest and of the median work of a
    warp, and of the median wait at the barrier."""
    call()
    torch.cuda.synchronize()
    arrive = np.zeros((STAMPED_D, WARPS), np.int64)
    release = np.zeros((STAMPED_D, WARPS), np.int64)
    lib.probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if lib.probe_copy(arrive.ctypes.data, release.ctypes.data):
        raise RuntimeError("probe_copy failed")
    D = min(diagonals, STAMPED_D)
    arrive, release = arrive[:D, :warps], release[:D, :warps]
    inner = slice(10, D - 10)
    work = (arrive[1:] - release[:-1])[inner]
    wait = (release - arrive)[inner]
    return {"cycles_a_diagonal": float(np.diff(release[:, 0])[inner].mean()),
            "slowest_warp_work": float(work.max(1).mean()),
            "median_warp_work": float(np.median(work, 1).mean()),
            "median_wait": float(np.median(wait, 1).mean()),
            "work_by_warp": [round(float(w)) for w in work.mean(0)],
            "slowest_warp_counts": np.bincount(
                work.argmax(1), minlength=warps).tolist()}


def staged(n: int, S: int, route: str, cluster) -> bool:
    """Whether the route stages the tables (no_table and the stamps change
    only the other form, a row a thread with the tables in registers)."""
    if route == "shared":
        return S > trip.STATIC_SHIFTS or n + 1 > THREADS
    _, threads, _ = trip.cluster_shape(n, S, cluster)
    return S > trip.STATIC_SHIFTS or trip.cluster_rows(n, cluster) > threads


def big_pair(seqs) -> tuple:
    """(seqA, strA, seqB, strB) of BIG's lengths: each DNA-Pol-1 sequence
    and structure continued by its own start."""
    n, m, _ = BIG

    def grow(text, k):
        return (text * (k // len(text) + 1))[:k]

    seqA, strA, seqB, strB = seqs
    return grow(seqA, n), grow(strA, n), grow(seqB, m), grow(strB, m)


def main() -> int:
    if not torch.cuda.is_available():
        print("triplet_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all()
    pairs = {}
    for shape, (seqA, strA, seqB, strB), S in [
            ("dnapol", dnapol_pair(), 1),
            ("big", big_pair(dnapol_pair()), BIG[2])]:
        ba = BiAlignerTriplet(seqA, seqB, strA, strB, engine="torch",
                              device="cpu", **dict(PARAMS, max_shift=S))
        pairs[shape] = (ba.mu1, ba.mu2, S, ba.gamma, ba.delta)
    one = np.zeros((1, ONE_ROW_M + 1), np.int32)
    pairs["one_row"] = (one, one, *pairs["dnapol"][2:])
    calls, refused = {}, []
    for name, lib in libs.items():
        for shape, configs in CONFIGS.items():
            for route, cluster in configs:
                n, S = pairs[shape][0].shape[0] - 1, pairs[shape][2]
                if name in ("no_table", "stamped") and staged(
                        n, S, route, cluster):
                    continue
                call = launcher(lib, route, cluster, *pairs[shape], dev)
                key = (name, shape, route, cluster)
                if call is None:
                    refused.append(key)
                else:
                    calls[key] = call
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    found = {}
    for _ in range(TURNS):
        for name in order:
            for key, call in calls.items():
                if key[0] == name:
                    found.setdefault(key, []).append(ms(call))
    diagonals = {shape: sum(pairs[shape][0].shape) - 1 for shape in pairs}
    for name in VARIANTS:
        line = {"variant": name}
        for (v, shape, route, cluster), times in found.items():
            if v != name:
                continue
            at = f"{shape}_{route}{cluster or ''}"
            line[f"{at}_ms"] = sorted(times)
            line[f"{at}_us_per_diagonal"] = (min(times) * 1e3
                                             / diagonals[shape])
            if name == "stamped":
                n = pairs[shape][0].shape[0] - 1
                threads = (THREADS if route == "shared" else
                           trip.cluster_shape(n, pairs[shape][2], cluster)[1])
                warps = min(WARPS, (cluster or 1) * -(-threads // 32))
                line[f"{at}_cycles"] = stamps(
                    libs[name], calls[name, shape, route, cluster],
                    diagonals[shape], warps)
        print(json.dumps(line), flush=True)
    print(json.dumps({"refused_not_resident": [list(k) for k in refused]}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
