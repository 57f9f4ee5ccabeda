#!/usr/bin/env python3
"""Where the sequence split's route "resident" spends its diagonals, on one
card.

    python3 tools/seqsplit_probe.py     # from the root of a checkout

Builds ``bialign_tpu_torch/csrc/seqsplit.cu`` as it is and in variants made
by text substitution (a library each, one ``nvcc`` each, all at once) and
times the score-only fill of the DNA-Pol-1 pair (affine max_shift 1) on
route "resident" by CUDA events, warm, in turns (as_is first and last), at
K = 1 and 4 shards on cuda:0, a CTA a tile (8 rows, the default) and two
tiles.  Each call zeroes its flags, as the wrapper does.  The variants:

  as_is         the kernel;
  no_waits      without either wait: every CTA walks its diagonals alone
                (its own chain: stage, compute, store, publish);
  no_below      without the wait for the CTA below (the ring's reuse);
  no_fill       without the tiles' work: the waits and publishes alone,
                a handoff a diagonal;
  relaxed_poll  the waits poll with a relaxed load and acquire once, by a
                fence, when the flag is there;
  no_release    the publish a relaxed store, without the release's fence.

no_waits, no_below and no_fill compute wrong rings, and no_release may:
they say what the waits, the tiles and the fence cost, nothing else.
Prints one JSON line per variant (ms a fill and us a diagonal, each turn),
then the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bialign_tpu_torch import BiAligner, _build  # noqa: E402
from bialign_tpu_torch.data import dnapol_pair  # noqa: E402
from bialign_tpu_torch.ops import cuda_dp  # noqa: E402
from bialign_tpu_torch.parallel import seqsplit as ssp  # noqa: E402

OUT = ROOT / "build" / "seqsplit_probe"
PARAMS = dict(type="Protein", shift_cost=-150, structure_weight=800,
              simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
              max_shift=1)
KS, TILE_ROWS, TURNS, REPS = (1, 4), (8, 16), 3, 5
ENTRY = "bialign_seqsplit_resident_score_affine"

WAIT_ABOVE = ("      if (above)\n"
              "        flag_wait(above, d - 1 - base, sys_above, args.fault, "
              "d, 1);\n", "")
WAIT_BELOW = ("      if (kRing && !tail && below)\n"
              "        flag_wait(below, d - 1 - base, sys_below, args.fault, "
              "d, 2);\n", "")
FILL = ("    for (int i0 = lo; i0 <= hi; i0 += R)\n",
        "    if (d < 0)\n    for (int i0 = lo; i0 <= hi; i0 += R)\n")
FLAGS = "neighbour_flags.cuh"
RELAXED_POLL = (FLAGS,
                "  int32_t v = flag_acquire(flag, sys);\n"
                "  if (v >= want) return v;\n"
                "  const uint64_t t0 = flag_clock_ns();\n"
                "  while ((v = flag_acquire(flag, sys)) < want)\n",
                "  int32_t v;\n"
                "  asm volatile(\"ld.global.relaxed.gpu.b32 %0, [%1];\" : "
                "\"=r\"(v) : \"l\"(flag) : \"memory\");\n"
                "  if (v >= want) { asm volatile(\"fence.acq_rel.gpu;\" ::: "
                "\"memory\"); return v; }\n"
                "  const uint64_t t0 = flag_clock_ns();\n"
                "  for (;;) {\n"
                "    asm volatile(\"ld.global.relaxed.gpu.b32 %0, [%1];\" : "
                "\"=r\"(v) : \"l\"(flag) : \"memory\");\n"
                "    if (v >= want) break;\n"
                "    if (flag_clock_ns() - t0 > kSpinBudgetNs) "
                "flag_fault(fault, d, which);\n"
                "  }\n"
                "  asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");\n"
                "  if (false)\n")
NO_RELEASE = (FLAGS, "st.global.release.gpu.b32", "st.global.relaxed.gpu.b32")
VARIANTS = {"as_is": [], "no_waits": [WAIT_ABOVE, WAIT_BELOW],
            "no_below": [WAIT_BELOW], "no_fill": [FILL],
            "relaxed_poll": [RELAXED_POLL], "no_release": [NO_RELEASE]}


def build_all() -> dict:
    """variant -> its loaded library, after one nvcc each, all at once (a
    variant that does not build is reported and left out)."""
    jobs = []
    for name, subs in VARIANTS.items():
        src_dir = OUT / name
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(_build.CSRC, src_dir)
        for sub in subs:
            path = src_dir / (sub[0] if len(sub) == 3 else "seqsplit.cu")
            old, new = sub[-2:]
            text = path.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source moved ({old!r})")
            path.write_text(text.replace(old, new))
        lib = src_dir / "libseqsplit.so"
        jobs.append((name, lib, subprocess.Popen(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(src_dir), "-o",
             str(lib), str(src_dir / "seqsplit.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, job in jobs:
        out = job.communicate()[0]
        if job.returncode != 0:           # reported, the others still run
            print(json.dumps(dict(variant=name, nvcc_failed=out[-2000:])),
                  flush=True)
            continue
        libs[name] = ctypes.CDLL(str(lib))
        getattr(libs[name], ENTRY).argtypes = _build._SIGNATURES[ENTRY]
    return libs


def launcher(lib, shards, consts, n, m, S, rows):
    """A score-only fill of the variant on fixed rings, its flags zeroed
    each call (the wrapper's memset)."""
    rings = [torch.empty((3, 9, 2 * S + 1, 2 * S + 1, s.rows),
                         dtype=torch.int32, device=s.device) for s in shards]
    streams = [torch.cuda.current_stream(s.device) for s in shards]
    fault = ssp.fault_word()

    def call():
        table = ssp.shard_table(shards, rings, [None] * len(shards),
                                streams=streams,
                                flags=ssp.flag_memory(shards), rows=rows,
                                fault=fault)
        err = getattr(lib, ENTRY)(table.data_ptr(), len(shards),
                                  consts.data_ptr(), n, m, S)
        if err:
            raise RuntimeError(f"{ENTRY}: error {err}")
    return call


def ms(call) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("seqsplit_probe: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build_all()
    seqA, strA, seqB, strB = dnapol_pair()
    ba = BiAligner(seqA, seqB, strA, strB, **PARAMS)
    n, m, S = len(seqA), len(seqB), ba.max_shift
    consts = cuda_dp._tile_consts(True, (ba.beta, ba.gamma, ba.delta), S)
    calls = {}
    for K in KS:
        shards = ssp.make_shards(ba.mu1, ba.mu2, ["cuda:0"] * K)
        for rows in TILE_ROWS:
            for name, lib in libs.items():
                call = launcher(lib, shards, consts, n, m, S, rows)
                call()                                        # warm-up
                calls[name, K, rows] = call
    torch.cuda.synchronize()
    order = list(calls)
    turns = {key: [] for key in order}
    for t in range(TURNS):
        for key in order if t % 2 == 0 else order[::-1]:
            turns[key].append(ms(calls[key]))
    for (name, K, rows), got in turns.items():
        print(json.dumps(dict(variant=name, k=K, rows_a_cta=rows, ms=got,
                              us_a_diagonal=[x * 1e3 / (n + m + 1)
                                             for x in got])), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
