"""The check's control: the plain reference computed in int16, the next
precision below the int32 the configurations state, put in the program's
place by a run of the cell (``run_cell(..., control=torch.int16)``) and
judged by that run's own check.  The check must find it wrong.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

runs the cell once a seed on the card, each with a short window at the
cell's own load, and prints one JSON line a seed: ``correct`` and the
check's numbers, each beside its limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the control runs on the card", file=sys.stderr)
        return 2
    bench = harness._load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(ROOT, bench, args.workload)
    for seed in args.seeds:
        res, _lines = harness.run_cell(
            cell, seed, args.seconds, 0, t0=time.perf_counter(),
            control=torch.int16,
            log=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
