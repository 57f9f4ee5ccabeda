"""Batched streaming on the PyTorch/CUDA port: score a corpus of pairs
with bucketing, a resumable spool and per-chunk metrics, over a "data" mesh
of the visible CUDA cards when there is more than one; the counterpart of
``examples/batch_streaming.py`` (the same pairs from the same seed).

Run: python examples/batch_streaming_torch.py [n_pairs]
         [--device cuda|cpu] [--spool PATH]
(cuda, the default: the CUDA kernels; cpu: their plain PyTorch twins.  The
spool resumes: pairs already in it are skipped, so each fresh run gets a
fresh default path.)
"""

import argparse
import os
import random
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bialign_tpu_torch.parallel import Mesh
from bialign_tpu_torch.parallel.driver import PairRecord, StreamingAligner

AA = "ARNDCQEGHILKMFPSTWYV"
SS = "HEC"
PARAMS = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
              gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
              max_shift=1)


def rand_rec(i):
    L = random.randint(30, 90)
    seq = "".join(random.choice(AA) for _ in range(L))
    struc = "".join(random.choice(SS) for _ in range(L))
    L2 = max(10, L + random.randint(-5, 5))
    seq2 = "".join(random.choice(AA) for _ in range(L2))
    struc2 = "".join(random.choice(SS) for _ in range(L2))
    return PairRecord(f"pair{i}", seq, seq2, struc, struc2)


def records(n_pairs: int) -> list:
    """The example's pairs: those of examples/batch_streaming.py."""
    random.seed(0)
    return [rand_rec(i) for i in range(n_pairs)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_pairs", nargs="?", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--spool", default=None)
    args = parser.parse_args(argv)
    spool = args.spool or os.path.join(tempfile.mkdtemp(), "scores.jsonl")

    if args.device.startswith("cuda"):
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        kw = dict(engine="cuda", device=devices[0])
    else:
        devices = [args.device]
        kw = dict(engine="torch", device=args.device)
    mesh = Mesh(devices, ("data",)) if len(devices) > 1 else None
    print(f"{len(devices)} device(s); mesh={'data' if mesh else None}")

    driver = StreamingAligner(PARAMS, mesh=mesh, spool_path=spool,
                              chunk_pairs=32, **kw)
    for _pair_id, _score in driver.run(records(args.n_pairs)):
        pass

    driver.stats.stop()
    print(driver.stats.to_json())
    print(f"results spooled to {spool} (resume-safe)")


if __name__ == "__main__":
    main()
