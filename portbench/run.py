"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the check's numbers on standard error and one JSON line, the
result, last on standard output; exits non-zero without a result where
there is no CUDA card, too few of them, or a module of JAX or of the JAX
package got loaded.
"""

import time

T0 = time.perf_counter()    # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program and of its libraries at a fixed place in the
# checkout, so that a second run there finds what the first one built
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[0] = str(ROOT)     # the checkout's packages, not this folder's files

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
