"""DNA-Polymerase-1 pipeline on the PyTorch/CUDA port: CFSSP file input,
the full 928x933 affine alignment with the README CLI flags, timing, and
the plot; the counterpart of ``examples/dnapol_pipeline.py``.

Run: python examples/dnapol_pipeline_torch.py [--device cuda|cpu]
         [--prefix N] [--plot out.svg]
(cuda, the default: the CUDA kernels on the card, a fraction of a second;
cpu: their plain PyTorch twins, minutes for the whole pair.  ``--prefix``
aligns the first N residues of each protein, whose score is not the
golden 761500.  ``--plot`` needs matplotlib.)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.data import example_path
from bialign_tpu_torch.io.cfssp import read_molecule_from_file
from bialign_tpu_torch.utils.profiling import band_cells

PARAMS = dict(type="Protein", shift_cost=-150, structure_weight=800,
              simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
              max_shift=1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prefix", type=int, default=None)
    parser.add_argument("--plot", default=None, metavar="OUT")
    args = parser.parse_args(argv)
    engine = "cuda" if args.device.startswith("cuda") else "torch"

    seqA, strA = read_molecule_from_file(
        example_path("DNAPolymerase1_Escherichia.cfssp"), "Protein")
    seqB, strB = read_molecule_from_file(
        example_path("DNAPolymerase1_Xanthomonas.cfssp"), "Protein")
    if args.prefix is not None:
        seqA, strA = seqA[:args.prefix], strA[:args.prefix]
        seqB, strB = seqB[:args.prefix], strB[:args.prefix]

    t0 = time.perf_counter()
    ba = BiAligner(seqA, seqB, strA, strB, engine=engine,
                   device=args.device, **PARAMS)
    score = ba.optimize()
    dt = time.perf_counter() - t0
    cells = band_cells(len(seqA), len(seqB), PARAMS["max_shift"])
    print(f"SCORE: {score}  (fill {dt:.2f}s, "
          f"{cells / dt / 1e6:.1f}M 4D-cells/s)")
    if args.prefix is None:
        assert score == 761500

    full = ba.decode_trace_full()
    for line in ba.decode_trace():
        print(line[:100])

    if args.plot:
        from bialign_tpu_torch.render.plot import plot_alignment

        plot_alignment(full, 120, outname=args.plot)
        print("wrote", args.plot)


if __name__ == "__main__":
    main()
