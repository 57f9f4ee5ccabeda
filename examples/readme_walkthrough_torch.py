"""README walkthrough on the PyTorch/CUDA port: both toy examples through
``bialign_tpu_torch.BiAligner``, the golden outputs asserted; the
counterpart of ``examples/readme_walkthrough.py``, with the same output.

Run: python examples/readme_walkthrough_torch.py [--device cuda|cpu]
(cuda: the CUDA kernels on the card, the default; cpu: their plain PyTorch
twins.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bialign_tpu_torch import BiAligner


def engine_of(device: str) -> dict:
    """The CUDA kernels on a card, the plain twins anywhere else."""
    return dict(engine="cuda" if device.startswith("cuda") else "torch",
                device=device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    kw = engine_of(parser.parse_args(argv).device)

    # -- toy RNA (README.md:81-103): expect SCORE 6800 --------------------
    ba = BiAligner(
        "GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
        "...(((.....))).....", ".(((.....)))....",
        type="RNA", structure_weight=400, gap_opening_cost=-200,
        gap_cost=-50, max_shift=1, shift_cost=-150, **kw,
    )
    score = ba.optimize()
    print("SCORE:", score)
    assert score == 6800
    for line in ba.decode_trace():
        print(line)
    print()

    # -- toy protein (README.md:117-152): expect SCORE 48500 --------------
    ba = BiAligner(
        "RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR",
        "KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAYFR",
        "CHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC",
        "HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEECC",
        type="Protein", shift_cost=-150, structure_weight=800,
        simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
        max_shift=1, outmode="sorted", **kw,
    )
    score = ba.optimize()
    print("SCORE:", score)
    assert score == 48500
    for line in ba.decode_trace():
        print(line)


if __name__ == "__main__":
    main()
