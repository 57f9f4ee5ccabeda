"""Command-line front end of the port.

Parity target: reference ``src/bialign.py`` (argparse flag surface, the
``Input:`` echo block, ``--outmode help``, CFSSP ``--fileinput`` rerouting,
and the SCORE/alignment output stream), flag for flag as
:mod:`bialign_tpu.cli`.  argparse prefix matching is left enabled so
README-style abbreviations (``--filein``, ``--structure``) work exactly as
in the reference.  Two flags are the port's own: ``--engine cuda|torch``
and ``--device``.

    python -m bialign_tpu_torch.cli SEQA SEQB --strA ... --strB ... --device cuda
"""

from __future__ import annotations

import argparse

from .aligner import ENGINES, BiAligner
from .io.cfssp import read_molecule_from_file
from .version import __version__

VERSION_STRING = f"BiAlign {__version__}"


def bialign(seqA, seqB, strA, strB, verbose, **params):
    """Yield the output lines of one alignment run (reference
    bialign.py:10-22)."""
    aligner = BiAligner(seqA, seqB, strA, strB, **params)
    yield f"SCORE: {aligner.optimize()}"
    yield ""
    yield from aligner.decode_trace()
    if verbose:
        yield from aligner.eval_trace()


def add_bialign_parameters(parser):
    """All reference CLI flags (bialign.py:25-96), same names and defaults."""
    parser.add_argument("seqA", help="sequence A")
    parser.add_argument("seqB", help="sequence B")
    parser.add_argument("--strA", default=None, help="structure A")
    parser.add_argument("--strB", default=None, help="structure B")
    parser.add_argument("--nameA", default="A", help="name A")
    parser.add_argument("--nameB", default="B", help="name B")
    parser.add_argument("-v", "--verbose", action="store_true", help="Verbose")
    parser.add_argument(
        "--type", default="RNA", type=str, help="Type of molecule: RNA or Protein"
    )
    parser.add_argument(
        "--nodescription",
        action="store_true",
        help="Don't prefix the strings in output alignment with descriptions",
    )
    parser.add_argument(
        "--outmode",
        default="default",
        help="Output mode [call --outmode help for a list of options]",
    )
    parser.add_argument(
        "--sequence_match_similarity", type=int, default=100,
        help="Similarity of matching nucleotides",
    )
    parser.add_argument(
        "--sequence_mismatch_similarity", type=int, default=0,
        help="Similarity of mismatching nucleotides",
    )
    parser.add_argument(
        "--structure_weight", type=int, default=400,
        help="Weighting factor for structure similarity",
    )
    parser.add_argument(
        "--gap_opening_cost", type=int, default=0,
        help="Similarity of opening a gap (turns on affine gap cost if not 0)",
    )
    parser.add_argument(
        "--gap_cost", type=int, default=-200,
        help="Similarity of a single gap position",
    )
    parser.add_argument(
        "--shift_cost", type=int, default=-250,
        help="Similarity of shifting the two scores against each other",
    )
    parser.add_argument(
        "--max_shift", type=int, default=2,
        help="Maximal number of shifts away from the diagonal in either direction",
    )
    parser.add_argument(
        "--fileinput", action="store_true",
        help="Read sequence and structure input from file",
    )
    parser.add_argument("--version", action="version", version=VERSION_STRING)
    parser.add_argument(
        "--simmatrix", type=str, default=None, help="Similarity matrix"
    )
    # extensions over the reference: engine and device of the DP
    parser.add_argument(
        "--engine", default="cuda", choices=ENGINES,
        help="cuda: the CUDA kernels (default); torch: their plain PyTorch "
        "twins",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the DP (default cuda; engine torch also runs "
        "on cpu)",
    )
    parser.add_argument(
        "--lowmem", action="store_true",
        help="Low-memory band mode: keep two diagonal slabs every "
        "sqrt(2 (n+m+1)) diagonals and recompute the band block by block "
        "during traceback (same score and alignment; for pairs whose band "
        "the device cannot hold)",
    )


def _resolve_file_inputs(ns) -> None:
    """Under --fileinput, seqA/seqB are CFSSP filenames: load each file
    and replace the sequence/structure pair in place."""
    for side in ("A", "B"):
        seq, struc = read_molecule_from_file(
            getattr(ns, f"seq{side}"), ns.type
        )
        setattr(ns, f"seq{side}", seq)
        setattr(ns, f"str{side}", struc)


def _echo_inputs(ns) -> None:
    """The reference CLI's Input: block (sequences always, structures
    only when present)."""
    print("Input:")
    for label in ("seqA", "seqB", "strA", "strB"):
        value = getattr(ns, label)
        if value is not None:
            print(f"{label}\t {value}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Bialignment.")
    add_bialign_parameters(parser)
    ns = parser.parse_args(argv)

    if ns.fileinput:
        _resolve_file_inputs(ns)
    _echo_inputs(ns)

    if ns.outmode == "help":
        print(f"\nAvailable modes: {', '.join(BiAligner.outmodes)}\n")
        raise SystemExit()

    for line in bialign(**vars(ns)):
        print(line)


if __name__ == "__main__":
    main()
