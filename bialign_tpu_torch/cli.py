"""Command-line front end of the port.

The flags of the reference CLI (:func:`bialign_tpu.cli.add_bialign_parameters`)
and its output stream: the ``Input:`` echo, ``SCORE:``, a blank line, the
decoded alignment, and with ``-v`` the per-column replay.  Two flags are
the port's own: ``--engine cuda|torch`` and ``--device``.

    python -m bialign_tpu_torch.cli SEQA SEQB --strA ... --strB ... --device cuda
"""

from __future__ import annotations

import argparse

from bialign_tpu.cli import (
    _echo_inputs,
    _resolve_file_inputs,
    add_bialign_parameters,
)

from .aligner import ENGINES, BiAligner


def bialign(seqA, seqB, strA, strB, verbose, **params):
    """Yield the output lines of one alignment run (reference
    bialign.py:10-22)."""
    aligner = BiAligner(seqA, seqB, strA, strB, **params)
    yield f"SCORE: {aligner.optimize()}"
    yield ""
    yield from aligner.decode_trace()
    if verbose:
        yield from aligner.eval_trace()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Bialignment.",
                                     conflict_handler="resolve")
    add_bialign_parameters(parser)
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
