"""The single-pair fills' share of their roofline: the least time the card
needs for the traced pairs' bands (dp_bound, band mode) over the fill
kernels' time in the trace (tile_diag, K1/K2)."""

from portbench import bounds

KERNELS = ("tile_diag",)


def read(run):
    return bounds.share(run, KERNELS, lambda cases, states: sum(
        bounds.dp_bound(n, m, run.max_shift, cases, states, band=True)
        for n, m in run.traced_pairs))
