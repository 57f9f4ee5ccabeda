"""The bucket kernels' share of their roofline: the least time the card
needs for the traced pairs' scores (batch_bound over their genuine cells)
over the time of the bucket kernels in the trace (conveyor K8, one CTA a
pair K6/K7, a launch a diagonal K4/K5)."""

from portbench import bounds

KERNELS = ("conveyor_tile", "cta_scores", "cta_ms0", "batch_tile")


def read(run):
    return bounds.share(run, KERNELS, lambda cases, states: (
        bounds.batch_bound(run.traced_pairs, run.max_shift, cases, states)))
