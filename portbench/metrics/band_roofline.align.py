"""The band-mode bucket fills' and the batch walks' share of their
roofline: the least time the card needs for the traced pairs' bands
(band_bound) and their walks (walk_bound over the traces' columns) over
the time of those kernels in the trace (batch_tile in band mode,
walk_*_batch)."""

from portbench import bounds

KERNELS = ("batch_tile", "walk_affine_batch", "walk_nonaffine_batch")


def read(run):
    return bounds.share(run, KERNELS, lambda cases, states: (
        bounds.band_bound(run.traced_pairs, run.max_shift, cases, states)
        + bounds.walk_bound(run.traced_steps, cases)))
