"""95th percentile of the pairs' milliseconds in the window, each pair
timed alone on the host clock (linear between the two nearest ranks)."""

import numpy as np


def read(run):
    if not run.request_s:
        return None
    return float(np.percentile(np.asarray(run.request_s) * 1e3, 95))
