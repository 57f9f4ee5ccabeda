"""Mean milliseconds a pair spends in the BiAligner constructor: the host's
molecules and score tables (host span)."""


def read(run):
    s = run.mean_span_s("tables")
    return None if s is None else s * 1e3
