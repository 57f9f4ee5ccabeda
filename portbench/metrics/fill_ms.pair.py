"""Mean milliseconds a pair spends in optimize(): tables to the card, the
band fill, the final score back as a host int (host span)."""


def read(run):
    s = run.mean_span_s("fill")
    return None if s is None else s * 1e3
