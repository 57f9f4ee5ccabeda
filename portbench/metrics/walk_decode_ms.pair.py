"""Mean milliseconds a pair spends in traceback() and decode_trace(): the
walk on the card, its trace back, the host's decode (host spans)."""


def read(run):
    s = run.mean_span_s("walk", "decode")
    return None if s is None else s * 1e3
