"""The window's milliseconds over the pairs it ran, each from the
constructor's call to decode_trace()'s return, one after another (host
clock)."""


def read(run):
    if run.cell.mix.get("entry") != "pair" or not run.answered:
        return None
    return run.window_s * 1e3 / run.answered
