"""Scores the stream yielded in the window over the window's seconds (host
clock)."""


def read(run):
    if run.cell.mix.get("entry") != "stream" or run.cell.mix.get("alignments"):
        return None
    return run.answered / run.window_s if run.window_s else None
