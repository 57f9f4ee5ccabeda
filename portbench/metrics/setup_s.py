"""Seconds from the process's start to the window's: imports, the kernels'
library loaded (built on a checkout's first run), the data made, the
warm-up (host clock)."""


def read(run):
    return run.setup_s
