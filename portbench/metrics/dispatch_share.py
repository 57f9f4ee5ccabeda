"""Share of the window the stream driver spent dispatching chunks on the
host (tables or codes, packing, queueing): the driver's own counter
StreamingAligner.dispatch_seconds over the window."""


def read(run):
    d = run.counters.get("dispatch_seconds")
    if d is None or not run.window_s:
        return None
    return 100.0 * d / run.window_s
