"""Share of the traced slice in which no kernel, copy or set ran on the card
(device trace)."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
