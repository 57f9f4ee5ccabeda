"""Device trace of a slice of a run, reduced in memory.

:func:`capture` runs a callable under ``torch.profiler`` (host and device
activities) inside the annotation ``pb.slice`` and reduces the raw events
at once, without writing a trace file: the device's operations (kernels,
copies, sets; not the profiler's device-side copies of host annotations),
their union (busy seconds), the idle gaps between them, each
labelled with the innermost benchmark annotation (``pb.<name>``) the host
was in at the gap's middle, and the time a kernel name took in all.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

SLICE = "pb.slice"
TOP = 10


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    ops: dict = field(default_factory=dict)      # name -> seconds
    gaps: list = field(default_factory=list)     # the TOP longest idle gaps,
    #                                              [(label, seconds)]
    device_events: int = 0

    def seconds_of(self, patterns):
        """Device seconds of the operations whose name holds one of
        ``patterns``."""
        return sum(s for name, s in self.ops.items()
                   if any(p in name for p in patterns))

    def breakdown(self):
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:200], s] for name, s in ops],
                "idle_gaps": [[label, s] for label, s in self.gaps]}


def capture(fn):
    """(fn's result, :class:`Trace`) of ``fn()`` run under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, reduce(prof.profiler.kineto_results.events())


def _fields(ev):
    """(name, start_ns, end_ns, on the device) of a raw profiler event."""
    start = ev.start_ns()
    return (ev.name(), start, start + ev.duration_ns(),
            ev.device_type() == torch.autograd.DeviceType.CUDA)


def reduce(events):
    """A :class:`Trace` from raw profiler events."""
    lo = hi = None
    spans, device = [], []
    for ev in events:
        name, a, b, on_device = _fields(ev)
        if on_device:
            # the profiler mirrors host annotations on the device's
            # timeline; they are no device work
            if not name.startswith("pb."):
                device.append((a, b, name))
        elif name == SLICE:
            lo, hi = a, b
        elif name.startswith("pb."):
            spans.append((a, b, name))
    out = Trace()
    if lo is None:
        return out
    out.window_s = (hi - lo) * 1e-9
    out.device_events = len(device)
    for a, b, name in device:
        out.ops[name] = out.ops.get(name, 0.0) + (b - a) * 1e-9
    busy, gaps = union([(a, b) for a, b, _n in device], lo, hi)
    out.busy_s = busy * 1e-9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    out.gaps = [(label_at(spans, (a + b) // 2), (b - a) * 1e-9)
                for a, b in longest]
    return out


def union(intervals, lo, hi):
    """(covered length, gaps) of ``intervals`` clipped to [lo, hi]; gaps as
    [(start, end)] between and around them."""
    covered, gaps, at = 0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > at:
            gaps.append((at, a))
        if b > at:
            covered += b - max(a, at)
            at = b
    if hi > at:
        gaps.append((at, hi))
    return covered, gaps


def label_at(spans, t):
    """The innermost (latest started) span holding ``t``, else the slice."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else SLICE
