"""The reduction of a `torch.profiler` trace to what the per-layer
metrics read: the device operations (kernels, memsets, copies) by name
with their intervals, the host operations with theirs, and the traced
window, the steps the profiler's schedule kept.

The arithmetic follows the port's ``scripts/torch_step_profile.py``:
every device-side event counts as one launch except the optimizer's
annotation, which spans its kernels and would count them twice. The
busy time is the union of the device intervals inside the window, so
overlapping operations count once."""

from __future__ import annotations

from dataclasses import dataclass

import torch

_STEP = "ProfilerStep"  # the schedule's step annotations ("ProfilerStep#n" or "*")
_ANNOTATIONS = ("Optimizer.", _STEP)


@dataclass
class Trace:
    window: tuple[float, float]                  # seconds, the profiler's clock
    device: list[tuple[str, float, float]]       # (name, start, end) seconds
    host: list[tuple[str, int, float, float]]    # (name, thread, start, end) seconds
    steps: int                                   # profiler steps in the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def collect(prof) -> Trace | None:
    """The trace of ``prof``'s active steps, or None when it recorded no
    step or no device operation."""
    device, host, marks = [], [], []
    for ev in prof.events():
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.name.startswith(_ANNOTATIONS):
                device.append((ev.name, start, end))
        elif ev.name.startswith(_STEP):
            marks.append((start, end))
        else:
            host.append((ev.name, int(getattr(ev, "thread", 0) or 0), start, end))
    if not marks or not device:
        return None
    window = (min(m[0] for m in marks), max(m[1] for m in marks))
    return Trace(window=window, device=device, host=host, steps=len(marks))


def _clipped(trace: Trace) -> list[tuple[float, float]]:
    lo, hi = trace.window
    return sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi)


def busy_intervals(trace: Trace) -> list[tuple[float, float]]:
    """The union of the device intervals inside the window, merged."""
    merged: list[list[float]] = []
    for s, e in _clipped(trace):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def launches_in_window(trace: Trace) -> int:
    lo, hi = trace.window
    return sum(1 for _, s, _e in trace.device if lo <= s < hi)


def device_time(trace: Trace, match) -> float:
    """Seconds of the device operations whose name satisfies ``match``,
    each whole, that start inside the window."""
    lo, hi = trace.window
    return sum(e - s for name, s, e in trace.device if lo <= s < hi and match(name))


def by_name(trace: Trace) -> dict[str, float]:
    lo, hi = trace.window
    out: dict[str, float] = {}
    for name, s, e in trace.device:
        if lo <= s < hi:
            out[name] = out.get(name, 0.0) + (e - s)
    return out


def idle_gaps(trace: Trace) -> dict[str, float]:
    """Seconds of device idleness inside the window, by the host
    operation running at each gap's midpoint: on each thread the
    innermost open operation (host runtime calls such as
    cudaLaunchKernel count as operations), and of the threads the one
    whose operation began last."""
    busy = busy_intervals(trace)
    lo, hi = trace.window
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    threads: dict[int, list[tuple[float, float, str]]] = {}
    for name, thread, s, e in trace.host:
        threads.setdefault(thread, []).append((s, e, name))
    owner: list[tuple[float, str]] = [(-1.0, "(no host operation)")] * len(gaps)
    mids = [(a + b) / 2 for a, b in gaps]
    for events in threads.values():
        events.sort()
        starts = [ev[0] for ev in events]
        stack: list[tuple[float, float, str]] = []
        k = 0
        for g, mid in sorted(enumerate(mids), key=lambda t: t[1]):
            while k < len(events) and starts[k] <= mid:
                while stack and stack[-1][1] < events[k][0]:
                    stack.pop()
                stack.append(events[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and stack[-1][0] > owner[g][0]:
                owner[g] = (stack[-1][0], stack[-1][2])
    out: dict[str, float] = {}
    for (a, b), (_, name) in zip(gaps, owner):
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def top(table: dict[str, float], n: int = 10) -> list[list]:
    return [[name[:200], secs] for name, secs in
            sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def matcher(substrings):
    """A name test: true when any of ``substrings`` is in the name."""
    subs = tuple(substrings)
    return lambda name: any(s in name for s in subs)

