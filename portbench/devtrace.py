"""The traced window: ``torch.profiler`` over the host and the card, reduced to
what the per-layer metrics and the breakdown read.

The window is the host range ``WINDOW`` that the harness opens around its
calls.  Inside it:

- the card is busy where a kernel, a copy or a memset runs (the union of
  their intervals); ``busy_s`` is that union's length and ``window_s`` the
  range's;
- device operations are summed by name;
- each idle gap of the card is put down to what the main host thread was
  doing at the gap's middle: the innermost host range open then (a span of
  the program or of the harness) and the innermost operation inside it.

Events are read from the profiler's Chrome trace, written to a temporary
file (under ``TMPDIR``) and deleted once read: its categories name each
event's kind in every PyTorch version, where the profiler's own event
objects do not.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGES = ("user_annotation",)
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")


class Event(NamedTuple):
    kind: str  # the trace's category: kernel, gpu_memcpy, cpu_op, user_annotation, ...
    name: str
    start: int  # ns
    end: int  # ns
    tid: int


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: dict  # name -> [count, seconds]
    idle_by_host: dict  # label -> seconds


def events(prof) -> list[Event]:
    """Every complete event of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return chrome_events(path)
    finally:
        os.unlink(path)


def chrome_events(path: str) -> list[Event]:
    """The complete events (``"ph": "X"``) of a Chrome trace file, their
    times in ns."""
    with open(path) as f:
        trace = json.load(f)
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "cat" not in ev:
            continue
        start = int(round(float(ev["ts"]) * 1e3))
        tid = ev.get("tid", 0)
        out.append(Event(ev["cat"], ev.get("name", ""), start,
                         start + int(round(float(ev.get("dur", 0)) * 1e3)),
                         tid if isinstance(tid, int) else hash(tid)))
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the host and, where there is one, the card; yields
    the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _label_points(host: list[Event], points: list[int]) -> list[str]:
    """For each of the sorted ``points``, the innermost host range and the
    innermost host operation open at it (host events of one thread nest)."""
    host = sorted(host, key=lambda ev: (ev.start, -ev.end))
    stacks: dict[bool, list[Event]] = {True: [], False: []}
    labels, i = [], 0
    for t in points:
        while i < len(host) and host[i].start <= t:
            ev = host[i]
            stack = stacks[ev.kind in HOST_RANGES]
            while stack and stack[-1].end <= ev.start:
                stack.pop()
            stack.append(ev)
            i += 1
        for stack in stacks.values():
            while stack and stack[-1].end <= t:
                stack.pop()
        span = stacks[True][-1].name if stacks[True] else "no span"
        op = stacks[False][-1].name if stacks[False] else None
        labels.append(span if op is None else f"{span} > {op}")
    return labels


def summarize(evs: list[Event]) -> Summary:
    """The window's busy time, device operations and idle gaps.  Raises
    ``ValueError`` where the trace holds no window range."""
    window = next((ev for ev in evs if ev.kind in HOST_RANGES and ev.name == WINDOW), None)
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    a, b = window.start, window.end
    dev = [ev for ev in evs if ev.kind in DEVICE_KINDS and ev.end > a and ev.start < b]
    ops: dict[str, list] = {}
    for ev in dev:
        slot = ops.setdefault(ev.name, [0, 0.0])
        slot[0] += 1
        slot[1] += (min(ev.end, b) - max(ev.start, a)) * 1e-9
    busy = _merge([(max(ev.start, a), min(ev.end, b)) for ev in dev])
    gaps, prev = [], a
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < b:
        gaps.append((prev, b))
    host = [ev for ev in evs if ev.tid == window.tid and ev.end > a and ev.start < b
            and (ev.kind in HOST_OPS or (ev.kind in HOST_RANGES and ev is not window))]
    idle: dict[str, float] = {}
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    for (g0, g1), label in zip(gaps, _label_points(host, mids)):
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    return Summary(window_s=(b - a) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                   device_ops=ops, idle_by_host=idle)


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the idle time by what the host was doing, ``top`` of each."""
    ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:200], secs] for name, (_, secs) in ops],
            "idle_gaps": [[label[:200], secs] for label, secs in idle]}
