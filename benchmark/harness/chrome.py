"""Device time from ``torch.profiler`` Chrome traces, clipped to a window.

A trace's events carry ``ts`` and ``dur`` in microseconds from the
trace's ``baseTimeNanoseconds``; their sum is the host's wall clock
(``time.time()``), on which the harness opens and closes its window. The
device's activity is every event of the categories in
:data:`DEVICE_CATEGORIES` (kernels, copies, fills), whatever process of
the card recorded it. Several processes share one card here, so a
window's busy time is the length of the union of all their device
intervals, and a kernel's time is the sum of its intervals (one card runs
one process's kernel at a time).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]  # (start, end), seconds of wall clock


@dataclass
class Event:
    name: str
    cat: str
    start: float
    end: float


def load(path: str) -> List[Event]:
    """The complete ('X') events of one Chrome trace, on the wall clock."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e9
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        start = base + float(e["ts"]) / 1e6
        out.append(Event(str(e.get("name", "")), str(e.get("cat", "")), start,
                         start + float(e.get("dur", 0.0)) / 1e6))
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint intervals covering the same time, sorted."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def gaps(covered: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The uncovered stretches of [lo, hi) between sorted disjoint intervals."""
    out, t = [], lo
    for s, e in covered:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class DeviceWindow:
    """The device's activity in one window, from one or more traces."""

    lo: float
    hi: float
    device: List[Event] = field(default_factory=list)  # clipped to the window
    host: List[Event] = field(default_factory=list)  # clipped to the window

    @classmethod
    def from_events(cls, events: Iterable[Event], lo: float, hi: float) -> "DeviceWindow":
        w = cls(lo, hi)
        for ev in events:
            if ev.end <= lo or ev.start >= hi:
                continue
            clipped = Event(ev.name, ev.cat, max(ev.start, lo), min(ev.end, hi))
            if ev.cat in DEVICE_CATEGORIES:
                w.device.append(clipped)
            elif ev.cat in HOST_CATEGORIES:
                w.host.append(clipped)
        return w

    @property
    def seconds(self) -> float:
        return self.hi - self.lo

    def busy(self) -> List[Interval]:
        return union((e.start, e.end) for e in self.device)

    def busy_s(self) -> float:
        return length(self.busy())

    def kernel_s(self, name_part: str) -> float:
        """Summed time of the kernels whose name contains ``name_part``."""
        return sum(e.end - e.start for e in self.device if e.cat == "kernel" and name_part in e.name)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle stretches, each named by the host activity the
        traces show inside it (the traced host op that overlaps it most) and
        by the device operation that ends it."""
        longest = sorted(gaps(self.busy(), self.lo, self.hi), key=lambda g: g[0] - g[1])[:n]
        by_start = sorted(self.device, key=lambda d: d.start)
        out = []
        for s, e in longest:
            overlap: Dict[str, float] = {}
            for h in self.host:
                o = min(h.end, e) - max(h.start, s)
                if o > 0:
                    overlap[h.name] = overlap.get(h.name, 0.0) + o
            host = max(overlap, key=overlap.get) if overlap else "no traced host op"
            nxt = next((d.name for d in by_start if d.start >= e), "window end")
            out.append([f"host: {host[:80]}; then {nxt[:60]}", e - s])
        return out
