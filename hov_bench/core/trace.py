"""A traced slice of the window, reduced in memory to device intervals.

`Slice` profiles a few seconds in the middle of a `--trace 1` run's
window with `torch.profiler` (CPU and CUDA activities), started and
stopped by the driver at its own call boundaries, so the slice holds
whole calls. No Chrome trace is written: the device operations (kernels,
copies, fills) are kept as (name, start, end) in seconds, the host
operations only to name the longest idle gaps.

Busy time is the union of the device intervals inside the slice, never a
sum of kernel times (overlapping kernels would count twice); the slice's
length is that of the traced range, from the first to the last event.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval], lo: float = float("-inf"),
                 hi: float = float("inf")) -> float:
    """Total length covered by the intervals, clipped to [lo, hi]."""
    merged = merge(intervals, lo, hi)
    return sum(b - a for a, b in merged)


def merge(intervals: Sequence[Interval], lo: float = float("-inf"),
          hi: float = float("inf")) -> List[Interval]:
    """The intervals clipped to [lo, hi], sorted and merged where they
    overlap or touch."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no merged interval covers."""
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


@dataclasses.dataclass
class TraceSummary:
    device_ops: List[Tuple[str, float, float]]  # (name, start s, end s)
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    busy_s: float
    lo: float
    hi: float

    def kernels(self, patterns: Sequence[str]) -> List[Tuple[str, float, float]]:
        """The device operations whose name holds one of `patterns`."""
        return [e for e in self.device_ops if any(p in e[0] for p in patterns)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the longest idle gaps, each named by the innermost host operation
        running at its middle."""
        by: dict = {}
        for name, a, b in self.device_ops:
            by[name] = by.get(name, 0.0) + (b - a)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        merged = merge([(a, b) for _, a, b in self.device_ops], self.lo, self.hi)
        longest = sorted(gaps(merged, self.lo, self.hi), key=lambda g: g[0] - g[1])[:top]
        idle = []
        for a, b in longest:
            mid = 0.5 * (a + b)
            inside = [(e - s, n) for n, s, e in self.host_ops if s <= mid <= e]
            name = min(inside)[1] if inside else "no host operation traced"
            idle.append([name[:120], b - a])
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": idle}


class Slice:
    """Start and stop the profiler from the thread that drives the work.
    `prime()`, called once on the main thread before the window, lets the
    profiler's tracing library register there first."""

    def __init__(self):
        self.prof = None
        self.summary: Optional[TraceSummary] = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def prime(self) -> None:
        self.start()
        self.stop()
        self.summary = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() * 1e-9
            b = a + e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), a, b))
            else:
                host.append((e.name(), a, b))
        self.prof = None
        allev = dev + host
        lo = min(a for _, a, _ in allev) if allev else 0.0
        hi = max(b for _, _, b in allev) if allev else 0.0
        busy = union_length([(a, b) for _, a, b in dev], lo, hi)
        self.summary = TraceSummary(dev, host, hi - lo, busy, lo, hi)
