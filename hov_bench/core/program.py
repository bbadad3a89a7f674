"""The program's own spans and counters (handsonvlm_torch/utils/profiling.py)
beside a traced slice: `enable()` before a window turns the tracer on,
`collect(run)` after it reads the spans and maps them onto the slice's
clock.

The tracer keeps `perf_counter_ns()` times and, from the moment it was
turned on, their offset to the Unix epoch, which is the clock of
torch.profiler's events: a span's start on the slice's clock is
`(start_ns + offset_ns) * 1e-9` seconds. The slice's device-idle time is
then split by the innermost program span open at each moment (the spans
of a thread; a span timed across threads, a request's wait in the queue,
is no work of the host's), with the time outside any span as its own
entry, so every idle gap is put down to what the program was doing.

`run.py` does not call `enable()` / `collect()` yet, so no run reads
them; a program without the tracer gives nothing to read: `enable` does
nothing and `run.program` stays None.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from hov_bench.core.readers import on_card
from hov_bench.core.trace import Interval, gaps, merge

OUTSIDE = "outside any span"


def _tracer():
    from handsonvlm_torch.utils import profiling

    return profiling if hasattr(profiling, "snapshot") else None


def enable() -> None:
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def collect(run) -> None:
    """After the window: the tracer's snapshot into `run.program` (the spans
    that start after `run.window_closed`, and the counts made in them, left
    out), the tracer off, and onto the info line the host's waits on the
    card by the innermost span they were made in and, on the card, the
    slice's idle ms split by span."""
    tracer = _tracer()
    if tracer is None:
        return
    snap = tracer.snapshot()
    tracer.disable()
    if getattr(run, "window_closed", None) is not None:
        cut = int(run.window_closed * 1e9)  # perf_counter() and perf_counter_ns() share a clock
        late = {s.id for s in snap["spans"] if s.start_ns > cut}
        snap["spans"] = [s for s in snap["spans"] if s.id not in late]
        snap["counts"] = [c for c in snap["counts"] if c[2] not in late]
    run.program = snap
    names = {sp.id: sp.name for sp in snap["spans"]}
    waits: Dict[str, int] = {}
    for name, n, sid in snap["counts"]:
        if name == "syncs":
            where = names.get(sid, OUTSIDE)
            waits[where] = waits.get(where, 0) + n
    run.info["syncs_by_span"] = waits  # the card's reported waits, by innermost span
    s = run.slice.summary
    if on_card(run) and s is not None:
        run.info["idle_ms_by_span"] = {k: 1e3 * v for k, v in idle_by_span(
            s.device_ops, s.lo, s.hi, snap["spans"], snap["offset_ns"]).items()}


def on_clock(span, offset_ns: int) -> Interval:
    """A span's (start, end) in seconds on the profiler's clock."""
    return (span.start_ns + offset_ns) * 1e-9, (span.end_ns + offset_ns) * 1e-9


def idle_of(device_ops: Sequence[tuple], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] where no device operation ran."""
    return gaps(merge([(a, b) for _, a, b in device_ops], lo, hi), lo, hi)


def idle_by_span(device_ops, lo: float, hi: float, spans, offset_ns: int) -> Dict[str, float]:
    """The slice's idle seconds split by the name of the innermost span
    open at each moment (the latest started of the spans of threads that
    are open; of two that started together, the shorter); the parts sum
    to the slice's idle time."""
    idle = idle_of(device_ops, lo, hi)
    ivs: List[Tuple[float, float, str]] = []
    for s in spans:
        if s.thread is None:
            continue
        a, b = on_clock(s, offset_ns)
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ivs.append((a, b, s.name))
    points = sorted({p for a, b, _ in ivs for p in (a, b)} | {p for g in idle for p in g})
    starts = sorted(range(len(ivs)), key=lambda k: ivs[k][0])
    out: Dict[str, float] = {}
    active: set = set()
    nxt = 0
    g = 0
    for p, q in zip(points, points[1:]):
        active = {k for k in active if ivs[k][1] > p}
        while nxt < len(starts) and ivs[starts[nxt]][0] <= p:
            if ivs[starts[nxt]][1] > p:
                active.add(starts[nxt])
            nxt += 1
        mid = 0.5 * (p + q)
        while g < len(idle) and idle[g][1] <= mid:
            g += 1
        if g == len(idle) or idle[g][0] > mid:
            continue  # the device was busy here
        name = ivs[max(active, key=lambda k: (ivs[k][0], -ivs[k][1]))][2] if active else OUTSIDE
        out[name] = out.get(name, 0.0) + (q - p)
    return out
