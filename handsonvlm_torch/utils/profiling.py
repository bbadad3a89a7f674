"""Profiling: the program's spans and counters, and torch.profiler traces.

Spans. `span(name, rid=None)` is a context manager around a piece of the
program's work. With the tracer off (the default) it costs one check and
returns a shared no-op context: nothing is allocated, timed or synced.
After `enable()` each span closed is kept in memory as a `Span` (name,
start and end on `time.perf_counter_ns()`, the id of the span open on the
same thread when it opened, and `rid`, the request or step it serves; a
span given no `rid` takes its parent's). `record()` keeps a span timed
across threads (a request's wait in a queue). `snapshot()` returns what
was kept; `disable()` stops keeping more. A long-running server keeps
every span while the tracer is on, so turn it on for a window.

Counters. `count(name, n)` adds to `counters()`, always, tracer on or off:
plain integer adds at places that already do host work. With the tracer
on each count is also kept with the id of the span open on its thread, so
a reader can tell which span a count was made in.

Waits. While the tracer is on, every point where the host waits on the
card is counted where the card reports it: `enable()` turns on
`torch.cuda.set_sync_debug_mode("warn")`, under which PyTorch warns at
each synchronising call (a `.cpu()`, a `float()` or `.item()` of a device
tensor, an upload from pageable memory, a `nonzero`), and takes those
warnings off the `warnings` module as `count("syncs")`, filed under the
span open on the thread the call was made from. The autograd engine runs
a card's backward on threads of its own, which open no span: a wait there
(a checkpointed layer's recompute) is counted with no span, as one
outside any span is. Other warnings pass on as before.
`disable()` puts the mode and the `warnings` module back. The program
marks no wait by hand, so a wait that a change adds or takes away shows
without an edit here; without a card there are no waits to count.

The clock. `enable()` stores the offset from `perf_counter_ns()` to the
Unix epoch (`time.time_ns()`), the clock of torch.profiler's events
(kineto's `start_ns()`, and with the export's `baseTimeNanoseconds` its
Chrome trace), so every span maps onto the device trace's timeline.

Spans are not `record_function` ranges: under CUDA activity a
`record_function` range can show up as an event on the device
(`gpu_user_annotation`), and a reader that unions device events would
count it as busy time.

`trace(log_dir)` records the enclosed region with torch.profiler (the
host's operators, and the card's kernels when CUDA is available), turns
the tracer on for it, and writes a Chrome trace,
`<log_dir>/trace_<pid>_<ms>.json`, viewable in Perfetto or
chrome://tracing, in which the program's spans have tracks of their own
beside the kernels; it yields the profiler, whose `key_averages()` give
the table.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch


SYNC_WARNING = "synchronizing CUDA operation"  # in the text PyTorch warns with


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # id of the span open on this thread when this one opened
    rid: object  # request or step identifier (a tuple for a group of requests)
    id: int
    thread: Optional[int]  # threading.get_ident(); None for a span timed across threads


def clock_offset_ns() -> int:
    """`time.time_ns() - time.perf_counter_ns()`, from the closest of a few
    pairs of readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span while it is open."""

    __slots__ = ("tracer", "name", "rid", "id", "parent", "start", "stack")

    def __init__(self, tracer: "Tracer", name: str, rid):
        self.tracer, self.name, self.rid = tracer, name, rid

    def __enter__(self):
        t = self.tracer
        stack = t._stack()
        self.parent = None
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.rid is None:
                self.rid = top.rid
        self.id = next(t._ids)
        self.stack = stack
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        self.tracer.spans.append(Span(self.name, self.start, end, self.parent, self.rid,
                                      self.id, threading.get_ident()))
        return False


class Tracer:
    """The spans and counters of one process (the module's `TRACER`)."""

    def __init__(self):
        self.on = False
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.offset_ns = 0
        self.spans: List[Span] = []
        self.counts: List[tuple] = []  # (name, n, id of the span open on the thread)
        self._ids = itertools.count()
        self._shown = None  # the `warnings.showwarning` replaced while waits are counted
        self._filter = None

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def enable(self) -> None:
        """Drop what was kept and keep spans and counts from now on."""
        self.spans, self.counts, self._ids = [], [], itertools.count()
        self.offset_ns = clock_offset_ns()
        self._count_waits()
        self.on = True

    def disable(self) -> None:
        self.on = False
        self._stop_counting_waits()

    def _count_waits(self) -> None:
        if self._shown is not None:
            return
        self._shown = warnings.showwarning
        warnings.showwarning = self._show
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self._filter = warnings.filters[0]
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")

    def _stop_counting_waits(self) -> None:
        if self._shown is None:
            return
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(0)
        if warnings.showwarning == self._show:
            warnings.showwarning = self._shown
        with contextlib.suppress(ValueError):
            warnings.filters.remove(self._filter)
        self._shown = self._filter = None

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            self.count("syncs")
        else:
            self._shown(message, category, filename, lineno, file, line)

    def record(self, name: str, start_ns: int, end_ns: int, rid=None) -> None:
        if self.on:
            self.spans.append(Span(name, start_ns, end_ns, None, rid, next(self._ids), None))

    def count(self, name: str, n: int = 1) -> None:
        if not n:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        if self.on:
            stack = self._stack()
            self.counts.append((name, n, stack[-1].id if stack else None))

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> dict:
        """The spans closed since `enable()` (in the order they closed), the
        counts made with the tracer on, every counter, and the clock
        offset (a span's start on the profiler's clock is `start_ns +
        offset_ns`)."""
        return {"spans": list(self.spans), "counts": list(self.counts),
                "counters": self.counters(), "offset_ns": self.offset_ns}


TRACER = Tracer()


def span(name: str, rid=None):
    """A span around the enclosed work; a shared no-op while the tracer is off."""
    if not TRACER.on:
        return _NULL
    return _Open(TRACER, name, rid)


record = TRACER.record
count = TRACER.count
counters = TRACER.counters
enable = TRACER.enable
disable = TRACER.disable
snapshot = TRACER.snapshot


def chrome_events(spans: List[Span], offset_ns: int, base_ns: int, pid: int) -> List[dict]:
    """The spans as Chrome trace events (microseconds from `base_ns` on the
    epoch clock): the spans of each thread on a track of their own, the
    spans timed across threads as async events."""
    tracks: Dict[Optional[int], int] = {}
    events = []
    for s in sorted(spans, key=lambda s: s.start_ns):
        ts = (s.start_ns + offset_ns - base_ns) / 1e3
        tid = tracks.setdefault(s.thread, 1_000_000_000 + len(tracks))
        args = {"id": s.id, "parent": s.parent, "rid": repr(s.rid)}
        if s.thread is None:
            common = {"cat": "program", "name": s.name, "pid": pid, "tid": tid, "id": s.id}
            events.append(dict(common, ph="b", ts=ts, args=args))
            events.append(dict(common, ph="e", ts=(s.end_ns + offset_ns - base_ns) / 1e3))
        else:
            events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                           "tid": tid, "ts": ts, "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": args})
    for thread, tid in tracks.items():
        label = "program spans across threads" if thread is None else f"program spans {thread}"
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": label}})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region, with the
    program's spans, into `log_dir` as a Chrome trace (JSON)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = TRACER.on
    if not was_on:
        enable()
    t0 = time.perf_counter_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(chrome_events(
        [s for s in TRACER.spans if s.start_ns >= t0], TRACER.offset_ns,
        int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)
