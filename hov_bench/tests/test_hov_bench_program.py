"""core/program.py: the slice's idle split by program span on synthetic
runs, and the tracer around a window of the eval cell at tiny224 widths on
the CPU."""

from __future__ import annotations

import argparse
import time
import types
import warnings

import pytest
import torch

from hov_bench import run as harness
from hov_bench.core import cells, program
from hov_bench.core.trace import Slice, TraceSummary
from hov_bench.tests import tiny
from handsonvlm_torch.utils import profiling
from handsonvlm_torch.utils.profiling import Span

OFF = 1_000_000_000_000  # offset from the tracer's clock to the slice's, ns
MS = 1_000_000


def span(name, a_ms, b_ms, sid, parent=None, rid=None, thread=1):
    """A span at [a_ms, b_ms] of the slice (which starts at OFF on the
    profiler's clock, 0 on the tracer's)."""
    return Span(name, a_ms * MS, b_ms * MS, parent, rid, sid, thread)


def synthetic(device="cuda"):
    """A slice from 0 to 100 ms with the card busy over [10, 20], [40, 70]
    and [85, 95] (idle 50 ms); an engine step over [5, 90] with a forward's
    draws [5, 8], upload [8, 12] and dispatch [12, 45], a second dispatch
    [50, 80] whose upload is a count; a ticket's wait across threads over
    the whole slice; after the slice a second step [110, 150] with a
    dispatch [115, 140]."""
    lo, hi = OFF * 1e-9, OFF * 1e-9 + 0.1
    ops = [("k", lo + 1e-3 * a, lo + 1e-3 * b) for a, b in ((10, 20), (40, 70), (85, 95))]
    summary = TraceSummary(ops, [], hi - lo, sum(b - a for _, a, b in ops), lo, hi)
    spans = [span("engine.step", 5, 90, 0, rid=3),
             span("decode.draws", 5, 8, 1, 0, 3), span("decode.upload", 8, 12, 2, 0, 3),
             span("decode.dispatch", 12, 45, 3, 0, 3), span("decode.dispatch", 50, 80, 4, 0, 3),
             span("sched.queue", 0, 100, 5, None, 9, thread=None),
             span("engine.join", 200, 300, 6, rid=(9,)),
             span("engine.step", 110, 150, 7, rid=4), span("decode.dispatch", 115, 140, 8, 7, 4)]
    counts = [("syncs", 1, 2), ("syncs", 2, 3), ("syncs", 1, 0), ("syncs", 4, None),
              ("syncs", 2, 8), ("other", 32, 0)]
    return types.SimpleNamespace(
        device=torch.device(device), slice=types.SimpleNamespace(summary=summary),
        program={"spans": spans, "counts": counts, "counters": {}, "offset_ns": OFF},
        window_closed=0.4, info={})


def test_idle_split_by_the_innermost_span_sums_to_the_slice_idle():
    run = synthetic()
    s = run.slice.summary
    split = program.idle_by_span(s.device_ops, s.lo, s.hi, run.program["spans"], OFF)
    # idle [0, 10], [20, 40], [70, 85], [95, 100]: [0, 5] and [95, 100]
    # outside; [5, 8] draws; [8, 10] upload; [20, 40] and [70, 80] dispatch;
    # [80, 85] the step itself (the queue's wait is no host work)
    want = {"outside any span": 10e-3, "decode.draws": 3e-3, "decode.upload": 2e-3,
            "decode.dispatch": 30e-3, "engine.step": 5e-3}
    assert split.keys() == want.keys()
    for k in want:
        assert split[k] == pytest.approx(want[k], abs=1e-9), k
    assert sum(split.values()) == pytest.approx(s.window_s - s.busy_s, rel=1e-9)


def test_program_without_a_tracer_gives_nothing(monkeypatch):
    run = synthetic()
    run.program = None
    monkeypatch.setattr(program, "_tracer", lambda: None)
    program.enable()
    program.collect(run)
    assert run.program is None and run.info == {}


def test_collect_off_the_card_splits_no_idle():
    run = synthetic("cpu")
    run.window_closed = None
    profiling.enable()
    with profiling.span("step"):
        pass
    program.collect(run)
    assert [s.name for s in run.program["spans"]] == ["step"]
    assert "idle_ms_by_span" not in run.info


def test_collect_leaves_out_spans_after_the_window_and_turns_the_tracer_off():
    run = synthetic()
    profiling.enable()
    with profiling.span("before"):
        pass
        warnings.warn("called a synchronizing CUDA operation")
    warnings.warn("called a synchronizing CUDA operation")
    run.window_closed = time.perf_counter()
    with profiling.span("after"):
        warnings.warn("called a synchronizing CUDA operation")
    program.collect(run)
    assert not profiling.TRACER.on
    assert [s.name for s in run.program["spans"]] == ["before"]
    assert run.info["syncs_by_span"] == {"before": 1, program.OUTSIDE: 1}
    split = run.info["idle_ms_by_span"]
    s = run.slice.summary
    assert sum(split.values()) == pytest.approx(1e3 * (s.window_s - s.busy_s), rel=1e-9)


@pytest.fixture
def bench(tmp_path, monkeypatch):
    man = tiny.write(tmp_path)
    monkeypatch.setattr(cells, "BENCH", tmp_path)
    return man


def test_traced_run_leaves_the_tracer_off(bench):
    """`run.py` does not turn the program's tracer on: a traced run of the
    eval cell on the CPU keeps no span and reports only the accepted
    metrics."""
    profiling.disable()
    before = profiling.snapshot()["spans"]
    args = argparse.Namespace(workload="eval-mistral7b-s32", seed=2 ** 31 + 11, seconds=4.0,
                              trace=1)
    res = harness.run_cell(args, torch.device("cpu"), manifest_path=bench)
    assert not profiling.TRACER.on and profiling.snapshot()["spans"] == before
    assert "idle_ms_by_span" not in res and res["correct"]


def test_tracer_around_a_window_keeps_the_engines_spans(bench):
    """With `enable()` before the window and `collect()` after it, a
    rehearsal of the eval cell's driver keeps the scheduler's, the join's
    and the decode forwards' spans, and no wait is reported without a
    card."""
    man = cells.manifest(bench)
    wl = cells.workload(man, "eval-mistral7b-s32")
    mix = cells.traffic_file(wl["traffic"])
    run = harness.Run(workload=wl, spec=cells.model_spec(cells.config_file(wl["config"])),
                      mix=mix, seed=2 ** 31 + 13, seconds=3.0, trace=False,
                      device=torch.device("cpu"), slice_s=0.5, slice=Slice())
    driver = cells.driver_module(mix["driver"]).Driver(run)
    driver.setup()
    program.enable()
    driver.window()
    program.collect(run)
    assert not profiling.TRACER.on
    names = {s.name for s in run.program["spans"]}
    assert {"sched.queue", "sched.admit", "engine.join", "join.prefill", "engine.step",
            "decode.draws", "decode.upload", "decode.dispatch"} <= names
    assert run.info["syncs_by_span"] == {}
