"""The program's spans and counters (handsonvlm_torch/utils/profiling.py) at
the tiny preset on the CPU, and on the card.

- With the tracer off a tiny engine's `join_many` + `step` and a tiny
  train step keep no span and leave the `warnings` module alone.
- With it on they keep the tree the engine, the scheduler and the train
  step open (each child's parent, one `rid` for each request and each
  step).
- The waits PyTorch reports under sync debug mode are counted under the
  innermost span open on the reporting thread (none on a thread that
  opened none); other warnings pass on, and `disable()` puts the
  `warnings` module back.
- A span around `x @ x`, mapped by the tracer's clock offset, contains
  torch.profiler's `aten::mm` event; `profiling.trace()`'s Chrome trace
  holds the program's spans.
- On the card (`cuda`): the waits the tracer files under an engine's
  `join_many`, `step` and `compact` and a train step's spans (with those
  of the backward's threads, which it files under none) equal those a
  plain capture of `torch.cuda.set_sync_debug_mode("warn")` reports for
  the same calls on a twin, at the tiny preset and at the eval cell's
  decoder widths (hov_bench/configs/hov-mistral-7b.json, two layers,
  chunk 16), and no span name appears among a traced slice's device
  operations. Run there with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_trace.py
"""

import collections
import dataclasses
import json
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch

from handsonvlm_torch.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.models.lora import init_lora
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.serve.scheduler import ContinuousScheduler
from handsonvlm_torch.train.step import make_train_step
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer
from handsonvlm_torch.utils import profiling

CHUNK = 4
STEP_CHILDREN = ["step.mask"] + ["decode.draws", "decode.upload", "decode.dispatch"] * CHUNK + [
    "step.readback", "step.bookkeeping"]
JOIN_CHILDREN = ["join.vision", "join.prefill", "join.splice", "join.first_token"]
TRAIN_CHILDREN = ["train.to_device", "train.forward", "train.backward", "train.optimizer",
                  "train.readout"]


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    yield
    profiling.disable()


def _model(device="cpu"):
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", device)
    return model, cfg


def _request(cfg, seed, n=12, rid=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(1, n))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    images = rng.normal(size=(1, cfg.num_frames, 3, cfg.vision.image_size,
                              cfg.vision.image_size)).astype(np.float32)
    return dict(input_ids=ids, images=images, seed=seed, max_new=3 * CHUNK, rid=rid)


def _batch(cfg, b=2, t=16):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(b, t))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[:, [8, 10, 12, 14]] = HAND_TOKEN_ID
    labels = np.full((b, t), IGNORE_INDEX)
    labels[:, 7:] = ids[:, 7:]
    return {"input_ids": ids, "attn_mask": np.ones((b, t), bool),
            "image": rng.normal(size=(b, cfg.num_frames, 3, cfg.vision.image_size,
                                      cfg.vision.image_size)).astype(np.float32),
            "labels": labels, "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
            "future_valid": np.ones((b, 2), np.float32)}


def _lora_step(model, cfg):
    dev = model.llama.embed_tokens.weight.device
    model.lora = init_lora(torch.Generator(device=dev).manual_seed(3), cfg.llama, r=2,
                           alpha=4.0, device=dev)
    opt = make_optimizer(model, 1e-3, freeze_top_keys=("vision", "llama"))
    return opt, create_train_state(model, opt), make_train_step(cfg, opt, attn_impl="auto")


def _children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def test_tracer_off_keeps_no_span():
    model, cfg = _model()
    profiling.enable()  # drop what earlier tests kept
    profiling.disable()
    before = profiling.counters()
    shown, filters = warnings.showwarning, list(warnings.filters)
    eng = ContinuousEngine(model, cfg, slots=2, max_len=512, chunk=CHUNK)
    eng.join_many([_request(cfg, 1), _request(cfg, 2)])
    eng.step()
    _, state, step = _lora_step(model, cfg)
    step(state, _batch(cfg), 1)
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["counts"] == []
    assert profiling.span("x") is profiling.span("y")  # the shared no-op
    assert profiling.counters() == before
    assert warnings.showwarning is shown and warnings.filters == filters


def test_engine_step_and_join_tree():
    model, cfg = _model()
    eng = ContinuousEngine(model, cfg, slots=2, max_len=512, chunk=CHUNK)
    profiling.enable()
    eng.join_many([_request(cfg, 1, rid=7), _request(cfg, 2, rid=8)])
    first = eng.decode_steps
    eng.step()
    eng.compact()
    profiling.disable()
    spans = profiling.snapshot()["spans"]
    (join,) = [s for s in spans if s.name == "engine.join"]
    assert join.rid == (7, 8) and join.parent is None
    kids = _children(spans, join)
    assert [s.name for s in kids] == JOIN_CHILDREN
    assert all(s.rid == join.rid and join.start_ns <= s.start_ns <= s.end_ns <= join.end_ns
               for s in kids)
    (step,) = [s for s in spans if s.name == "engine.step"]
    assert step.rid == first and step.parent is None
    kids = _children(spans, step)
    assert [s.name for s in kids] == STEP_CHILDREN
    assert all(s.rid == first for s in kids)
    assert [s.name for s in spans if s.name == "engine.compact"] == ["engine.compact"]
    # nothing inside the decoder: every span is one of the table's
    names = {s.name for s in spans}
    assert names == {"engine.join", "engine.step", "engine.compact"} | set(JOIN_CHILDREN) | set(
        STEP_CHILDREN)


def test_train_step_tree():
    model, cfg = _model()
    _, state, step = _lora_step(model, cfg)
    profiling.enable()
    step(state, _batch(cfg), 1)
    step(state, _batch(cfg), 1)
    profiling.disable()
    spans = profiling.snapshot()["spans"]
    steps = sorted((s for s in spans if s.name == "train.step"), key=lambda s: s.start_ns)
    assert [s.rid for s in steps] == [0, 1] and all(s.parent is None for s in steps)
    for s in steps:
        kids = _children(spans, s)
        assert [k.name for k in kids] == TRAIN_CHILDREN
        assert all(k.rid == s.rid and s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns
                   for k in kids)
    assert len(spans) == 2 * (1 + len(TRAIN_CHILDREN))


def test_scheduler_queue_and_admit_carry_the_request():
    model, cfg = _model()
    sched = ContinuousScheduler(model, cfg, slots=2, max_len=512, chunk=CHUNK)
    profiling.enable()
    outs = []

    def client(seed):
        r = _request(cfg, seed)
        outs.append(sched.submit(r["input_ids"], r["images"], seed=seed, max_new=r["max_new"],
                                 timeout=120))

    threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    sched.stop()
    profiling.disable()
    assert len(outs) == 3 and not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    spans = snap["spans"]
    by_id = {s.id: s for s in spans}
    queued = [s for s in spans if s.name == "sched.queue"]
    joins = [s for s in spans if s.name == "engine.join"]
    assert len(queued) == 3 and all(s.thread is None for s in queued)
    assert sorted(r for j in joins for r in j.rid) == sorted(s.rid for s in queued)
    for j in joins:
        assert by_id[j.parent].name == "sched.admit"
        for q in queued:
            if q.rid in j.rid:  # the wait ends where its group's join starts
                assert q.end_ns <= j.start_ns
    assert len(sched.ttfts) == 3
    assert sched.ttfts.maxlen is not None


def _report_wait():
    """What PyTorch's sync debug mode reports at a synchronising call."""
    warnings.warn("called a synchronizing CUDA operation", UserWarning)


def _where(snap):
    """The waits kept, by the name of the span they were filed under."""
    names = {s.id: s.name for s in snap["spans"]}
    return collections.Counter(names.get(sid) for name, n, sid in snap["counts"]
                               if name == "syncs" for _ in range(n))


@pytest.mark.parametrize("case", ["nested", "outside", "thread"])
def test_waits_are_filed_under_the_innermost_span(case):
    profiling.enable()
    if case == "nested":
        with profiling.span("outer"):
            _report_wait()
            with profiling.span("inner"):
                _report_wait()
                _report_wait()
        want = {"outer": 1, "inner": 2}
    elif case == "outside":
        _report_wait()
        want = {None: 1}
    else:
        def work():
            with profiling.span("worker"):
                _report_wait()

        with profiling.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
            _report_wait()
        want = {"worker": 1, "main": 1}
    profiling.disable()
    assert _where(profiling.snapshot()) == want


def test_other_warnings_pass_on_and_disable_puts_the_module_back(monkeypatch):
    seen = []
    monkeypatch.setattr(warnings, "showwarning", lambda m, *a, **k: seen.append(str(m)))
    shown, filters = warnings.showwarning, list(warnings.filters)
    before = profiling.counters().get("syncs", 0)
    profiling.enable()
    with profiling.span("s"):
        _report_wait()
        warnings.warn("something else")
    profiling.disable()
    assert seen == ["something else"]
    assert profiling.counters()["syncs"] == before + 1
    assert warnings.showwarning is shown and warnings.filters == filters
    _report_wait()  # the tracer off: shown as before, not counted
    assert seen[-1].endswith("synchronizing CUDA operation")
    assert profiling.counters()["syncs"] == before + 1


def test_span_maps_onto_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            (x @ x).sum()
    profiling.disable()
    snap = profiling.snapshot()
    (s,) = snap["spans"]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    a, b = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert s.start_ns + snap["offset_ns"] <= a <= b <= s.end_ns + snap["offset_ns"]


def test_trace_writes_the_program_spans(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("outer", rid=5):
            with profiling.span("inner"):
                x = torch.randn(64, 64)
                (x @ x).sum()
    assert not profiling.TRACER.on
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(ours) == {"outer", "inner"} and ours["inner"]["args"]["rid"] == "5"
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mm) == 1
    for e in ours.values():
        assert e["ts"] <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= e["ts"] + e["dur"]


# -- on the card -----------------------------------------------------------------


def _sync_warnings(fn):
    """fn() under sync debug mode "warn", the tracer off: (the waits it
    reported, the innermost line of this repository above each)."""
    where = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if profiling.SYNC_WARNING in str(message):
            repo = [f for f in traceback.extract_stack() if "handsonvlm_torch" in f.filename]
            f = repo[-1] if repo else traceback.extract_stack()[-2]
            where[f"{f.filename.split('/')[-1]}:{f.lineno} {f.line} ({filename}:{lineno})"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(where.values()), where


def _card_model(widths):
    """The tiny preset, or the eval cell's decoder widths
    (hov_bench/configs/hov-mistral-7b.json: 4096 wide, 32 q over 8 kv
    heads of 128, its 100 frames and 356 visual tokens) cut to two decoder
    and three CLIP layers, with seeded weights on the card."""
    if widths == "tiny":
        return _model("cuda")
    from hov_bench.core import cells
    from handsonvlm_torch.infer.builder import build_model

    cfg = cells.model_spec(cells.config_file("hov-mistral-7b")).cfg
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, num_layers=2),
                              vision=dataclasses.replace(cfg.vision, num_layers=3))
    model = build_model(cfg, "cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model, cfg


def _card_request(cfg, seed, widths):
    """As the eval cell sends it: 10 unique frames already on the card and
    the map that tiles them over the clip's frames. At the tiny preset a
    prompt of 300 ids, so a join's bucket spans whole cache blocks."""
    r = _request(cfg, seed, n=300 if widths == "tiny" else 12)
    r["max_new"] = 64
    if widths == "eval":
        g = torch.Generator(device="cuda").manual_seed(seed)
        size = cfg.vision.image_size
        r["images"] = torch.randn((1, 10, 3, size, size), generator=g, device="cuda").to(
            cfg.pdtype)
        r["frame_map"] = np.tile(np.arange(10, dtype=np.int32), cfg.num_frames // 10)
    return r


def _engine_calls(eng, cfg, widths):
    """A join of one, a step, a join of two (the group's mask), a step and
    a compaction of the holes the second join burned into the first row."""
    return [("engine.join", lambda: eng.join_many([_card_request(cfg, 1, widths)])),
            ("engine.step", eng.step),
            ("engine.join", lambda: eng.join_many([_card_request(cfg, 2, widths),
                                                   _card_request(cfg, 3, widths)])),
            ("engine.step", eng.step),
            ("engine.compact", eng.compact)]


def _filed(snap):
    """The waits the tracer filed under each top-level span, in the order
    those spans started, and those it filed under none."""
    by_id = {s.id: s for s in snap["spans"]}

    def top(sid):
        while by_id[sid].parent is not None:
            sid = by_id[sid].parent
        return sid

    n = collections.Counter(top(sid) for name, k, sid in snap["counts"]
                            if name == "syncs" and sid is not None for _ in range(k))
    tops = sorted((s for s in snap["spans"] if s.parent is None and s.thread is not None),
                  key=lambda s: s.start_ns)
    unfiled = sum(k for name, k, sid in snap["counts"] if name == "syncs" and sid is None)
    return [(s.name, n[s.id]) for s in tops], unfiled


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["tiny", "eval"])
def test_sync_counts_equal_the_cards_waits(widths):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hov_bench.core.trace import Slice

    chunk = CHUNK if widths == "tiny" else 16  # the eval cell's chunk
    # the process's first switch into the mode reports one wait of its own,
    # with no work in it
    _sync_warnings(lambda: None)
    models = [_card_model(widths) for _ in range(2)]
    cfg = models[0][1]
    engines = [ContinuousEngine(m, cfg, slots=4, max_len=2048, chunk=chunk)
               for m, _ in models]
    warm = ContinuousEngine(models[0][0], cfg, slots=4, max_len=2048, chunk=chunk)
    for _, call in _engine_calls(warm, cfg, widths):  # kernels built and loaded
        call()
    del warm
    # the twins make the same calls on the same weights: one with the
    # tracer on, one under a plain capture of the card's reports
    profiling.enable()
    for _, call in _engine_calls(engines[0], cfg, widths):
        call()
    profiling.disable()
    traced, unfiled = _filed(profiling.snapshot())
    captured, where = [], []
    for name, call in _engine_calls(engines[1], cfg, widths):
        n, w = _sync_warnings(call)
        captured.append((name, n))
        where.append(sorted(w.items()))
    assert engines[0].compactions == engines[1].compactions == 1
    assert traced == captured and unfiled == 0, \
        f"traced {traced} ({unfiled} under no span), captured {captured}: {where}"
    print(f"{widths}: waits by call {captured}")

    steps, states = [], []
    for m, _ in models:
        opt, state, step = _lora_step(m, cfg)
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in _batch(cfg).items()}
        step(state, batch, 1)  # warm
        steps.append((step, state, batch))
    step, state, batch = steps[0]
    profiling.enable()
    step(state, batch, 2)
    profiling.disable()
    traced, unfiled = _filed(profiling.snapshot())
    step, state, batch = steps[1]
    n, w = _sync_warnings(lambda: step(state, batch, 2))
    # the backward's own threads open no span: their waits (a checkpointed
    # layer's recompute) are counted under none
    assert [name for name, _ in traced] == ["train.step"] and traced[0][1] + unfiled == n, \
        f"traced {traced} ({unfiled} under no span), captured {n}: {sorted(w.items())}"
    print(f"{widths}: waits a train step {n}, {unfiled} of them on the backward's threads")

    sl = Slice()
    sl.prime()
    profiling.enable()
    sl.start()
    engines[0].step()
    step(state, batch, 3)
    sl.stop()
    profiling.disable()
    names = {s.name for s in profiling.snapshot()["spans"]}
    assert {"engine.step", "train.step"} <= names
    assert not names & {n for n, _, _ in sl.summary.device_ops}
