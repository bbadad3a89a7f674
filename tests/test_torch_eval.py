"""The port's EK100 evaluator at the tiny preset.

- `traj_metrics` equals the JAX package's on the same arrays, exactly.
- The evaluator's serial loop and its `batched` mode (the continuous-
  batching scheduler) run, give the same first token per clip in greedy
  decode, form full-width group joins and reuse one scheduler per
  (model, shape, settings).
- Fed the same predictions, the serial and batched modes give the same
  ADE/FDE/WDE (1e-6), and the port's scoring equals the JAX evaluator's.
- The scheduler cache key holds the model's identity and the decode
  settings, and a scheduler whose loop thread died is rebuilt.
"""

import numpy as np
import pytest
import torch

from handsonvlm_tpu.eval import evaluator as jeval
from handsonvlm_tpu.eval import traj_metrics as jmetrics
from handsonvlm_torch.eval import evaluator as teval
from handsonvlm_torch.eval import traj_metrics as tmetrics
from handsonvlm_torch.eval.evaluator import InferenceEngine, evaluate_epic_kitchen_traj
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.infer.sampler import SampleOutput
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.serve.scheduler import ContinuousScheduler


@pytest.fixture(scope="module")
def tiny():
    return load_pretrained_model("random:tiny", "tiny", "cpu")


class StubDataset:
    """Deterministic conversation-dataset stand-in with tiny-preset shapes."""

    def __init__(self, cfg, n=3):
        rng = np.random.default_rng(0)
        size = cfg.vision.image_size
        self.samples = [{
            "prompt": f"Where should my hand move to if I want to open the fridge {i}?",
            "image": rng.normal(size=(cfg.num_frames, 3, size, size)).astype(np.float32),
            "future_hands": rng.uniform(size=(2, 5, 2)).astype(np.float32),
            "future_valid": np.ones(2, np.float32),
        } for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _engine(tiny, **kw):
    model, cfg, tok = tiny
    return InferenceEngine(model=model, cfg=cfg, tokenizer=tok, **kw)


# -- metrics ----------------------------------------------------------------------


@pytest.mark.parametrize("num_samples", [1, 3])
def test_traj_metrics_match_jax(num_samples):
    rng = np.random.default_rng(num_samples)
    preds = rng.uniform(-0.1, 1.1, size=(7, num_samples, 2, 4, 2))
    gts = rng.uniform(-0.1, 1.1, size=(7, 2, 4, 2))
    valids = (rng.random((7, 2)) < 0.8).astype(np.float32)
    valids[0] = 1
    assert (tmetrics.evaluate_traj_stochastic(preds, gts, valids)
            == jmetrics.evaluate_traj_stochastic(preds, gts, valids))
    assert (tmetrics.evaluate_traj(preds[:, 0], gts, valids)
            == jmetrics.evaluate_traj(preds[:, 0], gts, valids))
    for name in ("displacement_per_step", "final_displacement", "weighted_displacement"):
        got, _ = getattr(tmetrics, name)(preds[:, 0], gts, valids, reduction=False)
        want, _ = getattr(jmetrics, name)(preds[:, 0], gts, valids, reduction=False)
        np.testing.assert_array_equal(got, want)


def test_dedup_frames_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 3, 3, 4, 4)).astype(np.float32)
    tiled = frames[:, [0, 1, 2, 0, 1, 2, 0, 1, 2, 0]]
    tiled[1, 4] = tiled[1, 3]  # row 1: fewer unique frames
    for imgs in (tiled[:1], tiled, frames):
        got, gmap = InferenceEngine.dedup_frames(imgs)
        want, wmap = jeval.InferenceEngine.dedup_frames(imgs)
        np.testing.assert_array_equal(got, want)
        assert (gmap is None) == (wmap is None)
        if gmap is not None:
            np.testing.assert_array_equal(gmap, wmap)


# -- the evaluator on the tiny model ----------------------------------------------


def test_evaluate_loop_runs(tiny):
    engine = _engine(tiny, max_new_tokens=16)
    result = evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 3), log_every=0)
    assert set(result) == {"ade", "fde", "wde", "n", "val_info"}
    assert len(result["val_info"]) == 3
    for v in result["val_info"].values():
        assert v["future_hands"].shape == (1, 2, 5, 2)
        assert 1 <= v["num_tokens"] <= 16 and len(v["gen_ids"]) == v["num_tokens"]


def test_engine_prompt_bucketing(tiny):
    engine = _engine(tiny, max_new_tokens=4)
    a = engine.build_prompt_ids("short?")
    b = engine.build_prompt_ids("a slightly longer question about the video?")
    assert a.shape[1] != b.shape[1]
    ids, attn = engine._pad_to_bucket([a[0], b[0]])
    assert ids.shape[1] % engine.pad_prompt_multiple == 0
    assert attn.sum(1).tolist() == [a.shape[1], b.shape[1]]
    assert attn[:, -1].all()  # left padding: the last position is real


def test_spec_k_scores_b1_requests(tiny):
    """spec_k > 0: every B = 1 request goes through the speculative sampler
    with the engine's template bank (tokenized once), greedy clips give the
    tokens of the sequential engine, and a batch of two stays sequential."""
    data = StubDataset(tiny[1])
    seq = evaluate_epic_kitchen_traj(_engine(tiny, max_new_tokens=6, temperature=0.0), data,
                                     log_every=0)
    engine = _engine(tiny, max_new_tokens=6, temperature=0.0, spec_k=2)
    res = evaluate_epic_kitchen_traj(engine, data, log_every=0)
    assert len(res["val_info"]) == len(data)
    for i in range(len(data)):
        np.testing.assert_array_equal(res["val_info"][i]["gen_ids"],
                                      seq["val_info"][i]["gen_ids"])
    bank = engine._spec_bank
    assert bank.ndim == 1 and bank.size > 20 and engine.spec_stats["iters"] >= 1
    gen = torch.Generator().manual_seed(0)
    images = np.stack([data[0]["image"], data[1]["image"]])
    del engine.spec_stats
    pred, valid, ids = engine.infer_batch([data[0]["prompt"], data[1]["prompt"]], images, gen)
    assert pred.shape == (2, 2, 4, 2) and len(ids) == 2
    assert not hasattr(engine, "spec_stats") and engine._spec_bank is bank


def test_spec_k_sampled_eval_runs(tiny):
    """The sampled protocol (temperature 0.5, top-p 0.9) with spec_k and the
    int8 cache scores every clip."""
    data = StubDataset(tiny[1])
    engine = _engine(tiny, max_new_tokens=6, spec_k=3, kv_quant="int8")
    res = evaluate_epic_kitchen_traj(engine, data, seed=1, log_every=0)
    assert len(res["val_info"]) == len(data)
    assert all(1 <= v["num_tokens"] <= 6 for v in res["val_info"].values())
    assert sum(engine.spec_stats["accept_hist"]) == engine.spec_stats["iters"]


@pytest.mark.parametrize("num_samples", [1, 2])
def test_batched_eval_matches_slots1_greedy(tiny, num_samples):
    """The first token comes from the join's own prefill and never reads
    the shared cache, so it is the same whatever the batch; later tokens
    read the shared cache at other offsets (rounding only), so at most rare
    near-tie divergences are allowed."""
    engine = _engine(tiny, max_new_tokens=6, temperature=0.0)
    kwargs = dict(seed=3, log_every=0, num_samples=num_samples, batched_max_len=1024,
                  batched_chunk=4)
    solo = evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 4), batched=1, **kwargs)
    shared = evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 4), batched=3, **kwargs)
    assert solo["n"] == shared["n"]
    assert len(shared["val_info"]) == 4
    flips = 0
    for i in solo["val_info"]:
        ta, tb = solo["val_info"][i]["gen_ids"], shared["val_info"][i]["gen_ids"]
        assert len(ta) == len(tb)
        assert ta[0] == tb[0], (i, ta, tb)
        flips += not np.array_equal(ta, tb)
    assert flips <= 2


def test_batched_eval_sampled_runs(tiny):
    engine = _engine(tiny, max_new_tokens=6, temperature=0.7)
    result = evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 3), batched=2, seed=1,
                                        log_every=0, batched_max_len=1024, batched_chunk=4)
    assert set(result) == {"ade", "fde", "wde", "n", "val_info"}
    assert len(result["val_info"]) == 3


def test_batched_eval_joins_at_full_width(tiny, monkeypatch):
    """Request preparation runs off the submit path and an idle engine
    holds admission briefly, so an 8-clip burst on 4 slots forms two
    full-width group joins."""
    widths = []
    orig = ContinuousEngine.join_many

    def logged(self, reqs):
        widths.append(len(reqs))
        return orig(self, reqs)

    monkeypatch.setattr(ContinuousEngine, "join_many", logged)
    engine = _engine(tiny, max_new_tokens=6, temperature=0.0)
    evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 8), batched=4, seed=1,
                               log_every=0, batched_max_len=1024, batched_chunk=4)
    assert widths == [4, 4], widths


def test_batched_scheduler_reused_across_calls(tiny):
    engine = _engine(tiny, max_new_tokens=4, temperature=0.0)
    kwargs = dict(seed=3, log_every=0, batched=2, batched_max_len=1024, batched_chunk=4)
    evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 2), **kwargs)
    (sched,) = engine._batched_scheds.values()
    assert sched.alive()  # kept for reuse, not stopped
    evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 2), **kwargs)
    assert list(engine._batched_scheds.values()) == [sched]


def test_scheduler_key_holds_model_and_settings(tiny):
    """A cached scheduler was built from the model and the decode settings;
    changing any of them must give a new scheduler, not the stale one."""
    model, cfg, tok = tiny
    engine = _engine(tiny, temperature=0.5)
    first = engine.scheduler(2, 1024, 4)
    assert engine.scheduler(2, 1024, 4) is first
    seen = [first]
    for change in ({"temperature": 0.0}, {"top_p": 0.5}, {"kv_quant": "int8"}):
        for k, v in change.items():
            setattr(engine, k, v)
        sched = engine.scheduler(2, 1024, 4)
        assert all(sched is not s for s in seen), change
        eng = sched.engine
        assert (eng.temperature, eng.top_p, eng.kv_quant) == (
            engine.temperature, engine.top_p, engine.kv_quant)
        seen.append(sched)
    other, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    engine.model = other
    sched = engine.scheduler(2, 1024, 4)
    assert sched.engine.model is other and all(sched is not s for s in seen)
    for s in seen + [sched]:
        s.stop()


def test_dead_scheduler_is_rebuilt(tiny):
    engine = _engine(tiny, max_new_tokens=4, temperature=0.0)
    first = engine.scheduler(2, 1024, 4)
    first.stop()
    assert not first.alive()
    again = engine.scheduler(2, 1024, 4)
    assert again is not first and again.alive()
    result = evaluate_epic_kitchen_traj(engine, StubDataset(tiny[1], 2), seed=3, log_every=0,
                                        batched=2, batched_max_len=1024, batched_chunk=4)
    assert len(result["val_info"]) == 2
    again.stop()


# -- scoring fed the same predictions ---------------------------------------------


def _fake_output(key):
    """A deterministic SampleOutput for (clip, sample) `key`: 2-5 hand
    waypoints (clip 1 has none, so it is not scored)."""
    i, s = key
    rng = np.random.default_rng(100 * i + s)
    nh = 0 if i == 1 else int(rng.integers(2, 6))
    pred = np.zeros((1, 2, 10, 2), np.float32)
    pred[:, :, :nh] = rng.uniform(size=(1, 2, nh, 2))
    seq = np.zeros((1, 8), np.int32)
    seq[0, :nh] = 32100
    return SampleOutput(sequences=seq, num_tokens=np.asarray([max(nh, 1)], np.int32),
                        pred_hands=pred, num_hands=np.asarray([nh], np.int32))


@pytest.mark.parametrize("num_samples", [1, 3])
def test_serial_and_batched_score_the_same_predictions(tiny, monkeypatch, num_samples):
    n, seed = 5, 7
    calls = []

    def serial_generate(*args, **kwargs):
        key = divmod(len(calls), num_samples)
        calls.append(key)
        return _fake_output(key)

    def batched_submit(self, ids, images, *, seed, max_new, **kwargs):
        base = seed - 7 * 1_000_003
        return _fake_output(divmod(base, num_samples))

    monkeypatch.setattr(teval, "generate_host", serial_generate)
    monkeypatch.setattr(ContinuousScheduler, "submit", batched_submit)
    engine = _engine(tiny, max_new_tokens=8)
    data = StubDataset(tiny[1], n)
    serial = evaluate_epic_kitchen_traj(engine, data, seed=seed, log_every=0,
                                        num_samples=num_samples)
    batched = evaluate_epic_kitchen_traj(engine, data, seed=seed, log_every=0,
                                         num_samples=num_samples, batched=2)
    assert serial["n"] == batched["n"] == n - 1
    for k in ("ade", "fde", "wde"):
        assert np.isfinite(serial[k])
        assert abs(serial[k] - batched[k]) <= 1e-6

    # the JAX evaluator scores the same predictions identically
    jcalls = []

    def jax_infer(self, question, images, rng, *args, **kwargs):
        out = _fake_output(divmod(len(jcalls), num_samples))
        jcalls.append(1)
        pred, valid = jeval.clip_pred_hands(out.pred_hands, out.num_hands)
        return pred, valid, out.sequences[0]

    monkeypatch.setattr(jeval.InferenceEngine, "infer", jax_infer)
    jengine = jeval.InferenceEngine(params=None, cfg=None, tokenizer=engine.tokenizer)
    want = jeval.evaluate_epic_kitchen_traj(jengine, data, seed=seed, log_every=0,
                                            num_samples=num_samples)
    assert want["n"] == serial["n"]
    for k in ("ade", "fde", "wde"):
        assert serial[k] == want[k]
