"""The port's HTTP serving stack (handsonvlm_torch/serve/: controller,
model_worker, batcher, lora_registry, web_server, register_worker,
test_message) on the CPU at random:tiny (`device="cpu"`).

- Ports of tests/test_serve.py (its 11 tests, names kept) and
  tests/test_scheduler.py::test_worker_continuous_e2e, run against the
  port's modules; the LoRA tests also hold that an adapter request leaves
  the base model untouched (its `lora` None, its greedy output the same
  before and after, a concurrent base request unchanged) and that the
  batcher never puts two adapters in one forward, and the proxy retry is
  driven through the web server.
- `python -m handsonvlm_torch.serve.model_worker --device cpu --port 0` in a
  subprocess: /healthz until "ready", one generate, registration with an
  in-process controller, then terminated.
- Every flag of each JAX serve CLI's parser is in the port's, with the
  JAX default (the worker adds --device, default cuda).
- Parity with the JAX stack: one checkpoint (the JAX tiny weights from
  PRNGKey(0), written once as an HF directory by the JAX package's
  `save_hf_checkpoint`) served by a JAX worker and a port worker. At
  temperature 0 and 8 new tokens `/worker_generate` gives the same `text`
  and `trajectory_valid`, `/worker_generate_stream` the same chunks (keys
  and texts), and one adapter's arrays, saved through each package's
  `save_artifact`, the same adapted text, which differs from the base's.
  Tolerance: none, the texts are compared exactly (greedy tokens of an f32
  model; the JAX builder is asked for f32 weights, as the port loads them,
  and the adapter arrays are bf16-representable, since the JAX worker
  casts adapters to bf16). Waypoint values are held against JAX in
  tests/test_torch_serve.py at the engine level, with injected latents,
  and are not compared over HTTP. The controllers' `/list_models`,
  `/get_worker_address` and `/worker_get_status` payloads are equal for
  the same registrations.
"""

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handsonvlm_tpu.convert.jax_to_hf import save_hf_checkpoint
from handsonvlm_tpu.core.checkpoint import save_artifact as jax_save_artifact
from handsonvlm_tpu.core.config import get_config as jax_get_config
from handsonvlm_tpu.infer import builder as jax_builder
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.serve import controller as jax_controller
from handsonvlm_tpu.serve import model_worker as jax_worker
from handsonvlm_tpu.serve import register_worker as jax_register
from handsonvlm_tpu.serve import test_message as jax_test_message
from handsonvlm_tpu.serve import web_server as jax_web

from handsonvlm_torch.config import get_config
from handsonvlm_torch.core.checkpoint import save_artifact
from handsonvlm_torch.models.lora import DEFAULT_TARGETS, init_lora
from handsonvlm_torch.serve import controller as ctrl_mod
from handsonvlm_torch.serve import model_worker as worker_mod
from handsonvlm_torch.serve import register_worker, test_message, web_server
from handsonvlm_torch.serve.controller import Controller, serve_controller
from handsonvlm_torch.serve.model_worker import ModelWorker, serve_worker
from handsonvlm_torch.serve.web_server import serve_web

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(url, payload, timeout=60.0):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(url, payload, timeout=120.0):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return [json.loads(c) for c in r.read().split(b"\0") if c]


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@contextlib.contextmanager
def _controller(serve=serve_controller):
    controller, server = serve("127.0.0.1", 0)
    try:
        yield controller, _serve(server)
    finally:
        server.shutdown()
        server.server_close()
        controller.stop()


@contextlib.contextmanager
def _worker(worker, serve=serve_worker):
    """Serve `worker` on an ephemeral port; yields its address."""
    server = serve(worker, "127.0.0.1", 0)
    try:
        yield _serve(server)
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()


def _tiny(**kw):
    kw.setdefault("preset", "tiny")
    return ModelWorker(None, "http://127.0.0.1:0", "random:tiny", device="cpu", **kw)


def _frames(cfg):
    return np.zeros((1, cfg.num_frames, 3, cfg.vision.image_size, cfg.vision.image_size),
                    np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# ports of tests/test_serve.py and test_scheduler.py::test_worker_continuous_e2e
# ---------------------------------------------------------------------------


def test_controller_registry_and_dispatch():
    c = Controller("shortest_queue")
    try:
        status = {"model_names": ["handsonvlm-7b"], "speed": 1, "queue_length": 0}
        assert c.register_worker("http://w1", True, status)
        assert c.register_worker("http://w2", True, dict(status, queue_length=5))
        assert not c.register_worker("http://w3", True, None)
        assert c.list_models() == ["handsonvlm-7b"]
        # shortest queue picks w1
        assert c.get_worker_address("handsonvlm-7b") == "http://w1"
        assert c.get_worker_address("unknown-model") == ""
        # heartbeats update queue length
        assert c.receive_heart_beat("http://w1", 10)
        assert not c.receive_heart_beat("http://nope", 0)
        assert c.get_worker_address("handsonvlm-7b") == "http://w2"
    finally:
        c.stop()


def test_controller_expiry():
    c = Controller("lottery")
    try:
        status = {"model_names": ["m"], "speed": 1, "queue_length": 0}
        c.register_worker("http://w1", True, status)
        c.register_worker("http://w2", False, status)  # never expires
        assert c.get_worker_address("m") in ("http://w1", "http://w2")
        c.worker_info["http://w1"].last_heart_beat = time.time() - 100
        c.worker_info["http://w2"].last_heart_beat = time.time() - 100
        c.remove_stale_workers_by_expiration()
        assert list(c.worker_info) == ["http://w2"]
        assert ctrl_mod.CONTROLLER_HEART_BEAT_EXPIRATION == 30
        assert ctrl_mod.WORKER_HEART_BEAT_INTERVAL == 15
    finally:
        c.stop()


def test_http_roundtrip_controller():
    with _controller() as (controller, base):
        r = _post(base + "/register_worker", {
            "worker_name": "http://wA",
            "check_heart_beat": True,
            "worker_status": {"model_names": ["tiny"], "speed": 1, "queue_length": 0},
        })
        assert r["ok"]
        assert _post(base + "/list_models", {})["models"] == ["tiny"]
        assert _post(base + "/get_worker_address", {"model": "tiny"})["address"] == "http://wA"
        assert _post(base + "/receive_heart_beat",
                     {"worker_name": "http://wA", "queue_length": 2})["exist"]
        st = _post(base + "/worker_get_status", {})
        assert st["model_names"] == ["tiny"] and st["queue_length"] == 2
        # /refresh_all_workers drops the expired entries
        controller.worker_info["http://wA"].last_heart_beat = time.time() - 100
        assert _post(base + "/refresh_all_workers", {})["ok"]
        assert _post(base + "/list_models", {})["models"] == []
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/nope", {})
        assert e.value.code == 404


@contextlib.contextmanager
def _stack(tmp_path, **worker_kw):
    """Controller + registered tiny worker + web server."""
    with _controller() as (controller, ctrl_addr):
        worker = ModelWorker(ctrl_addr, "http://127.0.0.1:0", "random:tiny", preset="tiny",
                             model_name="handsonvlm-tiny", device="cpu", defer_load=True,
                             **worker_kw)
        with _worker(worker) as w_addr:
            # register with the real worker port so the web proxy can reach it
            worker.worker_addr = w_addr
            worker.load()
            web = serve_web(ctrl_addr, "127.0.0.1", 0, logdir=str(tmp_path))
            try:
                yield ctrl_addr, worker, w_addr, _serve(web)
            finally:
                web.shutdown()
                web.server_close()


def test_worker_generate_e2e(tmp_path):
    """Full loop: controller + tiny-model worker + generate request, the
    streamed variant, and the web UI proxy on top."""
    with _stack(tmp_path) as (ctrl_addr, worker, w_addr, web):
        addr = _post(ctrl_addr + "/get_worker_address", {"model": "handsonvlm-tiny"})["address"]
        assert addr == w_addr  # registered at load
        out = _post(w_addr + "/worker_generate",
                    {"prompt": "Where should my hand move?", "max_new_tokens": 4})
        assert out["error_code"] == 0
        assert isinstance(out["text"], str)
        assert np.asarray(out["pred_hands"]).shape == (1, 2, 4, 2)

        # streamed: \0-delimited accumulated-text chunks, final carries the traj
        chunks = _stream(w_addr + "/worker_generate_stream", {"prompt": "Where?",
                                                                "max_new_tokens": 4})
        assert len(chunks) >= 2  # at least one per-token chunk + the final
        assert all(c["error_code"] == 0 for c in chunks)
        texts = [c["text"] for c in chunks]
        assert all(texts[i + 1].startswith(texts[i]) for i in range(len(texts) - 2))
        assert chunks[-1].get("finish") and "pred_hands" in chunks[-1]
        assert np.asarray(chunks[-1]["pred_hands"]).shape == (1, 2, 4, 2)

        # web UI: page, model list, generate proxy
        with urllib.request.urlopen(web + "/", timeout=10) as r:
            assert b"HandsOnVLM" in r.read()
        assert _post(web + "/list_models", {})["models"] == ["handsonvlm-tiny"]
        chunks = _stream(web + "/generate",
                         {"model": "handsonvlm-tiny", "prompt": "Hi", "max_new_tokens": 3})
        assert chunks and chunks[-1].get("finish")

        # unknown model through the proxy -> clean 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(web + "/generate", {"model": "nope", "prompt": "x"}, timeout=10)
        assert e.value.code == 503

        # test_message against the controller, and a manual re-registration
        out = test_message.main(["--controller", ctrl_addr, "--max-new-tokens", "2"])
        assert out["error_code"] == 0
        reply = register_worker.main(["--controller-address", ctrl_addr,
                                      "--worker-name", w_addr])
        assert reply == {"ok": True}


def test_multiturn_history_and_vote_logging(tmp_path):
    """Multi-turn chat state + vote/conversation logs (the reference
    gradio_web_server's conversation state, vote_last_response, and
    {date}-conv.json logging)."""
    with _stack(tmp_path) as (_, worker, w_addr, web):
        # turn-2 request carries turn-1 history; the worker renders both
        # turns into the v1 template (engine.build_prompt_ids)
        out = _post(w_addr + "/worker_generate",
                    {"prompt": "And after that?", "max_new_tokens": 3,
                     "history": [["Where should my hand move?", "To the cup."]]})
        assert out["error_code"] == 0

        eng = worker.engine
        plain = eng.build_prompt_ids("And after that?")
        multi = eng.build_prompt_ids(
            "And after that?", history=[("Where should my hand move?", "To the cup.")])
        assert multi.shape[1] > plain.shape[1]
        # <image> sentinel appears exactly once, on the first turn
        assert (multi == -200).sum() == 1

        # the proxied generate is logged with its history, then a vote
        _stream(web + "/generate", {"model": "handsonvlm-tiny", "prompt": "Hi",
                                    "max_new_tokens": 2, "history": [["q", "a"]]})
        _post(web + "/vote", {"type": "upvote", "model": "handsonvlm-tiny",
                              "history": [["q", "a"]]})
        logs = [f for f in os.listdir(tmp_path) if f.endswith("-conv.json")]
        assert len(logs) == 1, os.listdir(tmp_path)
        records = [json.loads(line) for line in open(os.path.join(tmp_path, logs[0]))]
        assert [r["type"] for r in records] == ["chat", "upvote"]
        assert records[0]["history"] == [["q", "a"]] and isinstance(records[0]["text"], str)
        assert all("tstamp" in r for r in records)


def test_worker_healthz_early_bind():
    """The worker binds + answers /healthz before the model loads; generate
    endpoints 503 while loading and work after load()."""
    worker = _tiny(defer_load=True)
    with _worker(worker) as base:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "loading"
        for path in ("/worker_generate", "/worker_generate_stream"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, {"prompt": "x"}, timeout=10)
            assert e.value.code == 503
        assert _post(base + "/worker_get_status", {})["queue_length"] == 0
        worker.load()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ready"
        out = _post(base + "/worker_generate", {"prompt": "Where?", "max_new_tokens": 2})
        assert out["error_code"] == 0


def test_worker_dynamic_batching():
    """Concurrent requests co-schedule into fewer decode batches."""
    worker = _tiny(max_batch=4, batch_wait_ms=200.0)
    worker.engine.max_new_tokens = 4  # the batcher decodes at the engine's settings
    with _worker(worker) as base:
        _post(base + "/worker_generate", {"prompt": "warm", "max_new_tokens": 4})
        before = worker.batcher.batches_run

        def ask(i):
            return _post(base + "/worker_generate",
                         {"prompt": f"request {i}", "max_new_tokens": 4})

        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(ask, range(4)))
        for out in outs:
            assert out["error_code"] == 0
            assert np.asarray(out["pred_hands"]).shape == (1, 2, 4, 2)
        ran = worker.batcher.batches_run - before
        assert worker.batcher.requests_served == 5
        assert ran < 4, f"expected co-scheduling, got {ran} batches for 4 requests"


def _adapter_arrays(cfg, seed, r=4):
    """One LoRA adapter (every target) with nonzero B, bf16-representable
    f32 arrays: {target: (a (L, din, r), b (L, r, dout))}."""
    lora = init_lora(torch.Generator().manual_seed(seed), cfg.llama, r=r, alpha=8.0)
    rng = np.random.default_rng(seed + 1)
    out = {}
    for t, ad in lora.adapters.items():
        a = ad.a.detach().numpy()
        b = 0.05 * rng.standard_normal(ad.b.shape).astype(np.float32)
        out[t] = tuple(torch.from_numpy(x).bfloat16().float().numpy() for x in (a, b))
    return out


def _write_adapter(tmpdir, cfg, name, seed, r=4):
    """The port's `lora` artifact (a LoRA module's state dict, as the train
    CLI writes it) of `_adapter_arrays`."""
    lora = init_lora(torch.Generator(), cfg.llama, r=r, alpha=8.0)
    for t, (a, b) in _adapter_arrays(cfg, seed, r).items():
        lora.adapters[t].a.data.copy_(torch.from_numpy(a))
        lora.adapters[t].b.data.copy_(torch.from_numpy(b))
    save_artifact(os.path.join(tmpdir, name), "lora", lora.state_dict(),
                  meta={"base": "random:tiny"})


def test_lora_hot_swap(tmp_path):
    """Worker serves base + per-request LoRA adapters from one resident model:
    adapters advertised as `<model>:<adapter>` names, requests routed by
    `lora` field or model suffix, the adapter changes the decoded output,
    the base model is never changed (its `lora` stays None and its output
    is the same after adapter requests, concurrent ones included), LRU
    eviction, and the batcher never mixes adapters in one decode batch."""
    cfg = get_config("tiny")
    _write_adapter(tmp_path, cfg, "styleA", seed=7)
    _write_adapter(tmp_path, cfg, "styleB", seed=99)
    worker = _tiny(model_name="tiny", max_batch=4, batch_wait_ms=150.0,
                   lora_dir=str(tmp_path), lora_resident=1)
    assert worker.lora.names == ["styleA", "styleB"]
    assert worker._model_names() == ["tiny", "tiny:styleA", "tiny:styleB"]

    engine = worker.engine
    base_model = engine.model
    frames = _frames(worker.cfg)
    engine.max_new_tokens = 4  # the batcher decodes at the engine's settings
    base_pred, _, base_ids = engine.infer("Where?", frames, _gen(), temperature=0.5,
                                           max_new_tokens=32)
    view = worker.lora.model_for(base_model, "styleA")
    a_pred, _, a_ids = engine.infer("Where?", frames, _gen(), model=view,
                                     temperature=0.5, max_new_tokens=32)
    assert (list(a_ids) != list(base_ids)) or not np.allclose(base_pred, a_pred, atol=1e-3)
    assert view is not base_model and view.lora is not None and base_model.lora is None
    assert view.llama is base_model.llama  # the weights are shared, not copied
    assert worker.lora.model_for(base_model, "base") is base_model
    assert worker.lora.model_for(base_model, None) is base_model

    # LRU: capacity 1 -> loading the second adapter evicts the first
    worker.lora.model_for(base_model, "styleB")
    assert worker.lora.evictions == 1

    batches = []
    infer_batch = engine.infer_batch

    def recording(questions, *args, model=None, **kw):
        batches.append((list(questions), model))
        return infer_batch(questions, *args, model=model, **kw)

    engine.infer_batch = recording
    engine.temperature = 0.0
    with _worker(worker) as base:
        url = base + "/worker_generate"
        alone = _post(url, {"prompt": "q0", "max_new_tokens": 3})
        out = _post(url, {"prompt": "hi", "lora": "styleA", "max_new_tokens": 3})
        assert out["error_code"] == 0
        # adapter via model-name suffix (web-UI dropdown path)
        out = _post(url, {"prompt": "hi", "model": "tiny:styleB", "max_new_tokens": 3})
        assert out["error_code"] == 0
        # unknown adapter -> clean 500, not a hang
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": "hi", "lora": "nope", "max_new_tokens": 3})
        assert e.value.code == 500

        # concurrent mixed requests: one batch per adapter at least, every
        # batch of one adapter, the base request's answer as when alone
        del batches[:]

        def ask(i):
            lora = [None, "styleA", "styleB"][i % 3]
            payload = {"prompt": f"q{i}", "max_new_tokens": 3}
            if lora:
                payload["lora"] = lora
            return _post(url, payload)

        with ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(ask, [0, 1, 2, 4, 5]))
        assert all(o["error_code"] == 0 for o in outs)
        assert outs[0]["text"] == alone["text"]
        assert len(batches) >= 3
        for questions, model in batches:
            kinds = {int(q[1:]) % 3 for q in questions}
            assert len(kinds) == 1, questions
            assert (model is None) == (kinds == {0})
    assert base_model.lora is None
    after_pred, _, after_ids = engine.infer("Where?", frames, _gen(), temperature=0.5,
                                           max_new_tokens=32)
    assert list(after_ids) == list(base_ids) and np.array_equal(after_pred, base_pred)


def test_worker_spec_decode():
    """--spec worker: unbatched requests decode speculatively (engine
    routes B=1 through generate_spec) and return the normal payload."""
    worker = _tiny(spec_k=2)
    with _worker(worker) as base:
        out = _post(base + "/worker_generate",
                    {"prompt": "Where should my hand move?", "max_new_tokens": 5})
        assert out["error_code"] == 0
        assert np.asarray(out["pred_hands"]).shape == (1, 2, 4, 2)
        assert worker.engine.spec_stats["tokens"] >= 1

        # streamed variant: burst streaming from the verify forwards
        chunks = _stream(base + "/worker_generate_stream", {"prompt": "Where?",
                                                              "max_new_tokens": 6})
        assert chunks and chunks[-1].get("finish")
        assert all(c["error_code"] == 0 for c in chunks)
        texts = [c["text"] for c in chunks[:-1]]
        assert all(texts[i + 1].startswith(texts[i]) for i in range(len(texts) - 1))


def test_worker_spec_with_lora(tmp_path):
    """Speculative decode composes with per-request LoRA hot-swap: the B=1
    spec path decodes with the adapter's view of the model (greedy: the
    adapter changes the text), and the base is untouched."""
    cfg = get_config("tiny")
    _write_adapter(tmp_path, cfg, "styleA", seed=11)
    worker = _tiny(model_name="tiny", spec_k=2, lora_dir=str(tmp_path))
    with _worker(worker) as base:
        url = base + "/worker_generate"
        greedy = {"prompt": "hi", "max_new_tokens": 6, "temperature": 0.0}
        out = _post(url, dict(greedy, lora="styleA"))
        assert out["error_code"] == 0
        plain = _post(url, greedy)
        assert plain["error_code"] == 0
        assert out["text"] != plain["text"]
        chunks = _stream(base + "/worker_generate_stream", dict(greedy, lora="styleA"))
        assert chunks[-1]["finish"] and chunks[-1]["text"] == out["text"]
    assert worker.engine.model.lora is None


def test_remove_worker_and_proxy_retry(tmp_path):
    """A stale registry entry (worker re-registered under a new address)
    must not 502 the web proxy: it reports the ghost via /remove_worker and
    retries with a fresh pick."""
    with _controller() as (controller, ctrl_addr):
        status = {"model_names": ["m"], "speed": 1, "queue_length": 0}
        assert _post(ctrl_addr + "/register_worker",
                     {"worker_name": "http://127.0.0.1:1", "worker_status": status})["ok"]
        assert _post(ctrl_addr + "/remove_worker",
                     {"worker_name": "http://127.0.0.1:1"})["ok"]
        assert not _post(ctrl_addr + "/remove_worker",
                         {"worker_name": "http://127.0.0.1:1"})["ok"]
        assert _post(ctrl_addr + "/get_worker_address", {"model": "m"})["address"] == ""

        # a ghost (nothing listens on port 1) ahead of a live worker in the
        # shortest-queue order: the proxy drops it and streams from the live one
        worker = _tiny(model_name="m", defer_load=True)
        with _worker(worker) as w_addr:
            worker.load()
            controller.register_worker("http://127.0.0.1:1", True, status)
            controller.register_worker(w_addr, True, dict(status, queue_length=3))
            web = serve_web(ctrl_addr, "127.0.0.1", 0, logdir=str(tmp_path))
            try:
                chunks = _stream(_serve(web) + "/generate",
                                 {"model": "m", "prompt": "Hi", "max_new_tokens": 2})
            finally:
                web.shutdown()
                web.server_close()
            assert chunks[-1]["finish"] and chunks[-1]["error_code"] == 0
            assert list(controller.worker_info) == [w_addr]


def test_worker_continuous_e2e():
    worker = _tiny(model_name="handsonvlm-tiny", continuous_slots=2,
                   continuous_max_len=512)
    with _worker(worker) as base:
        # two concurrent generates share the decode batch (different temps)
        results = {}

        def gen(i, temp):
            results[i] = _post(base + "/worker_generate", {
                "prompt": f"Where should my hand move {i}?",
                "max_new_tokens": 6, "temperature": temp,
            })

        threads = [threading.Thread(target=gen, args=(i, t))
                   for i, t in enumerate([0.0, 0.7])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(2):
            assert results[i]["error_code"] == 0
            assert np.asarray(results[i]["pred_hands"]).shape == (1, 2, 4, 2)

        # streamed: \0-delimited accumulated text, final carries the traj
        chunks = _stream(base + "/worker_generate_stream",
                         {"prompt": "Where?", "max_new_tokens": 6})
        assert all(c["error_code"] == 0 for c in chunks)
        texts = [c["text"] for c in chunks]
        assert all(texts[i + 1].startswith(texts[i]) for i in range(len(texts) - 2))
        assert chunks[-1].get("finish") and "pred_hands" in chunks[-1]
        st = _post(base + "/worker_get_status", {})["continuous"]
        assert st["requests"] == 3 and st["slots"] == 2 and st["live"] == 0
        assert 0 < st["ttft_p50_s"] <= st["ttft_p95_s"] <= st["ttft_max_s"]


# ---------------------------------------------------------------------------
# the worker as a process, and the CLIs' flags
# ---------------------------------------------------------------------------


def test_worker_cli_runs_as_a_process():
    """`python -m handsonvlm_torch.serve.model_worker --device cpu --port 0`:
    /healthz until "ready", registered with the controller, one generate."""
    with _controller() as (controller, ctrl_addr):
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "handsonvlm_torch.serve.model_worker", "--device", "cpu",
             "--model-path", "random:tiny", "--preset", "tiny", "--host", "127.0.0.1",
             "--port", "0", "--controller", ctrl_addr],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            line = proc.stdout.readline()  # "worker http://localhost:<port> bound (...)"
            assert " bound " in line, line
            addr = line.split()[1]
            deadline = time.time() + 120
            status = None
            while time.time() < deadline:
                with urllib.request.urlopen(addr + "/healthz", timeout=10) as r:
                    status = json.loads(r.read())["status"]
                if status == "ready":
                    break
                time.sleep(0.2)
            assert status == "ready"
            # the worker turns ready, then registers
            while time.time() < deadline and not controller.list_models():
                time.sleep(0.05)
            assert controller.list_models() == ["random:tiny"]
            assert controller.get_worker_address("random:tiny") == addr
            out = _post(addr + "/worker_generate", {"prompt": "Where?", "max_new_tokens": 2})
            assert out["error_code"] == 0
        finally:
            proc.terminate()
            proc.wait(timeout=30)


class _Grabbed(Exception):
    pass


def _parser(main):
    """The ArgumentParser a CLI's main() builds (caught at parse_args)."""
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise _Grabbed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Grabbed):
            main()
    return {a.dest: (a.option_strings, a.default, a.type, a.nargs)
            for a in grabbed["parser"]._actions if a.dest != "help"}


@pytest.mark.parametrize("jax_main, port_main, extra", [
    (jax_worker.main, worker_mod.main, {"device": (["--device"], "cuda", None, None)}),
    (jax_controller.main, ctrl_mod.main, {}),
    (jax_web.main, web_server.main, {}),
    (jax_register.main, register_worker.main, {}),
    (jax_test_message.main, test_message.main, {}),
], ids=["model_worker", "controller", "web_server", "register_worker", "test_message"])
def test_cli_takes_every_jax_flag(jax_main, port_main, extra):
    """Every flag of the JAX CLI's parser, with its default and type."""
    assert _parser(port_main) == dict(_parser(jax_main), **extra)


# ---------------------------------------------------------------------------
# parity with the JAX stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paired_workers(tmp_path_factory):
    """A JAX worker and a port worker serving one HF checkpoint (the JAX
    tiny weights), each with the same adapter "styleA" saved through its
    own package's save_artifact."""
    cfg = jax_get_config("tiny")
    params = jax.tree_util.tree_map(np.asarray, init_handsonvlm(jax.random.PRNGKey(0), cfg))
    ckpt = str(tmp_path_factory.mktemp("model") / "hf")
    save_hf_checkpoint(params, ckpt)
    arrays = _adapter_arrays(get_config("tiny"), seed=5)
    jax_dir, port_dir = (str(tmp_path_factory.mktemp(d)) for d in ("jax_lora", "port_lora"))
    jax_save_artifact(os.path.join(jax_dir, "styleA"), "lora", {
        "adapters": {t: {"a": a, "b": b} for t, (a, b) in arrays.items()},
        "scale": np.float32(8.0 / 4)}, meta={"base": ckpt})
    lora = init_lora(torch.Generator(), get_config("tiny").llama, r=4, alpha=8.0)
    for t, (a, b) in arrays.items():
        lora.adapters[t].a.data.copy_(torch.from_numpy(a))
        lora.adapters[t].b.data.copy_(torch.from_numpy(b))
    save_artifact(os.path.join(port_dir, "styleA"), "lora", lora.state_dict(),
                  meta={"base": ckpt})
    assert sorted(arrays) == sorted(DEFAULT_TARGETS)

    with pytest.MonkeyPatch.context() as mp:
        # the JAX builder casts an HF checkpoint to bf16 by default; the
        # port loads the tiny preset in its f32 dtype: ask JAX for f32 too
        mp.setattr(jax_builder, "load_pretrained_model", functools.partial(
            jax_builder.load_pretrained_model, dtype=jnp.float32))
        jw = jax_worker.ModelWorker(None, "http://127.0.0.1:0", ckpt, preset="tiny",
                                    model_name="tiny", lora_dir=jax_dir)
    pw = ModelWorker(None, "http://127.0.0.1:0", ckpt, preset="tiny", model_name="tiny",
                     lora_dir=port_dir, device="cpu")
    with _worker(jw, jax_worker.serve_worker) as j_addr, _worker(pw) as p_addr:
        yield j_addr, p_addr


def test_worker_greedy_text_and_stream_equal_jax(paired_workers):
    j_addr, p_addr = paired_workers
    greedy = {"prompt": "Where should my hand move?", "max_new_tokens": 8,
              "temperature": 0.0}
    want = _post(j_addr + "/worker_generate", greedy)
    got = _post(p_addr + "/worker_generate", greedy)
    assert want["error_code"] == got["error_code"] == 0
    assert got["text"] == want["text"] and len(got["text"].split()) == 8
    assert got["trajectory_valid"] == want["trajectory_valid"]
    assert sorted(got) == sorted(want)

    want = _stream(j_addr + "/worker_generate_stream", greedy)
    got = _stream(p_addr + "/worker_generate_stream", greedy)
    assert [sorted(c) for c in got] == [sorted(c) for c in want]
    assert [c["text"] for c in got] == [c["text"] for c in want]
    assert got[-1]["trajectory_valid"] == want[-1]["trajectory_valid"]


def test_adapter_changes_greedy_text_as_jax(paired_workers):
    j_addr, p_addr = paired_workers
    greedy = {"prompt": "Where should my hand move?", "max_new_tokens": 8,
              "temperature": 0.0}
    base = _post(p_addr + "/worker_generate", greedy)
    for payload in (dict(greedy, lora="styleA"), dict(greedy, model="tiny:styleA")):
        want = _post(j_addr + "/worker_generate", payload)
        got = _post(p_addr + "/worker_generate", payload)
        assert got["text"] == want["text"] != base["text"]
    assert (_post(p_addr + "/worker_get_status", {})
            == _post(j_addr + "/worker_get_status", {}))


def test_controller_payloads_equal_jax():
    """The same registrations and heartbeats give equal /list_models,
    /get_worker_address and /worker_get_status payloads."""
    calls = [("/register_worker", {"worker_name": "http://w1", "worker_status": {
                 "model_names": ["b", "a"], "speed": 2, "queue_length": 3}}),
             ("/register_worker", {"worker_name": "http://w2", "check_heart_beat": False,
                                   "worker_status": {"model_names": ["a"],
                                                     "queue_length": 1}}),
             ("/receive_heart_beat", {"worker_name": "http://w1", "queue_length": 0}),
             ("/list_models", {}), ("/get_worker_address", {"model": "a"}),
             ("/get_worker_address", {"model": "b"}), ("/get_worker_address", {"model": "c"}),
             ("/worker_get_status", {}), ("/remove_worker", {"worker_name": "http://w2"}),
             ("/list_models", {}), ("/worker_get_status", {})]
    replies = []
    for serve in (jax_controller.serve_controller, serve_controller):
        with _controller(serve) as (_, base):
            replies.append([_post(base + path, payload) for path, payload in calls])
    assert replies[0] == replies[1]
