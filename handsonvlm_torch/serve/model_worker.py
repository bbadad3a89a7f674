"""Model worker: serves generate requests, heartbeats to the controller.

Port of `handsonvlm_tpu/serve/model_worker.py` (its endpoints, payload keys,
status codes and stream protocol). Behavioral spec from
`llava/serve/model_worker.py:36-282`: register with the controller on
start, heartbeat every 15 s with the current queue length, bound
concurrency with a semaphore, expose status + generate endpoints. stdlib
http server.

Endpoints:
  GET  /healthz                -> {status: loading|ready, model_names}
  POST /worker_get_status      -> {model_names, speed, queue_length[, continuous]}
  POST /worker_generate        {prompt, image_b64?, history?, temperature, top_p,
                                max_new_tokens, lora?, model?, ttft_slo?}
                               -> {text, pred_hands, trajectory_valid, error_code}
  POST /worker_generate_stream same payload -> chunked, b'\\0'-delimited JSON:
                               {text, error_code} per burst, then the final
                               {text, pred_hands, trajectory_valid, error_code,
                               finish}

Routes: a request without an adapter goes to the continuous-batching
scheduler when `continuous_slots` > 0 (serve/scheduler.py), else to the
dynamic batcher when `max_batch` > 1 (serve/batcher.py), else decodes alone
(`InferenceEngine.infer`: speculative when `spec_k` > 0). An adapter
request (the `lora` field or a `<model>:<adapter>` name) decodes alone, or
through the batcher, with a view of the base model that carries the
adapter (serve/lora_registry.py); the base model is never changed. The
model runs on `device` (default "cuda"; the tests pass "cpu").
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue as queue_mod
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from handsonvlm_torch.serve.controller import WORKER_HEART_BEAT_INTERVAL


def _post(url: str, payload: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _percentile(sorted_vals, q: float):
    return round(sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))], 3)


class ModelWorker:
    def __init__(
        self,
        controller_addr: Optional[str],
        worker_addr: str,
        model_path: str,
        preset: str = "7b",
        model_name: Optional[str] = None,
        limit_concurrency: int = 2,
        max_batch: int = 1,
        batch_wait_ms: float = 30.0,
        quantize: Optional[str] = None,
        defer_load: bool = False,
        lora_dir: Optional[str] = None,
        lora_resident: int = 4,
        spec_k: int = 0,
        kv_quant=None,
        continuous_slots: int = 0,
        continuous_max_len: int = 4096,
        ttft_slo=None,
        admit_hold_s: float = 0.0,
        device: str = "cuda",
    ):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name or model_path.rstrip("/").split("/")[-1]
        # batching needs enough concurrent requests in flight to co-schedule
        self.semaphore = threading.Semaphore(
            max(limit_concurrency, max_batch, continuous_slots))
        self.queue_length = 0
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self.ready = False
        self.lora = None
        self.batcher = None
        self.scheduler = None
        self._load_args = (
            model_path, preset, quantize, max_batch, batch_wait_ms,
            lora_dir, lora_resident, spec_k, kv_quant,
            continuous_slots, continuous_max_len, ttft_slo, admit_hold_s, device,
        )
        if not defer_load:
            self.load()

    def load(self):
        """Build the engine, then register. With `defer_load=True` the HTTP
        server (and /healthz) can bind *before* this runs, so operators can
        tell "loading" from "dead" during the model load (the reference
        worker binds only after load)."""
        (model_path, preset, quantize, max_batch, batch_wait_ms,
         lora_dir, lora_resident, spec_k, kv_quant,
         continuous_slots, continuous_max_len, ttft_slo,
         admit_hold_s, device) = self._load_args

        from handsonvlm_torch.eval.evaluator import InferenceEngine
        from handsonvlm_torch.infer.builder import load_pretrained_model

        model, cfg, tokenizer = load_pretrained_model(model_path, preset, device,
                                                      quantize=quantize)
        self.engine = InferenceEngine(
            model=model, cfg=cfg, tokenizer=tokenizer, spec_k=spec_k, kv_quant=kv_quant,
        )
        self.cfg = cfg
        self._seed = 0
        if lora_dir:
            from handsonvlm_torch.serve.lora_registry import LoraRegistry

            self.lora = LoraRegistry(lora_dir, cfg, max_resident=lora_resident)
            print(f"lora adapters: {self.lora.names}")
        if max_batch > 1:
            from handsonvlm_torch.serve.batcher import DynamicBatcher

            self.batcher = DynamicBatcher(
                self.engine, max_batch=max_batch, max_wait_ms=batch_wait_ms
            )
        if continuous_slots > 0:
            from handsonvlm_torch.serve.scheduler import ContinuousScheduler

            self.scheduler = ContinuousScheduler(
                model, cfg, slots=continuous_slots,
                max_len=continuous_max_len, kv_quant=kv_quant,
                ttft_slo=ttft_slo, admit_hold_s=admit_hold_s,
            )

        self.ready = True
        if self.controller_addr:
            self.register()
            self._hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self._hb.start()

    def health(self) -> dict:
        return {
            "status": "ready" if self.ready else "loading",
            "model_names": [self.model_name],
        }

    def _model_names(self) -> list:
        """Base name plus one `<base>:<adapter>` alias per LoRA adapter, so
        the controller routes adapter-qualified model requests here and the
        web UI's model dropdown lists every adapter."""
        names = [self.model_name]
        if self.lora is not None:
            names += [f"{self.model_name}:{a}" for a in self.lora.names]
        return names

    def status(self) -> dict:
        out = {
            "model_names": self._model_names(),
            "speed": 1,
            "queue_length": self.queue_length,
        }
        if self.scheduler is not None:
            # continuous-batching telemetry: cache-defrag events and
            # time-to-first-token percentiles over this worker's lifetime
            # (ttft_p95_s is the port's; the JAX worker reports p50 and max)
            eng = self.scheduler.engine
            tt = sorted(self.scheduler.ttfts)
            out["continuous"] = {
                "slots": eng.b,
                "live": sum(s.busy for s in eng.slots),
                "cursor": eng.pos,
                "max_len": eng.s,
                "compactions": eng.compactions,
                "requests": len(tt),
                "ttft_p50_s": round(tt[len(tt) // 2], 3) if tt else None,
                "ttft_p95_s": _percentile(tt, 0.95) if tt else None,
                "ttft_max_s": round(tt[-1], 3) if tt else None,
            }
        return out

    def _request_model(self, payload: dict):
        """Resolve the model a request decodes with: explicit `lora` field,
        else a `<model>:<adapter>` qualified model name, else the base.
        Returns (model, adapter name or None)."""
        name = payload.get("lora")
        if not name:
            model = payload.get("model", "")
            if ":" in model:
                name = model.split(":", 1)[1]
        if not name or name == "base" or self.lora is None:
            return self.engine.model, None
        return self.lora.model_for(self.engine.model, name), name

    def register(self):
        _post(
            self.controller_addr + "/register_worker",
            {
                "worker_name": self.worker_addr,
                "check_heart_beat": True,
                "worker_status": self.status(),
            },
        )

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                r = _post(
                    self.controller_addr + "/receive_heart_beat",
                    {"worker_name": self.worker_addr, "queue_length": self.queue_length},
                )
                if not r.get("exist"):
                    self.register()
            except OSError as e:  # keep heartbeating through a controller outage
                print(f"heartbeat error: {e}")

    def stop(self):
        self._stop.set()
        if self.batcher is not None:
            self.batcher.stop()
        if self.scheduler is not None:
            self.scheduler.stop()

    def _frames(self, payload: dict) -> np.ndarray:
        if payload.get("image_b64"):
            from PIL import Image

            from handsonvlm_torch.data.video_io import clip_preprocess

            img = Image.open(io.BytesIO(base64.b64decode(payload["image_b64"])))
            frame = clip_preprocess(img)
            return np.tile(frame[None], (self.cfg.num_frames, 1, 1, 1))
        return np.zeros(
            (self.cfg.num_frames, 3, self.cfg.vision.image_size, self.cfg.vision.image_size),
            np.float32,
        )

    def _request_options(self, payload: dict):
        """Per-request decode options as locals — NEVER mutate the shared
        engine attributes: the semaphore admits several concurrent request
        threads (--continuous / --batch), so a shared-attribute write could
        leak one request's options into another in-flight request."""
        return (
            float(payload.get("temperature", 0.5)),
            float(payload.get("top_p", 0.9)),
            int(payload.get("max_new_tokens", 100)),
        )

    def _next_seed(self) -> int:
        """Atomic seed draw (read-modify-write under the lock): concurrent
        requests must not sample with the same seed."""
        with self.lock:
            self._seed += 1
            return self._seed

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.engine.device).manual_seed(seed)

    def _images(self, frames: np.ndarray):
        """One request's (T, 3, H, W) frames -> (unique frames (1, U, ...) on
        the model's device, frame map or None)."""
        images, frame_map = self.engine.dedup_frames(frames[None])
        return (torch.as_tensor(images, device=self.engine.device, dtype=self.engine.dtype),
                frame_map)

    def _history(self, payload: dict):
        return [tuple(t) for t in payload.get("history", [])]

    def _generate_continuous(self, payload: dict, frames, seed: int,
                             on_tokens=None):
        """Submit one request to the continuous-batching scheduler and wait.
        Returns (pred, valid, gen_ids) shaped like InferenceEngine.infer."""
        from handsonvlm_torch.infer.sampler import clip_pred_hands

        ids = self.engine.build_prompt_ids(payload["prompt"], history=self._history(payload))
        images, frame_map = self._images(frames)
        slo = payload.get("ttft_slo")  # seconds; None = no deadline
        out = self.scheduler.submit(
            ids, images, seed=seed,
            max_new=int(payload.get("max_new_tokens", 100)),
            temperature=float(payload.get("temperature", 0.5)),
            top_p=float(payload.get("top_p", 0.9)),
            frame_map=frame_map, on_tokens=on_tokens,
            ttft_slo=None if slo is None else float(slo),
        )
        pred, valid = clip_pred_hands(out.pred_hands, out.num_hands)
        n = int(out.num_tokens[0])
        return pred, valid, np.asarray(out.sequences[0, :n])

    def generate(self, payload: dict) -> dict:
        with self.lock:
            self.queue_length += 1
        self.semaphore.acquire()
        try:
            frames = self._frames(payload)
            temperature, top_p, max_new = self._request_options(payload)
            seed = self._next_seed()
            model, lora_name = self._request_model(payload)
            if self.scheduler is not None and lora_name is None:
                # shared decode batch; adapter requests fall through to the
                # solo path (the scheduler's engine decodes the base)
                pred, valid, gen_ids = self._generate_continuous(payload, frames, seed)
            elif self.batcher is not None:
                pred_row, valid_row, gen_ids = self.batcher.submit(
                    payload["prompt"], frames, seed, lora=lora_name,
                    model=None if lora_name is None else model,
                )
                pred, valid = pred_row[None], np.asarray([valid_row])
            else:
                pred, valid, gen_ids = self.engine.infer(
                    payload["prompt"], frames[None], self._generator(seed), model=model,
                    history=self._history(payload), temperature=temperature, top_p=top_p,
                    max_new_tokens=max_new,
                )
            text = (
                self.engine.tokenizer.decode(gen_ids)
                if hasattr(self.engine.tokenizer, "decode")
                else ""
            )
            return {
                "text": text,
                "pred_hands": pred.tolist(),
                "trajectory_valid": bool(valid[0]),
                "error_code": 0,
            }
        finally:
            self.semaphore.release()
            with self.lock:
                self.queue_length -= 1

    def generate_stream(self, payload: dict):
        """Yield accumulated-text dicts per burst of tokens, then a final
        dict with the decoded trajectory.

        Protocol matches the reference worker's generate_stream
        (llava/serve/model_worker.py:128-180): each yielded dict carries the
        full text so far + error_code 0; consumers split on b'\\0'. Three
        routes: the continuous scheduler (a burst per chunk), speculative
        decode (a burst per verify forward) and the host decode loop (a
        token per step, finished at the v1 template's stop string)."""
        from handsonvlm_torch.data.conversation import conv_templates
        from handsonvlm_torch.serve.scheduler import SLORejected

        with self.lock:
            self.queue_length += 1
        self.semaphore.acquire()
        try:
            frames = self._frames(payload)
            temperature, top_p, max_new = self._request_options(payload)
            seed = self._next_seed()
            model, lora_name = self._request_model(payload)
            q: queue_mod.Queue = queue_mod.Queue()
            decode = self.engine.tokenizer.decode
            pieces = []

            def final(pred, valid):
                return {
                    "text": decode(pieces),
                    "pred_hands": pred.tolist(),
                    "trajectory_valid": bool(valid[0]),
                    "error_code": 0,
                    "finish": True,
                }

            if self.scheduler is not None and lora_name is None:
                # continuous batching: chunk-boundary streaming (tokens
                # arrive in bursts of <= chunk per step)
                def on_tokens(tok_ids):
                    pieces.extend(int(t) for t in tok_ids)
                    q.put({"text": decode(pieces), "error_code": 0})

                def run():
                    try:
                        pred, valid, _gen = self._generate_continuous(
                            payload, frames, seed, on_tokens=on_tokens)
                        q.put(final(pred, valid))
                    except SLORejected as e:
                        # load shed, not failure: error_code 3 matches the
                        # non-stream path's 429 so streaming clients can
                        # retry elsewhere (--ttft-slo help text)
                        q.put({"error": str(e), "error_code": 3, "finish": True})
                    except Exception as e:  # noqa: BLE001 — surface to the client
                        q.put({"error": str(e), "error_code": 1, "finish": True})
                    q.put(None)
            else:
                conv = conv_templates[self.engine.conv_mode]
                stop_str = conv.sep2 if conv.sep2 else conv.sep

                def on_token(tok_id: int):
                    pieces.append(tok_id)
                    q.put({"text": decode(pieces), "error_code": 0})

                def run():
                    # the engine's solo route: speculative decode streams a
                    # burst of 1..k+1 tokens per verify forward, the host
                    # loop a token per step up to the stop string
                    try:
                        pred, valid, _gen = self.engine.infer(
                            payload["prompt"], frames[None], self._generator(seed),
                            model=model, history=self._history(payload),
                            temperature=temperature, top_p=top_p, max_new_tokens=max_new,
                            on_token=on_token, stop_strs=[stop_str] if stop_str else None)
                        q.put(final(pred, valid))
                    except Exception as e:  # noqa: BLE001 — surface to the client
                        q.put({"error": str(e), "error_code": 1, "finish": True})
                    q.put(None)

            threading.Thread(target=run, daemon=True).start()
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            self.semaphore.release()
            with self.lock:
                self.queue_length -= 1


def serve_worker(worker: ModelWorker, host: str, port: int):
    from handsonvlm_torch.serve.scheduler import SLORejected

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, chunks):
            """Chunked transfer encoding; each item is JSON + b'\\0'
            (the reference's llava/serve worker stream protocol)."""
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for item in chunks:
                    body = json.dumps(item).encode() + b"\0"
                    self.wfile.write(f"{len(body):x}\r\n".encode() + body + b"\r\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                chunks.close()  # client went away; run the generator's finally
                return
            self.wfile.write(b"0\r\n\r\n")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, worker.health())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/healthz":
                self._json(200, worker.health())
            elif self.path == "/worker_get_status":
                self._json(200, worker.status())
            elif self.path in ("/worker_generate", "/worker_generate_stream") and not worker.ready:
                self._json(503, {"error": "model loading", "error_code": 2})
            elif self.path == "/worker_generate":
                try:
                    self._json(200, worker.generate(data))
                except SLORejected as e:
                    # load shed: the client should retry elsewhere / later
                    self._json(429, {"error": str(e), "error_code": 3})
                except Exception as e:  # noqa: BLE001 — report to the client
                    self._json(500, {"error": str(e), "error_code": 1})
            elif self.path == "/worker_generate_stream":
                self._stream(worker.generate_stream(data))
            else:
                self._json(404, {"error": "unknown path"})

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=40000)
    p.add_argument("--controller", default="http://localhost:10000")
    p.add_argument("--worker-address", default=None)
    p.add_argument("--model-path", required=True)
    p.add_argument("--preset", default="7b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--limit-model-concurrency", type=int, default=2)
    p.add_argument("--max-batch", type=int, default=1,
                   help=">1 enables dynamic request batching (serve/batcher.py)")
    p.add_argument("--batch-wait-ms", type=float, default=30.0)
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decoder")
    p.add_argument("--int4", action="store_true",
                   help="int4 group-wise weight-only decoder")
    p.add_argument("--lora-dir", default=None,
                   help="directory of LoRA adapter subdirs to hot-swap per "
                        "request (serve/lora_registry.py)")
    p.add_argument("--lora-resident", type=int, default=4,
                   help="max adapters resident on the device at once (LRU)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8-quantized KV cache (exact per-token dequant)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decode for unbatched requests "
                        "(K-token drafts; infer/speculative.py)")
    p.add_argument("--continuous", type=int, default=0, metavar="SLOTS",
                   help=">0 enables continuous batching: SLOTS requests "
                        "share one decode batch, joining/leaving at chunk "
                        "boundaries (serve/continuous.py); takes precedence "
                        "over --max-batch for non-LoRA requests")
    p.add_argument("--continuous-max-len", type=int, default=4096,
                   help="shared-cache length budget for --continuous "
                        "(prompt buckets + decode chunks of every "
                        "concurrently admitted request)")
    p.add_argument("--admit-hold", type=float, default=0.0, metavar="SECONDS",
                   help="idle-engine burst coalescing for --continuous: "
                        "wait up to this long for more arrivals before the "
                        "first join so a burst prefills as ONE group join "
                        "(0 keeps latency-first admission)")
    p.add_argument("--ttft-slo", type=float, default=None, metavar="SECONDS",
                   help="first-token latency SLO for --continuous: reject "
                        "(HTTP 429) any request whose estimated TTFT "
                        "exceeds it instead of queueing; per-request "
                        "'ttft_slo' in the payload overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    worker = ModelWorker(
        args.controller, None, args.model_path, args.preset,
        limit_concurrency=args.limit_model_concurrency,
        max_batch=args.max_batch, batch_wait_ms=args.batch_wait_ms,
        quantize="int8" if args.int8 else ("int4" if args.int4 else None),
        defer_load=True,
        lora_dir=args.lora_dir, lora_resident=args.lora_resident,
        spec_k=args.spec,
        kv_quant="int8" if args.kv_int8 else None,
        continuous_slots=args.continuous,
        continuous_max_len=args.continuous_max_len,
        ttft_slo=args.ttft_slo,
        admit_hold_s=args.admit_hold,
        device=args.device,
    )
    # bind + serve /healthz immediately; generate endpoints 503 until loaded
    server = serve_worker(worker, args.host, args.port)
    port = server.server_address[1]  # the bound port (--port 0 picks a free one)
    worker.worker_addr = args.worker_address or f"http://localhost:{port}"
    print(f"worker {worker.worker_addr} bound (loading {worker.model_name})", flush=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    worker.load()
    print(f"worker {worker.worker_addr} serving {worker.model_name}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    main()
