"""Serving controller: worker registry, heartbeat expiry, dispatch.

Port of `handsonvlm_tpu/serve/controller.py` (its own copy: stdlib and
numpy, no torch). Behavioral spec from `llava/serve/controller.py:28-298`:
workers register
and heartbeat every 15 s; the controller expires them after 30 s
(llava/constants.py:1-2) and dispatches by lottery (speed-weighted) or
shortest queue. Implemented on the stdlib http server — this environment
ships no fastapi/uvicorn, and the API surface is small JSON POSTs.

Endpoints (reference-compatible paths):
  /register_worker           {worker_name, check_heart_beat, worker_status}
  /receive_heart_beat        {worker_name, queue_length} -> {exist}
  /remove_worker             {worker_name} -> {ok}
  /refresh_all_workers       -> {ok}: drops the workers whose heartbeat expired
  /list_models               -> {models}
  /get_worker_address        {model} -> {address}
  /worker_get_status         -> aggregated {model_names, speed, queue_length}
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._expiry_thread = threading.Thread(target=self._expire_loop, daemon=True)
        self._expiry_thread.start()

    def _expire_loop(self):
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            self.remove_stale_workers_by_expiration()

    def stop(self):
        self._stop.set()

    # -- registry ----------------------------------------------------------

    def register_worker(self, worker_name: str, check_heart_beat: bool, worker_status: Optional[dict]) -> bool:
        if not worker_status:
            return False
        with self.lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time(),
            )
        return True

    def remove_worker(self, worker_name: str) -> bool:
        """Drop a dead worker immediately (the reference controller removes
        workers on failed status refreshes, llava/serve/controller.py;
        callers report unreachable addresses here instead of waiting out
        the 30 s heartbeat expiry)."""
        with self.lock:
            return self.worker_info.pop(worker_name, None) is not None

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self.lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def remove_stale_workers_by_expiration(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            stale = [
                name
                for name, info in self.worker_info.items()
                if info.check_heart_beat and info.last_heart_beat < expire
            ]
            for name in stale:
                del self.worker_info[name]

    def list_models(self) -> List[str]:
        with self.lock:
            names = set()
            for info in self.worker_info.values():
                names.update(info.model_names)
            return sorted(names)

    # -- dispatch ------------------------------------------------------------

    def get_worker_address(self, model_name: str) -> str:
        with self.lock:
            candidates = [
                (name, info)
                for name, info in self.worker_info.items()
                if model_name in info.model_names
            ]
            if not candidates:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.asarray([i.speed for _, i in candidates], np.float32)
                speeds = speeds / speeds.sum()
                idx = np.random.choice(len(candidates), p=speeds)
                return candidates[idx][0]
            # shortest queue, normalised by speed (controller.py:122-138)
            qlen = [i.queue_length / max(i.speed, 1e-6) for _, i in candidates]
            idx = int(np.argmin(qlen))
            name, info = candidates[idx]
            info.queue_length += 1
            return name

    def worker_api_get_status(self) -> dict:
        with self.lock:
            names = set()
            speed = 0
            qlen = 0
            for info in self.worker_info.values():
                names.update(info.model_names)
                speed += info.speed
                qlen += info.queue_length
            return {"model_names": sorted(names), "speed": speed, "queue_length": qlen}


class _Handler(BaseHTTPRequestHandler):
    controller: Controller = None

    def log_message(self, *args):  # silence default stderr spam
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(length) or b"{}")
        c = self.controller
        if self.path == "/register_worker":
            ok = c.register_worker(
                data["worker_name"], data.get("check_heart_beat", True),
                data.get("worker_status"),
            )
            self._json(200 if ok else 400, {"ok": ok})
        elif self.path == "/receive_heart_beat":
            exist = c.receive_heart_beat(data["worker_name"], data.get("queue_length", 0))
            self._json(200, {"exist": exist})
        elif self.path == "/list_models":
            self._json(200, {"models": c.list_models()})
        elif self.path == "/remove_worker":
            self._json(200, {"ok": c.remove_worker(data["worker_name"])})
        elif self.path == "/refresh_all_workers":
            c.remove_stale_workers_by_expiration()
            self._json(200, {"ok": True})
        elif self.path == "/get_worker_address":
            self._json(200, {"address": c.get_worker_address(data["model"])})
        elif self.path == "/worker_get_status":
            self._json(200, c.worker_api_get_status())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})


def serve_controller(host: str = "0.0.0.0", port: int = 10000, dispatch: str = "shortest_queue"):
    controller = Controller(dispatch)
    handler = type("Handler", (_Handler,), {"controller": controller})
    server = ThreadingHTTPServer((host, port), handler)
    return controller, server


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--dispatch-method", default="shortest_queue")
    args = p.parse_args(argv)
    _, server = serve_controller(args.host, args.port, args.dispatch_method)
    print(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
