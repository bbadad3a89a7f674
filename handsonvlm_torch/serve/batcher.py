"""Dynamic request batching for the model worker.

Port of `handsonvlm_tpu/serve/batcher.py`. The reference serves one request
per generate call (llava model_worker semaphore). A batch-1 decode step
streams every weight for one row, so co-scheduling concurrent requests into
one `InferenceEngine.infer_batch` call serves several rows on the same
weight traffic.

`DynamicBatcher.submit` blocks until the result is ready; a collector
thread drains the queue, waits up to `max_wait_ms` for co-arrivals (never
delaying a lone request by more than that), splits the batch by adapter
(one adapter per forward) and runs the engine once per group, on the
collector thread. A group's draws come from one `torch.Generator` on the
model's device, seeded by its first request's seed.

The JAX batcher pads each batch to a power of two to bound its set of
compiled decode programs; the port compiles nothing per shape, so a batch
runs at its own size.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch


class DynamicBatcher:
    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 30.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.queue: "queue.Queue" = queue.Queue()
        self.batches_run = 0
        self.requests_served = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._collect_loop, daemon=True)
        self._thread.start()

    def submit(
        self,
        question: str,
        frames: np.ndarray,
        seed: int,
        timeout=600.0,
        lora: Optional[str] = None,
        model=None,
    ):
        """frames: (T, 3, H, W) for ONE request. Blocks until decoded.
        Returns (pred (2,4,2), valid bool, gen_ids).

        `lora` keys adapter grouping (only same-adapter requests share a
        decode batch); `model` is the model that adapter's requests decode
        with (serve/lora_registry.py `model_for`), None for the engine's."""
        fut: Future = Future()
        self.queue.put((question, frames, seed, fut, lora, model))
        return fut.result(timeout=timeout)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def _collect_loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    first = self.queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                batch = [first]
                t0 = time.monotonic()
                while len(batch) < self.max_batch:
                    remaining = self.max_wait - (time.monotonic() - t0)
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self.queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                # partition by adapter: one adapter per forward
                groups: dict = {}
                for req in batch:
                    groups.setdefault(req[4], []).append(req)
                for group in groups.values():
                    self._run(group)

    def _run(self, batch: List):
        futures = [b[3] for b in batch]
        try:
            generator = torch.Generator(device=self.engine.device).manual_seed(batch[0][2])
            pred, valid, gen_ids = self.engine.infer_batch(
                [b[0] for b in batch], np.stack([b[1] for b in batch]), generator,
                model=batch[0][5])
            self.batches_run += 1
            self.requests_served += len(batch)
            for i, fut in enumerate(futures):
                fut.set_result((pred[i], bool(valid[i]), gen_ids[i]))
        except Exception as e:  # noqa: BLE001 — fail every waiter, not the loop
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
