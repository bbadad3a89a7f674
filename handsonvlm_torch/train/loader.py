"""Host-side data loading with background prefetch to the device.

Port of `handsonvlm_tpu/train/loader.py`: a thread pool maps dataset
indices to samples, and a background thread collates and stages the next
batches, so the card does not wait on decoding and tokenization.

Multi-process semantics as in the JAX package: every process draws the
SAME global index stream from `seed` and keeps only its `process_index`-th
interleaved slice (the rank and world size of `torch.distributed` when it
is initialised, else 0 and 1), so the ranks' slices reassemble the global
batch. Each item is made under its key, (first_step + step, position in
the global batch) (`data/draws.keyed`), so a dataset that seeds its draws
from the key makes the same batch, in the same order, in every process
and run, whichever worker thread reads an item. A producer error reaches
the consumer, which re-raises it.

Staging: with a `device`, each array of the batch becomes a tensor there,
through pinned host memory and a non-blocking copy for a CUDA device (the
copy is queued on the device's current stream, ahead of the step's
kernels); without one the batch stays numpy. A sharding over devices waits
for the parallelism port.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from handsonvlm_torch.data.draws import keyed


def process_index_count():
    """(rank, world size) of torch.distributed when initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        collate: Callable,
        batch_size: int,
        num_steps: int,
        num_workers: int = 8,
        prefetch: int = 2,
        device=None,
        drop_keys=("prompt",),
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        first_step: int = 0,
    ):
        self.dataset = dataset
        self.collate = collate
        self.batch_size = batch_size  # GLOBAL batch size
        self.num_steps = num_steps
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.drop_keys = drop_keys
        self.seed = seed
        self.first_step = first_step  # the run's start step: the first batch's key
        rank, world = process_index_count()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{self.process_count} processes"
            )

    def local_indices(self, rng: np.random.Generator) -> np.ndarray:
        """Draw the global index vector (identical in every process — same
        seed) and keep this process's interleaved slice."""
        idxs = rng.integers(0, len(self.dataset), size=self.batch_size)
        return idxs[self.process_index :: self.process_count]

    def _item(self, job):
        """One item, made under its key (step, position in the global
        batch): a dataset that seeds its draws from it (data/draws.py)
        makes the same item whichever worker thread reads it."""
        key, i = job
        with keyed(key):
            return self.dataset[int(i)]

    def _stage(self, batch: Dict[str, np.ndarray]) -> Dict:
        if self.device is None:
            return batch
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def _produce(self, q: "queue.Queue"):
        try:
            rng = np.random.default_rng(self.seed)
            with ThreadPoolExecutor(self.num_workers) as pool:
                for t in range(self.num_steps):
                    idxs = self.local_indices(rng)
                    places = range(self.process_index, self.batch_size, self.process_count)
                    samples = list(pool.map(self._item, [
                        ((self.first_step + t, k), i) for k, i in zip(places, idxs)]))
                    batch = self.collate(samples)
                    batch = {k: v for k, v in batch.items() if k not in self.drop_keys}
                    q.put(self._stage(batch))
        except BaseException as e:  # noqa: BLE001 — propagate to the consumer
            # without this, a producer crash leaves __iter__ blocked on
            # q.get() forever (a silent trainer hang)
            q.put(e)
            return
        q.put(None)

    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
