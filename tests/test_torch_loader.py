"""The port's PrefetchLoader (handsonvlm_torch/train/loader.py) against the
JAX package's.

Ports of the 6 PrefetchLoader cases of tests/test_loader_utils.py: batch
shapes and count with the prompt dropped; the same seed gives the same
batches; staging on a device gives tensors there; per-process slices of
the same global stream reassemble the global batch; a global batch that
the processes do not divide raises; the whole global batch staged by one
process. Plus the index draws against JAX's loader for the same seed, and a
producer error reaching the consumer. The meters, logger, distributed and
frame-cache cases of that file wait with their modules (ROADMAP A12, A11,
A4 rest).
"""

import numpy as np
import pytest
import torch

from handsonvlm_tpu.train.loader import PrefetchLoader as JaxPrefetchLoader
from handsonvlm_torch.train.loader import PrefetchLoader


class TinyDataset:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.full((4,), i, np.float32), "prompt": f"p{i}"}


def _collate(samples):
    return {
        "x": np.stack([s["x"] for s in samples]),
        "prompt": [s["prompt"] for s in samples],
    }


def test_prefetch_loader_shapes_and_count():
    loader = PrefetchLoader(
        TinyDataset(), _collate, batch_size=4, num_steps=5, num_workers=2, seed=0
    )
    batches = list(loader)
    assert len(batches) == 5
    for b in batches:
        assert b["x"].shape == (4, 4)
        assert "prompt" not in b  # dropped (non-array key)


def test_prefetch_loader_deterministic_seed():
    a = [b["x"] for b in PrefetchLoader(TinyDataset(), _collate, 4, 3, seed=7)]
    b = [b["x"] for b in PrefetchLoader(TinyDataset(), _collate, 4, 3, seed=7)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_prefetch_loader_device_put():
    loader = PrefetchLoader(TinyDataset(), _collate, 2, 2, device="cpu", seed=0)
    for b in loader:
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert b["x"].dtype == torch.float32


def test_prefetch_loader_per_host_slices():
    """Processes draw the same global stream and take disjoint interleaved
    slices that reassemble to the full global batch."""
    host_batches = []
    for pi in range(4):
        loader = PrefetchLoader(
            TinyDataset(), _collate, batch_size=8, num_steps=3, seed=11,
            process_index=pi, process_count=4,
        )
        host_batches.append(list(loader))
    for step in range(3):
        xs = [host_batches[pi][step]["x"] for pi in range(4)]
        assert all(x.shape == (2, 4) for x in xs)  # 8 global / 4 processes
        merged = np.empty((8, 4), np.float32)
        for pi in range(4):
            merged[pi::4] = xs[pi]
        ref = np.random.default_rng(11)
        for _ in range(step + 1):
            idxs = ref.integers(0, 10, size=8)
        np.testing.assert_array_equal(merged[:, 0], idxs.astype(np.float32))


def test_prefetch_loader_global_batch_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        PrefetchLoader(TinyDataset(), _collate, 6, 1, process_index=0, process_count=4)


def test_prefetch_loader_whole_global_batch_on_one_process():
    """One process (torch.distributed not initialised: rank 0 of 1) stages
    the whole global batch on its device."""
    loader = PrefetchLoader(TinyDataset(), _collate, 8, 2, device="cpu", seed=0)
    assert (loader.process_index, loader.process_count) == (0, 1)
    for b in loader:
        assert tuple(b["x"].shape) == (8, 4)


@pytest.mark.parametrize("pi", [0, 1])
def test_index_draws_match_jax_loader(pi):
    """The same seed gives the same batches as JAX's loader, whole or per
    process slice."""
    kw = dict(batch_size=6, num_steps=4, seed=5, process_index=pi, process_count=2)
    got = [b["x"] for b in PrefetchLoader(TinyDataset(), _collate, **kw)]
    want = [b["x"] for b in JaxPrefetchLoader(TinyDataset(), _collate, **kw)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_producer_error_reaches_the_consumer():
    class Broken(TinyDataset):
        def __getitem__(self, i):
            raise KeyError(f"sample {i}")

    with pytest.raises(KeyError, match="sample"):
        list(PrefetchLoader(Broken(), _collate, 2, 3, seed=0))
