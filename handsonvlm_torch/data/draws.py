"""Per-item random draws for a training mixture read from a loader's threads.

The datasets of the train CLI's `--tasks` mixture draw their item index,
question and answer templates, narration rephrases and multiturn modes from
the generators they hold: `rng` (a `random.Random`) and `np_rng` (a
`np.random.Generator`). `PrefetchLoader` reads them from a pool of threads.
`seed_mixture` gives every dataset of the mixture a seed of its own, from
the run's seed, the dataset's place in the mixture (group index, index in
the group) and the step the run starts from, and has each dataset route its
draws (`route_draws(rng, np_rng)`, which each dataset family of the mixture
defines over the generators it holds) to `THREAD_RNG` / `THREAD_NP_RNG`,
which forward each draw to the generators of the item the calling thread is
making. An item's generators come from its dataset's seed and the item's
key: its place in the run, (step, position in the global batch), which
`PrefetchLoader` sets for the thread that makes it (`keyed`), or outside a
loader its call number, taken under a lock. So an item is the same in every
run and on every rank with that seed and start step, whichever thread makes
it: the ranks of a tensor-parallel group, which each draw the global batch,
take the same rows, two runs with one seed draw the same batches, and a run
resumed at step k draws new ones.

(The JAX package draws every item from a fresh `np.random.RandomState()`,
so its runs never repeat; the port's streams repeat only for one seed and
start step.)
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import List, Optional, Tuple

import numpy as np

_LOCAL = threading.local()


class _ThreadGenerator:
    """Forwards each attribute read (`choice`, `integers`, ...) to the
    generator of the item the calling thread is making."""

    def __init__(self, index: int):
        self._index = index

    def __getattr__(self, name):
        pair = getattr(_LOCAL, "pair", None)
        if pair is None:
            raise RuntimeError("a seeded dataset drew outside SeededDataset.__getitem__")
        return getattr(pair[self._index], name)


THREAD_RNG = _ThreadGenerator(0)
THREAD_NP_RNG = _ThreadGenerator(1)


def item_key() -> Optional[Tuple[int, ...]]:
    """The key of the item the calling thread is making (`keyed`), None
    outside a loader."""
    return getattr(_LOCAL, "key", None)


@contextlib.contextmanager
def keyed(key: Tuple[int, ...]):
    """Make the items read inside the block under `key` (the loader's
    (step, position in the global batch))."""
    prev = item_key()
    _LOCAL.key = tuple(key)
    try:
        yield
    finally:
        _LOCAL.key = prev


def item_generators(seq: np.random.SeedSequence) -> Tuple[random.Random, np.random.Generator]:
    """The (random.Random, np.random.Generator) pair of one seed sequence."""
    return (random.Random(int.from_bytes(seq.generate_state(4).tobytes(), "little")),
            np.random.default_rng(seq))


class ItemSeeds:
    """A seed sequence and a call counter: each `next_sequence()` call
    returns the child sequence of the calling thread's item key, or
    without one of the next call number, taken under a lock."""

    def __init__(self, seq: np.random.SeedSequence):
        self.seq = seq
        self._lock = threading.Lock()
        self._calls = 0

    def next_sequence(self) -> np.random.SeedSequence:
        key = item_key()
        if key is None:
            with self._lock:
                key = (self._calls,)
                self._calls += 1
        return np.random.SeedSequence(self.seq.entropy, spawn_key=self.seq.spawn_key + key)


class SeededDataset:
    """A dataset whose every item draws from generators of its own (see the
    module docstring)."""

    def __init__(self, dataset, seq: np.random.SeedSequence):
        self.dataset = dataset
        self.seeds = ItemSeeds(seq)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        prev = getattr(_LOCAL, "pair", None)
        _LOCAL.pair = item_generators(self.seeds.next_sequence())
        try:
            return self.dataset[i]
        finally:
            _LOCAL.pair = prev


def seed_mixture(groups: List[List], seed: int, start_step: int
                 ) -> Tuple[List[List], np.random.SeedSequence]:
    """Wrap every dataset of `groups` (the mixture's dataset groups) in a
    `SeededDataset` seeded from (seed, start_step, group index, index in
    the group), its draws routed to the calling thread's item. Returns the
    groups and the seed sequence of the mixture's own task draws
    (`HybridDataset(seed=...)`)."""
    out = []
    for g, group in enumerate(groups):
        seeded = []
        for j, ds in enumerate(group):
            if not hasattr(ds, "route_draws"):
                raise TypeError(f"{type(ds).__name__} does not route its draws "
                                "(route_draws), so its items cannot be seeded")
            ds.route_draws(THREAD_RNG, THREAD_NP_RNG)
            seeded.append(SeededDataset(ds, np.random.SeedSequence(
                seed, spawn_key=(start_step, g, j))))
        out.append(seeded)
    return out, np.random.SeedSequence(seed, spawn_key=(start_step,))
