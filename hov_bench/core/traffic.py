"""The one traffic generator: a mix file's parameters -> the requests of a
run.

Sizes come from the mix's own `base_seed`, so every run seed gives the
same request sizes in the same order; the run's `--seed` picks the
contents (questions, frames, sampling draws). So the work of a run does not
depend on its seed, and its spread between seeds is that of the system.

Mix keys read here:
- `requests`: how many requests the schedule holds (enough to outlast the
  window);
- `new_tokens`: {"dist": "fixed", "value"} or {"dist": "loguniform", "lo",
  "hi"};
- `greedy_share`: the share of requests decoded greedily (temperature 0),
  which the output check compares token by token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from hov_bench.core.weights import derive


@dataclasses.dataclass
class Request:
    index: int
    new_tokens: int
    greedy: bool
    seed: int  # the request's own draws and contents


def _draw(dist: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    if dist["dist"] == "fixed":
        return np.full(n, int(dist["value"]))
    if dist["dist"] == "loguniform":
        lo, hi = math.log(dist["lo"]), math.log(dist["hi"])
        return np.round(np.exp(rng.uniform(lo, hi, size=n))).astype(int)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def schedule(mix: dict, seed: int) -> List[Request]:
    n = int(mix["requests"])
    base = np.random.default_rng(int(mix.get("base_seed", 0)))
    new = _draw(mix["new_tokens"], base, n)
    greedy = np.zeros(n, bool)
    greedy[: int(round(float(mix.get("greedy_share", 0.0)) * n))] = True
    mixed = base.permutation(n)  # sizes and greedy flags interleaved
    new, greedy = new[mixed], greedy[mixed]
    return [Request(index=i, new_tokens=int(new[i]), greedy=bool(greedy[i]),
                    seed=derive(seed, "request", i))
            for i in range(n)]
