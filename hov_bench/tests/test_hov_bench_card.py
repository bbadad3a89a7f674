"""On the card, at each cell's own size: the control (the fp8 reference in
the program's place) fails the cell's limits on three seeds, while the
program passes them on the same seeds. Skips where there is no card.

    python -m pytest --noconftest -o addopts="" -m cuda hov_bench/tests -q
"""

from __future__ import annotations

import argparse
import gc

import pytest
import torch

from hov_bench import run as harness
from hov_bench.core import cells

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["eval-mistral7b-s32", "qlora-solar10b-int4-2k"])
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    harness._cache_env()
    limits = cells.limits_file(name)
    for seed in SEEDS:
        args = argparse.Namespace(workload=name, seed=seed, seconds=8.0, trace=0)
        res = harness.run_cell(args, torch.device("cuda"), control=True)
        checks = res["checks"]
        assert res["correct"], checks
        assert any(checks[f"control.{k}"]["value"] > limit for k, limit in limits.items()), checks
        gc.collect()
        torch.cuda.empty_cache()
