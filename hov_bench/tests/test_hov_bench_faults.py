"""The output check catches a broken timed path: each run is the whole run
after the look for a card (tiny224 widths on the CPU, the cells' own
limits), with a fault planted in the program underneath, and `correct`
must come out false. Then the control (the fp8 reference in the program's
place) must read well above the program on some compared number."""

from __future__ import annotations

import argparse

import pytest
import torch

from hov_bench import run as harness
from hov_bench.core import cells
from hov_bench.core.faults import FAULTS
from hov_bench.tests import tiny

EVAL, TRAIN = "eval-mistral7b-s32", "qlora-solar10b-int4-2k"


@pytest.fixture
def bench(tmp_path, monkeypatch):
    man = tiny.write(tmp_path)
    monkeypatch.setattr(cells, "BENCH", tmp_path)
    return man


def rehearse(man, name, control=False, seed=2 ** 31 + 5):
    args = argparse.Namespace(workload=name, seed=seed, seconds=2.0, trace=0)
    return harness.run_cell(args, torch.device("cpu"), manifest_path=man, control=control)


@pytest.mark.parametrize("name,fault", [
    (EVAL, "altered_tokens"), (EVAL, "shifted_draws"), (EVAL, "altered_answers"),
    (TRAIN, "unchanged_state"), (TRAIN, "half_batch")])
def test_fault_is_not_correct(bench, monkeypatch, name, fault):
    """At tiny widths the steering coordinates dominate the residual and the
    other logits lie close together, so the token fault puts the least
    likely token, not a neighbouring id."""
    assert rehearse(bench, name)["correct"]
    FAULTS[fault](monkeypatch.setattr)
    res = rehearse(bench, name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", [EVAL, TRAIN])
def test_control_reads_above_the_program(bench, name):
    """At tiny widths the limits of the full size are far above both
    readings, so the control is held here to the program's own: on some
    compared number it reads ten times the program or more."""
    checks = rehearse(bench, name, control=True)["checks"]
    mine = {k: v["value"] for k, v in checks.items() if not k.startswith("control.")}
    ctl = {k[len("control."):]: v["value"] for k, v in checks.items() if k.startswith("control.")}
    assert set(ctl) == set(mine)
    assert any(ctl[k] >= 10 * max(mine[k], 1e-9) for k in mine), checks
