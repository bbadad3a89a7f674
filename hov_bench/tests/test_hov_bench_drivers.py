"""Each cell rehearsed at tiny224 widths on the CPU through the program's
entry points and the whole run (set-up, window, readers, output check),
and the run's refusal without a card."""

from __future__ import annotations

import argparse

import pytest
import torch

from hov_bench import run as harness
from hov_bench.core import cells
from hov_bench.tests import tiny

CELLS = ["eval-mistral7b-s32", "qlora-solar10b-int4-2k"]


@pytest.fixture
def bench(tmp_path, monkeypatch):
    man = tiny.write(tmp_path)
    monkeypatch.setattr(cells, "BENCH", tmp_path)
    return man


def rehearse(man, name, trace=0, seconds=4.0, seed=2 ** 31 + 11):
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    return harness.run_cell(args, torch.device("cpu"), manifest_path=man)


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsed_on_the_cpu(bench, name):
    res = rehearse(bench, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    man = cells.manifest(bench)
    want = {m["name"] for m in man["end_to_end"] if name in m.get("workloads", [name])}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks" and all(v["value"] >= 0 for v in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_writes_no_device_metric(bench, name):
    """A CPU run never writes a number under a device metric's name."""
    res = rehearse(bench, name, trace=1)
    man = cells.manifest(bench)
    device = {m["name"] for m in man["per_layer"]
              if m["source"] == "device_trace" or m["name"].startswith("mfu")}
    assert not device & set(res["metrics"])
    assert res["correct"]


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is of machines without one")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_same_seed_same_outputs(bench):
    a = rehearse(bench, CELLS[1], seed=77)
    b = rehearse(bench, CELLS[1], seed=77)
    assert a["checks"] == b["checks"]
