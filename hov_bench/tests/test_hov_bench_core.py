"""The benchmark's own pieces on the CPU: the seeded generators, the
quartile spread, the union of device intervals, the roofline and
MFU arithmetic on hand-worked shapes, the manifest's names, and the import
rules."""

from __future__ import annotations

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hov_bench.core import cells, readers, stats, traffic, work
from hov_bench.core.batches import batch, lora_start
from hov_bench.core.peaks import BF16_FLOPS, HBM_BYTES_S, bound_s
from hov_bench.core.trace import TraceSummary, gaps, merge, union_length

BENCH = Path(cells.__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MIX = {"requests": 200, "new_tokens": {"dist": "loguniform", "lo": 16, "hi": 128},
       "greedy_share": 0.25}


# -- generators ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 40 + 3])
def test_schedule_same_seed_same_requests(seed):
    a, b = traffic.schedule(MIX, seed), traffic.schedule(MIX, seed)
    assert a == b


def test_seeds_share_sizes_not_contents():
    a, b = traffic.schedule(MIX, 1), traffic.schedule(MIX, 2)
    key = lambda r: (r.index, r.new_tokens, r.greedy)  # noqa: E731
    assert [key(r) for r in a] == [key(r) for r in b]
    assert all(x.seed != y.seed for x, y in zip(a, b))


def test_schedule_shares_and_ranges():
    reqs = traffic.schedule(MIX, 3)
    assert all(16 <= r.new_tokens <= 128 for r in reqs)
    assert len({r.new_tokens for r in reqs}) > 20
    assert sum(r.greedy for r in reqs) == 50
    fixed = traffic.schedule({"requests": 5, "new_tokens": {"dist": "fixed", "value": 64}}, 1)
    assert all(r.new_tokens == 64 and not r.greedy for r in fixed)


def test_batches_and_adapters_from_seed():
    conf = cells.config_file("hov-solar-10.7b-int4")
    mix = {"batch": 2, "rows": 400, "frames": {"unique": 10}}
    (b1, e1), (b2, e2) = (batch(conf, mix, 9, 0, "cpu", torch.float32) for _ in range(2))
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert torch.equal(e1, e2)
    b3, _ = batch(conf, mix, 9, 1, "cpu", torch.float32)
    assert not torch.equal(b1["input_ids"], b3["input_ids"])  # rows differ step to step
    ids = b1["input_ids"]
    assert ids.shape == (2, 400 - 356 + 1)
    assert ((ids == 32100).sum(1) == 4).all() and (ids[:, 1] == -200).all()
    assert ((b1["labels"] != -100).sum(1) == 16).all()
    small = dict(conf, num_hidden_layers=1, hidden_size=64, intermediate_size=128,
                 num_attention_heads=4, num_key_value_heads=2)
    a, b = lora_start(small, 4, 5, "cpu"), lora_start(small, 4, 5, "cpu")
    assert all(torch.equal(a[t][0], b[t][0]) and not b[t][1].any() for t in a)


# -- spreads ------------------------------------------------------------------

def test_spread_is_quartile_distance_over_median():
    values = [10.0, 10.5, 11.0, 9.5, 10.2, 10.1]
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)


# -- device intervals ------------------------------------------------------------

def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.6)]
    assert union_length(iv) == pytest.approx(2.5)
    assert union_length(iv, 0.25, 2.5) == pytest.approx(1.75)
    assert merge(iv) == [(0.0, 1.5), (2.0, 3.0)]
    assert gaps(merge(iv), -1.0, 4.0) == [(-1.0, 0.0), (1.5, 2.0), (3.0, 4.0)]


def test_breakdown_names_gaps_by_innermost_host_op():
    s = TraceSummary(device_ops=[("k1", 0.0, 1.0), ("k2", 1.5, 2.0), ("k1", 2.0, 2.2)],
                     host_ops=[("outer", 0.0, 3.0), ("inner", 1.1, 1.4)],
                     window_s=3.0, busy_s=1.7, lo=0.0, hi=3.0)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(1.2)]
    assert b["idle_gaps"][0] == ["outer", pytest.approx(0.8)]
    assert b["idle_gaps"][1] == ["inner", pytest.approx(0.5)]


# -- roofline and MFU arithmetic -----------------------------------------------------

class _Run:
    def __init__(self, summary=None, work_=None, counters=None, seconds=10.0):
        self.slice = type("S", (), {"summary": summary})()
        self.work, self.counters, self.seconds = work_ or {}, counters or {}, seconds
        self.device, self.info = torch.device("cuda"), {}


def test_int4_matmul_work_by_hand():
    f, b = work.int4_matmul_work(2048, 4096, 4096)
    assert f == 2 * 2048 * 4096 * 4096
    assert b == 4096 * 4096 / 2 + 32 * 4096 * 4 + 2 * 2048 * (4096 + 4096)
    assert bound_s(f, b) == pytest.approx(f / BF16_FLOPS)  # compute-bound
    f1, b1 = work.int4_matmul_work(1, 4096, 4096)
    assert bound_s(f1, b1) == pytest.approx(b1 / HBM_BYTES_S)  # bandwidth-bound


def test_roofline_reader_by_hand():
    f, b = work.int4_matmul_work(4096, 4096, 14336)
    one = bound_s(f, b)
    s = TraceSummary([("void int4_prefill_kernel<4>", 0.0, 4 * one), ("other", 0.0, 1.0)],
                     [], 1.0, 1.0, 0.0, 1.0)
    run = _Run(s, {"int4_prefill": [(2, f, b)]})
    assert readers.roofline(run, "int4_prefill", ("int4_prefill_kernel",)) == pytest.approx(50.0)
    assert readers.roofline(_Run(s, {}), "int4_prefill", ("x",)) is None


def test_decode_attention_work_by_hand():
    cfg = cells.model_spec(cells.config_file("hov-mistral-7b")).cfg
    f, b = work.decode_attention_work(cfg, valid_keys=1000, rows=4, kv_bytes=2)
    assert f == 4 * 1000 * 32 * 128
    assert b == 2 * 1000 * 8 * 128 * 2 + 2 * 2 * 4 * 32 * 128


def test_model_flops_by_hand():
    cfg = cells.model_spec(cells.config_file("hov-mistral-7b")).cfg
    per_layer = 4096 * 48 * 128 + 4096 * 4096 + 3 * 4096 * 14336
    assert work.decoder_params(cfg) == 32 * per_layer
    assert work.head_params(cfg) == 32101 * 4096
    assert work.decode_token_flops(cfg, 10) == pytest.approx(
        2 * (32 * per_layer + 32101 * 4096) + 4 * 10 * 32 * 128 * 32)
    assert work.causal_attention_flops(cfg, 4) == 4 * 10 * 32 * 128 * 32
    run = _Run(counters={"flops": 0.5 * BF16_FLOPS * 10}, seconds=10.0)
    assert readers.mfu(run) == pytest.approx(50.0)
    solar = cells.model_spec(cells.config_file("hov-solar-10.7b-int4")).cfg
    step = work.qlora_step_flops(solar, 2, 2048, 128, 10)
    assert 1.8e14 < step < 2.1e14


def test_idle_from_union():
    s = TraceSummary([("a", 0.0, 1.0), ("b", 0.5, 1.5)], [], 4.0, 1.5, 0.0, 4.0)
    assert readers.idle_pct(_Run(s)) == pytest.approx(62.5)
    cpu = _Run(s)
    cpu.device = torch.device("cpu")
    assert readers.idle_pct(cpu) is None and readers.mfu(cpu) is None


# -- the manifest --------------------------------------------------------------------

def test_manifest_names_units_and_files():
    man = cells.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["name"] for w in man["workloads"]] + [c["name"] for c in man["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in man["workloads"]]:
        assert NAME.match(n), n
    cells_ = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells_
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells_)
        assert cells.metric_module(m["name"]).read
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in man["configs"]:
        assert (cells.REPO / c["file"]).exists() and c["file"].startswith("hov_bench/")
        assert cells.config_file(c["name"])["source"] == c["source"]
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cells.traffic_file(w["traffic"])
        assert cells.driver_module(cells.traffic_file(w["traffic"])["driver"]).Driver
    for c in cells_:
        reported = [m for m in man["end_to_end"] if c in m.get("workloads", cells_)]
        assert len(reported) >= 2


# -- imports --------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_anywhere_and_no_program_in_the_reference():
    forbidden = {"jax", "jaxlib", "flax", "handsonvlm_tpu"}
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        tops = set(_imports(f))
        assert not tops & forbidden, (f, tops & forbidden)
        if "reference" in f.relative_to(BENCH).parts:
            assert "handsonvlm_torch" not in tops, f
    # whole top-level names: the port's name begins with the JAX package's
    assert "handsonvlm_torch".split(".")[0] not in forbidden


def test_port_kernel_names_are_the_sources():
    import re as re_

    src = cells.REPO / "handsonvlm_torch" / "csrc"
    text = "".join(f.read_text() for f in sorted(src.glob("*.cu*")))
    names = set(re_.findall(
        r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?(\w+_kernel)\s*\(",
        text))
    assert names == set(readers.PORT_KERNELS)
