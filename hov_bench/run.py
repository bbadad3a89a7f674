"""Run one cell of the port's benchmark once.

    python3 hov_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json at the repository root, its
configuration from hov_bench/configs/, its traffic mix from
hov_bench/traffic/ (whose `driver` names hov_bench/drivers/<driver>.py), its
limits from hov_bench/limits/, and each per-layer metric's reader from
hov_bench/metrics/. Needs the card: without CUDA, or with fewer cards than
the cell asks for, it exits with 2 and prints no result.

`--trace 0` reports the cell's end-to-end metrics; `--trace 1` traces a
slice in the middle of the window and reports its per-layer metrics. After
the window the output check replays a sample of what the timed path
produced through the plain fp32 reference (hov_bench/reference/) and
compares each number with its limit. The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 breakdown), and last `checks`, each number beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "handsonvlm_tpu")


def _cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries that would load JAX by themselves are told not to."""
    cache = REPO / "build" / "hov_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")


@dataclasses.dataclass
class Run:
    """One run's state, which the driver fills and the readers read."""

    workload: dict
    spec: object
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    slice_s: float
    slice: object
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    e2e: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_closed: Optional[float] = None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(args, device, manifest_path=None, control: bool = False, out=None) -> dict:
    """The whole run on `device`, after the look for a card: set-up, the
    window, the readers, the check. Returns the result object."""
    import torch

    from hov_bench.core import cells, peaks
    from hov_bench.core.trace import Slice

    man = cells.manifest(manifest_path)
    wl = cells.workload(man, args.workload)
    conf = cells.config_file(wl["config"])
    spec = cells.model_spec(conf)
    mix = cells.traffic_file(wl["traffic"])
    limits = cells.limits_file(wl["name"])
    run = Run(workload=wl, spec=spec, mix=mix, seed=args.seed, seconds=float(args.seconds),
              trace=bool(args.trace), device=device, slice_s=float(mix.get("trace_slice_s", 3)),
              slice=Slice())
    driver = cells.driver_module(mix["driver"]).Driver(run)
    on_card = device.type == "cuda"
    if on_card:
        from handsonvlm_torch.ops._build import library_path, load_library

        built = library_path().exists()
        t = time.perf_counter()
        load_library()
        run.info["build_s"] = 0.0 if built else time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    if run.trace:
        run.slice.prime()
    if on_card:
        torch.cuda.synchronize()
    # a checkout's first run builds the kernel library: recorded apart
    setup_s = time.perf_counter() - T_START - run.info.get("build_s", 0.0)
    driver.window()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded in the run: {bad}")

    e2e = {m["name"]: m for m in man["end_to_end"]}

    def applies(m) -> bool:  # a per-layer metric without `workloads` follows its `moves`
        return wl["name"] in m.get("workloads", e2e.get(m.get("moves"), {}).get(
            "workloads", [wl["name"]]))

    metrics = {}
    for m in man["per_layer"] if run.trace else man["end_to_end"]:
        if not applies(m):
            continue
        if run.trace:
            value = cells.metric_module(m["name"]).read(run)
        else:
            value = setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    nums = driver.check(conf, control=control)
    run.info["check_s"] = time.perf_counter() - t_check
    run.info["window_s"] = ((run.window_closed or t_check) - T_START - setup_s
                            - run.info.get("build_s", 0.0))
    # nothing checked (no finished request to sample) is not correct
    checks, correct = {}, run.failed == 0 and run.attempted > 0 and bool(nums)
    for k, value in nums.items():
        limit = limits.get(k)
        checks[k] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            correct = False
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(wl["chips"]) if on_card else 1,
                   "memory_peak_bytes": int(peak),
                   "power_limit_w": peaks.power_limit_w() if on_card else None}
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if run.trace and run.slice.summary is not None:
        s = run.slice.summary
        device_info["busy_s"], device_info["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = s.breakdown()
    result["checks"] = checks
    info = dict(run.info, setup_s=setup_s, seed=args.seed, workload=wl["name"])
    print(json.dumps({"info": info}), file=out or sys.stdout)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    import torch

    from hov_bench.core import cells

    wl = cells.workload(cells.manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args, torch.device("cuda"))
    if forbidden_modules():
        print(f"forbidden modules loaded: {forbidden_modules()}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
