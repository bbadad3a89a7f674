"""Readings that set the benchmark's limits, made once on the
card (the benchmark's own runs never make them).

    # the compared numbers of the program and of the control (the fp8
    # reference in the program's place) over several seeds, one process
    python3 hov_bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 8
    # the same with a fault planted in the program (core/faults.py)
    python3 hov_bench/calibrate.py --workload <name> --seeds 1,2,3 --control 0 --fault half_batch

Each seed prints one JSON line {"seed", "correct", "checks", "metrics"}.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hov_bench import run as harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    harness._cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if args.fault:
        from hov_bench.core.faults import FAULTS

        FAULTS[args.fault](setattr)
    for seed in [int(s) for s in args.seeds.split(",")]:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
        res = harness.run_cell(ns, dev, control=bool(args.control), out=sys.stderr)
        print(json.dumps({"seed": seed, "correct": res["correct"], "checks": res["checks"],
                          "metrics": res["metrics"], "peak": res["device"]["memory_peak_bytes"]},
                         default=float), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
