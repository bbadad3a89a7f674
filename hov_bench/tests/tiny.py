"""A tiny copy of the benchmark for the CPU tests: the cells of
BENCHMARK.json at tiny224 widths (2 decoder layers of
width 64, CLIP of width 32 at 224 px, so the 356 visual tokens and the EK
interface are real), float32, with mixes cut to a few requests."""

from __future__ import annotations

import json
from pathlib import Path

from hov_bench.core import cells

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2}
TINY_VISION = {"hidden_size": 32, "intermediate_size": 64, "num_layers": 2, "num_heads": 2}
TINY_TRAJ = {"hidden_dim": 32, "latent_dim": 16, "coord_dim": 8}
MIXES = {
    "ek100_eval_s32": {"slots": 4, "max_len": 1024, "chunk": 4, "clients": 8, "requests": 400,
                       "new_tokens": {"dist": "fixed", "value": 8}, "warm_tokens": 4,
                       "frames": {"unique": 10, "pool": 4}, "trace_slice_s": 0.5,
                       "check": {"requests": 2, "sampled": 1}},
    "qlora_2k": {"batch": 2, "rows": 400, "lora_r": 4, "lora_alpha": 8.0, "lr": 1e-3,
                 "trace_steps": 1},
}


def write(root: Path, workloads=None) -> Path:
    """The tiny benchmark under `root`; returns its manifest's path."""
    bench = cells.BENCH
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    man = cells.manifest()
    for c in man["configs"]:
        conf = cells.config_file(c["name"])
        conf.update(TINY)
        conf["handsonvlm"]["vision"].update(TINY_VISION)
        conf["handsonvlm"]["traj"].update(TINY_TRAJ)
        conf["handsonvlm"]["mm_hidden_size"] = TINY_VISION["hidden_size"]
        conf["handsonvlm"]["hand_share"] = 0.25  # short tiny answers still hold waypoints
        conf["precision"]["activations"] = "float32"
        (root / "configs" / f"{c['name']}.json").write_text(json.dumps(conf))
    for w in man["workloads"]:
        mix = cells.traffic_file(w["traffic"])
        mix.update(MIXES.get(w["traffic"], {}))
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        (root / "limits" / f"{w['name']}.json").write_text(
            (bench / "limits" / f"{w['name']}.json").read_text())
    if workloads is not None:
        man["workloads"] = [w for w in man["workloads"] if w["name"] in workloads]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(man))
    return path
