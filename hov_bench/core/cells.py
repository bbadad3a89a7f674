"""Find a cell's pieces by name: the manifest entry, its configuration,
its traffic mix and its limits.

Everything a cell needs sits in files of its own, found from the names in
`BENCHMARK.json`:

- `hov_bench/configs/<config>.json`: the model configuration as it is run;
- `hov_bench/traffic/<traffic>.json`: the traffic mix, whose `driver` key
  names `hov_bench/drivers/<driver>.py`;
- `hov_bench/limits/<workload>.json`: the limits of the numbers that
  decide `correct`;
- `hov_bench/metrics/<metric>.py`: the reader of a per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Optional[Path] = None) -> dict:
    return read_json(path or REPO / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def limits_file(name: str) -> dict:
    path = BENCH / "limits" / f"{name}.json"
    return read_json(path) if path.exists() else {}


def driver_module(kind: str):
    return importlib.import_module(f"hov_bench.drivers.{kind}")


def metric_module(name: str):
    """The reader of a per-layer metric: `metrics/<name>.py`, the dots of
    the name turned into underscores (`idle_pct.eval` -> `idle_pct_eval`)."""
    return importlib.import_module(f"hov_bench.metrics.{name.replace('.', '_')}")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A configuration file read into what the harness and the reference
    need: the program's config, the weight layout and the steering."""

    name: str
    cfg: object  # handsonvlm_torch.config.HandsOnVLMConfig
    quantize: Optional[str]  # None (dense) or "int4"
    kv_quant: Optional[str]  # None or "int8"
    hand_share: float  # share of generated tokens that are <hand_traj>
    raw: dict


def model_spec(conf: dict) -> ModelSpec:
    """A configuration file -> the program's `HandsOnVLMConfig` (built from
    the file's widths, with no preset) and the run's precision."""
    from handsonvlm_torch.config import (
        ClipVisionConfig,
        HandsOnVLMConfig,
        LlamaConfig,
        TrajDecoderConfig,
    )

    hv = conf["handsonvlm"]
    vis, traj = hv["vision"], hv["traj"]
    prec = conf["precision"]
    heads = conf["num_attention_heads"]
    llama = LlamaConfig(
        vocab_size=conf["vocab_size"] + hv["added_tokens"],
        hidden_size=conf["hidden_size"],
        intermediate_size=conf["intermediate_size"],
        num_layers=conf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        max_position_embeddings=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]),
        rms_norm_eps=float(conf["rms_norm_eps"]),
        tie_word_embeddings=bool(conf["tie_word_embeddings"]),
    )
    vision = ClipVisionConfig(
        hidden_size=vis["hidden_size"], intermediate_size=vis["intermediate_size"],
        num_layers=vis["num_layers"], num_heads=vis["num_heads"],
        image_size=vis["image_size"], patch_size=vis["patch_size"],
        layer_norm_eps=float(vis["layer_norm_eps"]), select_layer=vis["select_layer"])
    cfg = HandsOnVLMConfig(
        llama=llama, vision=vision,
        traj=TrajDecoderConfig(hidden_dim=traj["hidden_dim"], latent_dim=traj["latent_dim"],
                               coord_dim=traj["coord_dim"], z_scale=float(traj["z_scale"])),
        num_frames=hv["num_frames"], video_arch=hv["video_arch"],
        mm_hidden_size=hv["mm_hidden_size"], hand_token_id=hv["hand_token_id"],
        max_length=hv["max_length"], lambda_traj=float(hv["loss"]["lambda_traj"]),
        lambda_traj_kl=float(hv["loss"]["lambda_traj_kl"]),
        hoi_lambda=float(hv["loss"]["hoi_lambda"]), param_dtype=prec["activations"],
        compute_dtype=prec["activations"])
    return ModelSpec(name=conf["name"], cfg=cfg, quantize=prec.get("quantize"),
                     kv_quant=prec.get("kv_cache_quant"), hand_share=float(hv["hand_share"]),
                     raw=conf)
