"""Checkpoints of the train state, parameter exports and adapter artifacts.

Port of `handsonvlm_tpu/core/checkpoint.py` on `torch.save` /
`torch.load(weights_only=True)` in place of Orbax, with its functions,
directory layout and return values:

- `save_train_state(ckpt_dir, state, step)` writes `<ckpt_dir>/<step>/`:
  `model.pt` (the model's state dict: every parameter and buffer, the
  frozen base included, as the JAX package saves every parameter),
  `optimizer.pt` (the optimizer's state: `AdamW.state_dict()`) and
  `step.json`. The directory is written under a temporary name and renamed,
  so a crash leaves no half-written step; the oldest steps beyond
  `max_to_keep` are removed. `restore_train_state(ckpt_dir, template)`
  loads the latest (or a given) step into the template state's model and
  optimizer in place (dtypes and devices the template's) and returns it,
  or None when nothing is there. `latest_step` reads the step directories.
- `save_params` / `restore_params`: a parameters-only export
  (`<dir>/params/params.pt`), or the latest checkpoint's `model.pt` of a
  trainer output directory (`<dir>/checkpoints/<step>/`), read without the
  optimizer's state (the JAX package's partial restore).
- `save_artifact(out_dir, name, tree, meta)` writes a partial-parameter
  artifact, `<out_dir>/<name>/tree.pt` (a dict of tensors, possibly nested)
  and the metadata `<out_dir>/<name>.json`, overwriting an earlier one;
  `restore_artifact`, `has_artifact`, `is_params_export` and
  `is_trainer_output` as in the JAX package.

Tensors are loaded memory-mapped on the CPU and copied into the template's
tensors, so a 7B restore does not hold a second copy on the card. The port
reads its own format, not Orbax: JAX-trained weights cross over as the
HF-layout state dict (`convert.from_hf`).

A model sharded over ranks (`parallel/partition.shard_model`, its decoder
and adapters cut over a model axis first or not: `parallel/tp.py`) saves
and restores the same files: every rank gathers the whole state dicts
(the FSDP shards over 'data', the model slices and their Adam moments
over 'model'), the first rank writes them, and at a restore each rank
reads them and keeps its slices and shards, so a checkpoint of N ranks,
whatever their mesh, resumes in one and the other way round.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

MODEL_FILE, OPTIMIZER_FILE, STEP_FILE = "model.pt", "optimizer.pt", "step.json"
PARAMS_DIR, PARAMS_FILE, TREE_FILE = "params", "params.pt", "tree.pt"


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _replace_dir(tmp: str, final: str) -> None:
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d)]
    return max(steps) if steps else None


def save_train_state(ckpt_dir: str, state, step: int, max_to_keep: int = 100) -> int:
    """Write the state's model, optimizer and step under `<ckpt_dir>/<step>/`;
    returns the bytes written."""
    from handsonvlm_torch.parallel.partition import full_state_dict, is_sharded

    sharded = is_sharded(state.model)
    model_state = full_state_dict(state.model) if sharded else state.model.state_dict()
    optimizer_state = state.optimizer.state_dict()
    if sharded and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()  # the first rank writes
        return 0
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(int(step)))
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(model_state, os.path.join(tmp, MODEL_FILE))
    torch.save(optimizer_state, os.path.join(tmp, OPTIMIZER_FILE))
    with open(os.path.join(tmp, STEP_FILE), "w") as f:
        json.dump({"step": int(state.step)}, f)
    nbytes = sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp))
    _replace_dir(tmp, final)
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d))
    for old in steps[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    if sharded:
        torch.distributed.barrier()
    return nbytes


def restore_train_state(ckpt_dir: str, template_state, step: Optional[int] = None):
    """Load a saved step (the latest by default) into the template state's
    model and optimizer, in place; returns the state, or None when the
    directory holds no step (auto-resume)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    from handsonvlm_torch.parallel.partition import is_sharded, load_full_state_dict

    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    model_state = _load(os.path.join(path, MODEL_FILE))
    if is_sharded(template_state.model):
        load_full_state_dict(template_state.model, model_state)
    else:
        template_state.model.load_state_dict(model_state)
    template_state.optimizer.load_state_dict(_load(os.path.join(path, OPTIMIZER_FILE)))
    with open(os.path.join(path, STEP_FILE)) as f:
        template_state.step = int(json.load(f)["step"])
    return template_state


def save_params(ckpt_dir: str, params: dict) -> None:
    """Parameters-only export (a deploy artifact): a state dict."""
    path = os.path.join(os.path.abspath(ckpt_dir), PARAMS_DIR)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{PARAMS_FILE}.tmp-{os.getpid()}")
    torch.save(params, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))


def save_artifact(out_dir: str, name: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Save a partial-parameter artifact (adapter-style checkpoint), the
    reference's `mm_projector.bin` and LoRA `non_lora_trainables.bin`, over
    any earlier one of the name; `meta` lands in `<out_dir>/<name>.json`
    (e.g. the base checkpoint the adapter belongs to)."""
    final = os.path.join(os.path.abspath(out_dir), name)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(tree, os.path.join(tmp, TREE_FILE))
    _replace_dir(tmp, final)
    if meta is not None:
        with open(final + ".json", "w") as f:
            json.dump(meta, f)


def restore_artifact(out_dir: str, name: str) -> Any:
    return _load(os.path.join(os.path.abspath(out_dir), name, TREE_FILE))


def has_artifact(out_dir: str, name: str) -> bool:
    return os.path.isdir(os.path.join(os.path.abspath(out_dir), name))


def is_params_export(ckpt_dir: str) -> bool:
    """True for a save_params export dir (<dir>/params/params.pt)."""
    return os.path.exists(os.path.join(ckpt_dir, PARAMS_DIR, PARAMS_FILE))


def is_trainer_output(ckpt_dir: str) -> bool:
    """True for a trainer --output-dir (<dir>/checkpoints/<step> states)."""
    return latest_step(os.path.join(ckpt_dir, "checkpoints")) is not None


def restore_params(ckpt_dir: str, dtype=None) -> dict:
    """The parameters of a save_params export, or of a trainer output
    directory's latest checkpoint (its model state alone, not the
    optimizer's); floating tensors cast to `dtype` when given."""
    if is_params_export(ckpt_dir):
        params = _load(os.path.join(os.path.abspath(ckpt_dir), PARAMS_DIR, PARAMS_FILE))
    else:
        cdir = os.path.join(os.path.abspath(ckpt_dir), "checkpoints")
        step = latest_step(cdir)
        if step is None:
            raise ValueError(f"no params export or checkpoints in {ckpt_dir}")
        params = _load(os.path.join(cdir, str(step), MODEL_FILE))
    if dtype is not None:
        params = {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
    return params
