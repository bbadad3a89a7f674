"""Model loading: checkpoint -> (model, config, tokenizer).

Port of `handsonvlm_tpu/infer/builder.py` for these sources:
- `random:<preset>`: weights initialised directly on the target device in
  the preset's dtype from a seeded `torch.Generator` (the modules are built
  on the meta device first, so no host or fp32 copy of a 7B tree exists);
- an adapter directory the port's trainer writes (`core.checkpoint`
  artifacts): the projector-only adapter (`mm_projector`) grafted onto the
  base its `mm_projector.json` names, or a LoRA adapter (`lora` +
  `non_lora_trainables`) merged into the decoder of the base its
  `lora.json` names (the reference builder's mm_projector.bin and LoRA
  loads);
- a trainer `--output-dir` (the latest `checkpoints/<step>`'s model state)
  or a `save_params` export: the model is built in the layout the state
  names (dense or a quantized mode), with its LoRA adapters attached when
  it holds them;
- an HF HandsOnVLM checkpoint directory (`*.safetensors` or
  `pytorch_model*.bin`), the reference's names.

`quantize="int4"` (models/llama.quantize_llama_int4) or `"int8"`
(models/llama.quantize_llama) quantizes the decoder, `"int8_fused"` as
"int8" and then routes the projections through the fused QLoRA kernels: a
random model is initialised in its dtype on the device and quantized there
layer by layer, each dense projection freed as soon as it is quantized; a
checkpoint is loaded and quantized on the CPU, and only the quantized model
moves to the device. (The JAX package draws a random int8 or int4 model
directly, `init_llama_int8`, for its TPU allocator, which never returns
freed device memory; the card's allocator does.)

The port reads its own checkpoint format, not Orbax: JAX-trained weights
cross over as the HF-layout state dict.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional, Tuple

import torch

from handsonvlm_torch.config import HandsOnVLMConfig, get_config
from handsonvlm_torch.convert.from_hf import load_state_dict_into, quantize_mode
from handsonvlm_torch.core.checkpoint import (
    has_artifact,
    is_params_export,
    is_trainer_output,
    restore_artifact,
    restore_params,
)
from handsonvlm_torch.models.handsonvlm import HandsOnVLM
from handsonvlm_torch.models.llama import quantize_llama, quantize_llama_int4
from handsonvlm_torch.models.lora import LoRA, merge_lora

RANDOM_SEED = 0
QUANTIZE = (None, "int4", "int8", "int8_fused")
# a mode -> the weight layout its state dict holds, where the two differ
LAYOUT = {"int8_fused": "int8"}


def load_tokenizer(model_path: Optional[str], model_max_length: int = 2048):
    if model_path and os.path.exists(os.path.join(model_path, "tokenizer.model")):
        from handsonvlm_torch.data.tokenization import HFTokenizer

        return HFTokenizer(model_path, model_max_length)
    from handsonvlm_torch.data.mock_tokenizer import MockTokenizer

    return MockTokenizer(model_max_length)


def load_hf_state_dict(path: str) -> dict:
    """A (possibly sharded) HF checkpoint directory -> {name: tensor} on the CPU."""
    safes = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    sd = {}
    if safes:
        from safetensors.torch import load_file

        for f in safes:
            sd.update(load_file(f))
        return sd
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    for f in bins:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def build_model(cfg: HandsOnVLMConfig, device, quantize: Optional[str] = None) -> HandsOnVLM:
    """Allocate the model on `device` in cfg.pdtype, uninitialised (with a
    `quantize` mode: in its layout, to load a quantized state dict)."""
    with torch.device("meta"):
        model = HandsOnVLM(cfg, quantize=quantize)
    return model.to_empty(device=device).requires_grad_(False).eval()


def quantize_model(model: HandsOnVLM, cfg: HandsOnVLMConfig, quantize: Optional[str]) -> None:
    """Quantize a dense decoder in place into `quantize`'s layout."""
    if quantize == "int4":
        quantize_llama_int4(model.llama, cfg.llama)
    elif quantize in ("int8", "int8_fused"):
        quantize_llama(model.llama, cfg.llama, quantize)
    if quantize and next(model.parameters()).is_cuda:
        torch.cuda.empty_cache()


def lora_from_state(cfg: HandsOnVLMConfig, sd: dict, prefix: str = "") -> LoRA:
    """A `LoRA` module holding the adapters of a saved state dict (its rank
    and targets from the shapes and names, alpha from the saved scale)."""
    targets = sorted({k[len(prefix):].split(".")[1] for k in sd
                      if k.startswith(prefix + "adapters.")})
    r = sd[f"{prefix}adapters.{targets[0]}.a"].shape[-1]
    scale = float(sd[prefix + "scale"])
    lora = LoRA(cfg.llama, r=r, alpha=scale * r, targets=targets)
    lora.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return lora


def _load_adapter_checkpoint(model_path: str, preset: str, device, quantize):
    """Adapter-only artifacts of the trainer's --tune-mm-mlp-adapter and
    --lora-r runs, grafted onto (projector) or merged into (LoRA) the base
    their `.json` metadata names (the reference builder's mm_projector.bin
    and base + non_lora_trainables + merge loads)."""
    kind = "lora" if has_artifact(model_path, "lora") else "mm_projector"
    meta_path = os.path.join(model_path, kind + ".json")
    if not os.path.exists(meta_path):
        raise ValueError(
            f"{model_path} holds a '{kind}' adapter but no {kind}.json metadata "
            "naming its base checkpoint; re-save with the trainer or write "
            '{"base": <path>, "preset": <preset>} alongside it')
    with open(meta_path) as f:
        meta = json.load(f)
    model, cfg, tokenizer = load_pretrained_model(meta["base"], meta.get("preset", preset),
                                                  device)
    if kind == "mm_projector":
        model.projector.load_state_dict(restore_artifact(model_path, "mm_projector"))
    else:
        extra = restore_artifact(model_path, "non_lora_trainables")
        model.projector.load_state_dict(extra["projector"])
        model.traj.load_state_dict(extra["traj"])
        merge_lora(model.llama, lora_from_state(cfg, restore_artifact(model_path, "lora")).to(
            model.llama.embed_tokens.weight.device))
    quantize_model(model, cfg, quantize)
    return model, cfg, tokenizer


def _load_saved_state(model_path: str, cfg, device, quantize):
    """A trainer output directory or a params export: the model in the
    layout its state names, its adapters attached when it holds them; an
    int8 state under `quantize="int8_fused"` takes the fused route (the
    state holds the layout, the caller picks the route)."""
    sd = restore_params(model_path)
    mode = quantize_mode(sd, prefix="llama.")
    if mode is not None and quantize is not None:
        if LAYOUT.get(quantize, quantize) != mode:
            raise ValueError(f"{model_path} holds a {mode} decoder, not {quantize}")
        mode = quantize
    model = build_model(cfg, "cpu", quantize=mode)
    if "lora.scale" in sd:
        model.lora = lora_from_state(cfg, sd, prefix="lora.")
    model.load_state_dict(sd)
    if mode is None:
        quantize_model(model, cfg, quantize)
    return model.to(device).requires_grad_(False)


def load_pretrained_model(
    model_path: str, preset: str = "7b", device="cuda", quantize: Optional[str] = None,
) -> Tuple[HandsOnVLM, HandsOnVLMConfig, object]:
    """Returns (model, cfg, tokenizer) with the model on `device`;
    `quantize="int4"`, `"int8"` or `"int8_fused"` gives the decoder int4 or
    int8 weights and an int8 head."""
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize mode {quantize!r} (int4, int8 or int8_fused)")
    cfg = get_config(preset)
    # the released checkpoints always ship the CVAE head
    cfg = dataclasses.replace(cfg, traj=dataclasses.replace(cfg.traj, kind="CVAE"))
    device = torch.device(device)
    if model_path.startswith("random:"):
        model = build_model(cfg, device)
        generator = torch.Generator(device=device).manual_seed(RANDOM_SEED)
        model.init_weights(generator)
        quantize_model(model, cfg, quantize)
        return model, cfg, load_tokenizer(None)
    if not os.path.isdir(model_path):
        raise FileNotFoundError(
            f"{model_path}: expected random:<preset>, a checkpoint directory of the port's "
            "trainer or an HF checkpoint directory")
    if has_artifact(model_path, "mm_projector") or has_artifact(model_path, "lora"):
        return _load_adapter_checkpoint(model_path, preset, device, quantize)
    if is_params_export(model_path) or is_trainer_output(model_path):
        return (_load_saved_state(model_path, cfg, device, quantize), cfg,
                load_tokenizer(model_path))
    model = build_model(cfg, "cpu" if quantize else device)
    load_state_dict_into(model, load_hf_state_dict(model_path))
    if quantize:
        quantize_model(model, cfg, quantize)
        model = model.to(device)
    return model, cfg, load_tokenizer(model_path)
