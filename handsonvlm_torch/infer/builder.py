"""Model loading: checkpoint -> (model, config, tokenizer).

Port of `handsonvlm_tpu/infer/builder.py` for two sources:
- `random:<preset>`: weights initialised directly on the target device in
  the preset's dtype from a seeded `torch.Generator` (the modules are built
  on the meta device first, so no host or fp32 copy of a 7B tree exists);
- an HF HandsOnVLM checkpoint directory (`*.safetensors` or
  `pytorch_model*.bin`), the reference's names.

`quantize="int4"` (models/llama.quantize_llama_int4) or `"int8"`
(models/llama.quantize_llama) quantizes the decoder: a random model is
initialised in its dtype on the device and quantized there layer by layer,
each dense projection freed as soon as it is quantized; a checkpoint is
loaded and quantized on the CPU, and only the quantized model moves to the
device. (The JAX package draws a random int8 or int4 model directly,
`init_llama_int8`, for its TPU allocator, which never returns freed device
memory; the card's allocator does.)

Orbax and adapter directories are read by the JAX package only.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Tuple

import torch

from handsonvlm_torch.config import HandsOnVLMConfig, get_config
from handsonvlm_torch.convert.from_hf import load_state_dict_into
from handsonvlm_torch.models.handsonvlm import HandsOnVLM
from handsonvlm_torch.models.llama import quantize_llama, quantize_llama_int4

RANDOM_SEED = 0
QUANTIZERS = {"int4": quantize_llama_int4, "int8": quantize_llama}


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


def load_pretrained_model(
    model_path: str, preset: str = "7b", device="cuda", quantize: Optional[str] = None,
) -> Tuple[HandsOnVLM, HandsOnVLMConfig, object]:
    """Returns (model, cfg, tokenizer) with the model on `device`;
    `quantize="int4"` or `"int8"` gives the decoder int4 or int8 weights
    and an int8 head."""
    if quantize not in (None, *QUANTIZERS):
        raise ValueError(f"unknown quantize mode {quantize!r} (int4 or int8)")
    cfg = get_config(preset)
    # the released checkpoints always ship the CVAE head
    cfg = dataclasses.replace(cfg, traj=dataclasses.replace(cfg.traj, kind="CVAE"))
    device = torch.device(device)
    if model_path.startswith("random:"):
        model = build_model(cfg, device)
        generator = torch.Generator(device=device).manual_seed(RANDOM_SEED)
        model.init_weights(generator)
        if quantize:
            QUANTIZERS[quantize](model.llama, cfg.llama)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return model, cfg, load_tokenizer(None)
    if not os.path.isdir(model_path):
        raise FileNotFoundError(
            f"{model_path}: expected random:<preset> or an HF checkpoint directory")
    model = build_model(cfg, "cpu" if quantize else device)
    load_state_dict_into(model, load_hf_state_dict(model_path))
    if quantize:
        QUANTIZERS[quantize](model.llama, cfg.llama)
        model = model.to(device)
    return model, cfg, load_tokenizer(model_path)
