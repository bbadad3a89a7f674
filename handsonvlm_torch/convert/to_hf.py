"""The port's model -> an HF state dict and checkpoint.

Port of `handsonvlm_tpu/convert/jax_to_hf.py`: the reference checkpoint
naming (the HandsOnVLMForCausalLM layout), so a model trained here loads
in the reference code, in the JAX package (`convert/hf_to_jax.py`) or back
in the port (`infer.builder.load_pretrained_model` reads the directory
`save_hf_checkpoint` writes). The port's modules already carry the HF
names below four prefixes (`convert.from_hf.PREFIXES`), so an export is
their inverse rename; tensors come out on the host in f32, as the JAX
exporter writes them. A quantized decoder has no HF layout: export the
dense model.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

CLIP_PREFIX = "model.vision_tower.vision_tower.vision_model."
CVAE_PREFIX = "hand_traj_decoder.hand_traj_decoder.cvae."


def _export(module: nn.Module, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in module.state_dict().items()}


def export_llama(llama: nn.Module, prefix: str = "model.",
                 vocab_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The decoder (a dense `models.llama.Llama`) under `prefix`, its head
    as `lm_head.weight`; the vocab cut to `vocab_size` when given."""
    if getattr(llama, "int4", None) is not None or getattr(llama, "proj", None) is not None:
        raise ValueError("export_llama takes a dense decoder: the quantized layouts have no "
                         "HF names")
    sd = {}
    for k, v in _export(llama, "").items():
        if k.startswith("lm_head."):
            sd[k] = v
        else:
            sd[prefix + k] = v
    v = vocab_size if vocab_size is not None else sd[prefix + "embed_tokens.weight"].shape[0]
    sd[prefix + "embed_tokens.weight"] = sd[prefix + "embed_tokens.weight"][:v].contiguous()
    if "lm_head.weight" in sd:
        sd["lm_head.weight"] = sd["lm_head.weight"][:v].contiguous()
    return sd


def export_clip_vision(vision: nn.Module, prefix: str = "vision_model.") -> Dict[str, torch.Tensor]:
    return _export(vision, prefix)


def export_handsonvlm(model: nn.Module, vocab_size: int = 32101) -> Dict[str, torch.Tensor]:
    """A `models.handsonvlm.HandsOnVLM` under the reference's names."""
    sd = export_llama(model.llama, vocab_size=vocab_size)
    sd.update(_export(model.projector, "model.mm_projector."))
    if getattr(model, "vision", None) is not None:
        sd.update(export_clip_vision(model.vision, CLIP_PREFIX))
    sd.update(_export(model.traj, CVAE_PREFIX))
    return sd


def save_hf_checkpoint(model: nn.Module, out_dir: str) -> str:
    """Write `<out_dir>/model.safetensors`; returns its path."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.safetensors")
    save_file(export_handsonvlm(model), path)
    return path
