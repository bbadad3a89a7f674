"""HF state dict -> the port's modules.

The names are the reference checkpoint's (HandsOnVLMForCausalLM layout),
which `handsonvlm_tpu/convert/jax_to_hf.py` also writes. The port's module
tree uses the HF names below four prefixes, so loading is a prefix rename
and a copy. `from_jax_params` carries JAX parameters over through that
export: the bridge that lets both packages compute the same thing in tests.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# checkpoint prefix -> module prefix (first match wins)
PREFIXES = (
    ("model.vision_tower.vision_tower.vision_model.", "vision."),
    ("model.mm_projector.", "projector."),
    ("hand_traj_decoder.hand_traj_decoder.cvae.", "traj."),
    ("model.", "llama."),
    ("lm_head.", "llama.lm_head."),
)


def _module_name(key: str):
    for src, dst in PREFIXES:
        if key.startswith(src):
            return dst + key[len(src):]
    return None


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # exported JAX leaves are often transposed (or read-only) views: copy
    return torch.from_numpy(np.array(x, order="C"))


@torch.no_grad()
def load_state_dict_into(model: nn.Module, sd: Mapping[str, object]) -> None:
    """Copy an HF-named state dict into the model's parameters (cast to
    their dtype and device). Every parameter must be present; checkpoint
    entries the model does not hold (e.g. rotary buffers, CLIP's
    post_layernorm) are ignored, as the JAX converter ignores them."""
    by_name = {}
    for key, value in sd.items():
        name = _module_name(key)
        if name is not None:
            by_name[name] = value
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(by_name))
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")
    for name, p in params.items():
        t = _as_tensor(by_name[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"model shape {tuple(p.shape)}")
        p.copy_(t)


def from_jax_params(params, vocab_size: int = 32101) -> dict:
    """JAX HandsOnVLM parameters -> HF-named state dict of numpy arrays
    (through `handsonvlm_tpu.convert.jax_to_hf.export_handsonvlm`)."""
    from handsonvlm_tpu.convert.jax_to_hf import export_handsonvlm

    host = _to_numpy(params)
    return {k: np.ascontiguousarray(v) for k, v in
            export_handsonvlm(host, vocab_size=vocab_size).items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)
