"""hoi-forecast weights into the port's HOI modules.

- `load_object_transformer`: the reference `hoi_forecast` ObjectTransformer
  state dict (hoi_forecast/model/modelio.py checkpoints) into
  `models.object_transformer.ObjectTransformer`, whose modules carry the
  reference's names: a copy by name below an optional prefix, with the
  rules of the JAX package's `convert/object_transformer.py`: a linear
  layer saved without its bias gets a zero bias, and the bias of a q / k /
  v projection or of an affordance fusion layer, which the model never
  reads, is not loaded.
- `from_jax_object_transformer`, `from_jax_lita_hoi` and
  `from_jax_hoi_encoder`: a JAX parameter tree (`init_object_transformer`,
  `init_lita_hoi`, `init_hoi_encoder`) -> a state dict under
  the port's module names, the bridge that lets both packages compute the
  same thing in tests. LITA-HOI's `llama` subtree goes through the decoder
  mapping of `convert.from_hf` (every decoder layout it takes).
  `load_named` copies such a state dict into a module.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from handsonvlm_torch.convert.from_hf import _CVAE_NAMES, _as_tensor, _llama_names, _module_name
from handsonvlm_torch.models.object_transformer import ObjectTransformer


@torch.no_grad()
def load_named(module: nn.Module, sd: Mapping[str, object]) -> None:
    """Copy a state dict under the module's own names into its parameters
    and buffers (cast to their dtype and device); every one must be there
    at its shape, and no name may be left over."""
    own = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"state dict lacks {missing[:5]} ({len(missing)}), "
                         f"holds unknown {extra[:5]} ({len(extra)})")
    for name, p in own.items():
        t = _as_tensor(sd[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
        p.copy_(t)


@torch.no_grad()
def load_object_transformer(model: ObjectTransformer, sd: Mapping, prefix: str = "") -> None:
    """The reference ObjectTransformer's weights (object_transformer.py:
    129-175, names below `prefix`) into `model`."""
    out: Dict[str, object] = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            key = prefix + name
            if key in sd:
                out[name] = sd[key]
            elif isinstance(mod, nn.Linear) and p_name == "bias":
                out[name] = torch.zeros(mod.out_features)
            else:
                raise KeyError(f"reference state dict lacks {key}")
    load_named(model, out)


# ---------------------------------------------------------------------------
# JAX trees -> the port's names
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _lin(sd: dict, name: str, p) -> None:
    sd[name + ".weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[name + ".bias"] = _np(p["bias"])


def _ln(sd: dict, name: str, p) -> None:
    sd[name + ".weight"] = _np(p["scale"])
    sd[name + ".bias"] = _np(p["bias"])


def _mha(sd: dict, name: str, p) -> None:
    for jax_key, port in (("wq", "proj_q"), ("wk", "proj_k"), ("wv", "proj_v")):
        sd[f"{name}.{port}.weight"] = _np(p[jax_key]["kernel"]).T
    _lin(sd, name + ".proj", p["proj"])


def _mlp(sd: dict, name: str, p) -> None:
    _lin(sd, name + ".fc1", p["fc1"])
    _lin(sd, name + ".fc2", p["fc2"])


def _cvae(sd: dict, name: str, p) -> None:
    for port, jax_key in _CVAE_NAMES:
        _lin(sd, f"{name}.{port}", p[jax_key])


def _decoder(sd: dict, name: str, p) -> None:
    _lin(sd, name + ".target_embedding", p["target_embedding"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{name}.decoder_blocks.{i}"
        _ln(sd, b + ".norm1", blk["norm1"])
        _mha(sd, b + ".self_attn", blk["self_attn"])
        _ln(sd, b + ".norm2", blk["norm2"])
        _mha(sd, b + ".enc_dec_attn", blk["cross_attn"])
        _ln(sd, b + ".norm3", blk["norm3"])
        _mlp(sd, b + ".mlp", blk["mlp"])
    _ln(sd, name + ".norm", p["norm"])


def _affordance(sd: dict, name: str, p) -> None:
    sd[name + ".traj_to_feature.0.weight"] = _np(p["traj_to_feature"]["kernel"]).T
    sd[name + ".traj_context_fusion.0.weight"] = _np(p["traj_context_fusion"]["kernel"]).T
    _cvae(sd, name + ".cvae", p["cvae"])


def _hoi_fusion(sd: dict, name: str, p) -> None:
    """downproject, bbox_to_feature (fc1, fc2) and feat_fusion."""
    _lin(sd, name + "downproject", p["downproject"])
    _lin(sd, name + "bbox_to_feature.0", p["bbox_to_feature"]["fc1"])
    _lin(sd, name + "bbox_to_feature.2", p["bbox_to_feature"]["fc2"])
    _lin(sd, name + "feat_fusion.0", p["feat_fusion"])


def _contiguous(sd: dict) -> Dict[str, np.ndarray]:
    return {k: np.require(v, requirements="C") for k, v in sd.items()}


def from_jax_hoi_encoder(params) -> Dict[str, np.ndarray]:
    """JAX `init_hoi_encoder` tree -> `models.visual_tokens.HoiEncoder` names."""
    sd: Dict[str, np.ndarray] = {}
    _hoi_fusion(sd, "", params)
    return _contiguous(sd)


def from_jax_object_transformer(params) -> Dict[str, np.ndarray]:
    """JAX `init_object_transformer` tree -> `ObjectTransformer` names."""
    sd: Dict[str, np.ndarray] = {}
    _hoi_fusion(sd, "", params)
    enc = params["encoder"]
    sd["oct_encoder.pos_embed"] = _np(enc["pos_embed"])
    for i, blk in enumerate(enc["blocks"]):
        b = f"oct_encoder.encoder_blocks.{i}"
        _ln(sd, b + ".norm1", blk["norm1"])
        _mha(sd, b + ".attn", blk["attn"])
        _ln(sd, b + ".norm2", blk["norm2"])
        _mlp(sd, b + ".mlp", blk["mlp"])
    _ln(sd, "oct_encoder.norm", enc["norm"])
    _decoder(sd, "oct_decoder", params["decoder"])
    _lin(sd, "last_obs_rhand_embedding_predictor", params["last_obs_rhand"])
    _lin(sd, "last_obs_lhand_embedding_predictor", params["last_obs_lhand"])
    _cvae(sd, "hand_head.cvae", params["hand_head"])
    _affordance(sd, "object_head", params["obj_head"])
    return _contiguous(sd)


def from_jax_lita_hoi(params, vocab_size: int = 32101) -> Dict[str, np.ndarray]:
    """JAX `init_lita_hoi` tree -> `models.lita_hoi.LitaHoi` names."""
    sd = {_module_name(k): v for k, v in _llama_names(params["llama"], vocab_size).items()}
    _hoi_fusion(sd, "hoi_encoder.", params["hoi_encoder"])
    _lin(sd, "projector", params["projector"])
    _decoder(sd, "oct_decoder", params["oct_decoder"])
    _cvae(sd, "hand_head.cvae", params["hand_head"])
    _affordance(sd, "affordance", params["affordance"])
    _lin(sd, "last_obs_rhand", params["last_obs_rhand"])
    _lin(sd, "last_obs_lhand", params["last_obs_lhand"])
    return _contiguous(sd)
