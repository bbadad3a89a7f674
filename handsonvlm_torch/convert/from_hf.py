"""HF state dict -> the port's modules, and JAX parameters -> HF names.

The names are the reference checkpoint's (HandsOnVLMForCausalLM layout),
which the JAX package's exporter (`convert/jax_to_hf.py`) also writes. The
port's module tree uses the HF names below four prefixes, so loading is a
prefix rename and a copy.

`from_jax_params` maps a JAX parameter tree (a nested dict of arrays) to
that naming itself, with the JAX exporter's mapping: the bridge that lets
both packages compute the same thing in tests. It takes every decoder
layout the JAX package's `apply_llama` takes; the quantized ones keep their
bytes, stacked over layers, and load into a model built with the
`quantize` mode `quantize_mode` names:
- dense projections -> `model.layers.<i>.*_proj.weight` (None);
- fused int4 under `layers["int4"]` (`quantize_llama_int4`,
  `init_llama_int4`): tiled `w4t`/`gst` -> `model.int4.<name>.{w4t,gst}`
  ("int4"), flat `w4`/`gscale` -> `model.int4.<name>.{w4,gscale}`
  ("int4_flat");
- per-projection leaves under `layers["attn"]` / `layers["mlp"]`: int8
  `w8`/`scale` (`quantize_llama`, `init_llama_int8`) ->
  `model.proj.<name>.{w8,scale}` ("int8"), flat int4 `w4`/`gscale` ->
  `model.proj.<name>.{w4,gscale}` ("int4_proj");
- the fused-QLoRA stack under `layers["int8"]` (`stack_llama_int8`: the
  seven int8 `w8`/`scale` leaves) -> `model.proj.<name>.{w8,scale}`, the
  "int8" layout; the caller builds the model with `quantize="int8_fused"`
  to run it through the fused route, as the JAX package's `apply_llama`
  does with that tree;
- an int8 head `w8`/`scale` -> `lm_head.{w8,scale}` (transposed to (V, d),
  the vocab cut to `vocab_size`);
- LoRA adapters under `params["lora"]` (`init_lora`) ->
  `lora.adapters.<target>.{a,b}` in the JAX layout and `lora.scale`, which
  load into a model whose `lora` is a `models.lora.LoRA` of that rank.
Any other decoder leaf is refused.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
    ("lora.", "lora."),
)


# JAX dense decoder layer leaf -> HF name below model.layers.<i>.
_LLAMA_NAMES = {
    "self_attn.q_proj": ("attn", "wq"), "self_attn.k_proj": ("attn", "wk"),
    "self_attn.v_proj": ("attn", "wv"), "self_attn.o_proj": ("attn", "wo"),
    "mlp.gate_proj": ("mlp", "w_gate"), "mlp.up_proj": ("mlp", "w_up"),
    "mlp.down_proj": ("mlp", "w_down"),
}
# JAX CLIP layer leaf -> HF name below encoder.layers.<i>.
_CLIP_NAMES = {
    "self_attn.q_proj": ("attn", "wq"), "self_attn.k_proj": ("attn", "wk"),
    "self_attn.v_proj": ("attn", "wv"), "self_attn.out_proj": ("attn", "wo"),
    "mlp.fc1": ("mlp", "fc1"), "mlp.fc2": ("mlp", "fc2"),
}
# JAX CVAE leaf -> HF name below hand_traj_decoder.hand_traj_decoder.cvae.
_CVAE_NAMES = (("enc_MLP.0", "enc"), ("linear_means", "mean"),
               ("linear_log_var", "log_var"), ("dec_MLP.0", "dec1"), ("dec_MLP.2", "dec2"))


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
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    missing = sorted(set(params) - set(by_name))
    if missing:
        raise ValueError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")
    for name, p in params.items():
        t = _as_tensor(by_name[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"model shape {tuple(p.shape)}")
        p.copy_(t)


def _np(x) -> np.ndarray:
    """A leaf on the host: floats as f32 (bf16 has no numpy type), integer
    (quantized) leaves unchanged."""
    a = np.asarray(x)
    return a if a.dtype.kind in "iub" else a.astype(np.float32)


# the buffers of each quantized leaf, by the leaf's keys
_QUANT_LEAVES = ({"w4t", "gst"}, {"w4", "gscale"}, {"w8", "scale"})


def _quant_leaf(where: str, leaf) -> Dict[str, np.ndarray]:
    if not isinstance(leaf, Mapping) or set(leaf) not in _QUANT_LEAVES:
        keys = sorted(leaf) if isinstance(leaf, Mapping) else type(leaf).__name__
        raise ValueError(f"{where}: no known weight layout (keys {keys}); the port takes "
                         f"dense arrays or the leaves {[sorted(k) for k in _QUANT_LEAVES]}")
    return {f"{where}.{key}": _np(value) for key, value in leaf.items()}


def _llama_names(p, vocab_size: int, prefix: str = "model.") -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    # the JAX package may pad the vocab for its sharding layout: cut it
    sd[prefix + "embed_tokens.weight"] = _np(p["embed"]["weight"])[:vocab_size]
    layers = p["layers"]
    unknown = sorted(set(layers) - {"attn", "mlp", "int4", "int8", "attn_norm", "mlp_norm"})
    if unknown:
        raise ValueError(f"decoder layers {unknown}: no known weight layout")
    if "int8" in layers and {"attn", "mlp", "int4"} & set(layers):
        raise ValueError("decoder layers mix the fused int8 stack with other projections: "
                         "no known weight layout")
    L = layers["attn_norm"]["scale"].shape[0]
    for i in range(L):
        lp = prefix + f"layers.{i}."
        for hf, (grp, key) in _LLAMA_NAMES.items():
            if grp in layers and not isinstance(layers[grp][key], Mapping):
                sd[lp + hf + ".weight"] = _np(layers[grp][key][i]).T
        sd[lp + "input_layernorm.weight"] = _np(layers["attn_norm"]["scale"][i])
        sd[lp + "post_attention_layernorm.weight"] = _np(layers["mlp_norm"]["scale"][i])
    for grp, key in _LLAMA_NAMES.values():
        if grp in layers and isinstance(layers[grp][key], Mapping):
            sd.update(_quant_leaf(prefix + f"proj.{key}", layers[grp][key]))
    for name, leaf in layers.get("int4", {}).items():
        sd.update(_quant_leaf(prefix + f"int4.{name}", leaf))
    for name, leaf in layers.get("int8", {}).items():
        if not isinstance(leaf, Mapping) or set(leaf) != {"w8", "scale"}:
            raise ValueError(f"int8/{name}: no known weight layout (the fused stack holds "
                             f"int8 w8 / scale leaves)")
        sd.update(_quant_leaf(prefix + f"proj.{name}", leaf))
    sd[prefix + "norm.weight"] = _np(p["final_norm"]["scale"])
    head = p.get("lm_head")
    if head is not None and "w8" in head:
        sd["lm_head.w8"] = _np(head["w8"])[:, :vocab_size].T
        sd["lm_head.scale"] = _np(head["scale"])[:vocab_size]
    elif head is not None:
        sd["lm_head.weight"] = _np(head["weight"])[:, :vocab_size].T
    return sd


def _clip_names(p, prefix: str) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    sd[prefix + "embeddings.patch_embedding.weight"] = _np(
        p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[prefix + "embeddings.class_embedding"] = _np(p["class_embed"])
    sd[prefix + "embeddings.position_embedding.weight"] = _np(p["pos_embed"])
    sd[prefix + "pre_layrnorm.weight"] = _np(p["pre_norm"]["scale"])
    sd[prefix + "pre_layrnorm.bias"] = _np(p["pre_norm"]["bias"])
    layers = p["layers"]
    for i in range(layers["ln1"]["scale"].shape[0]):
        lp = prefix + f"encoder.layers.{i}."
        for hf, (grp, key) in _CLIP_NAMES.items():
            sd[lp + hf + ".weight"] = _np(layers[grp][key]["kernel"][i]).T
            sd[lp + hf + ".bias"] = _np(layers[grp][key]["bias"][i])
        for hf, key in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            sd[lp + hf + ".weight"] = _np(layers[key]["scale"][i])
            sd[lp + hf + ".bias"] = _np(layers[key]["bias"][i])
    return sd


def quantize_mode(sd: Mapping[str, object], prefix: str = "model.") -> Optional[str]:
    """The `quantize` mode whose layout state dict `sd` holds: names as
    `from_jax_params` gives them, or with `prefix="llama."` a model's own
    state dict. The int8 stacks are "int8" whichever route ran them
    ("int8_fused" is that layout's fused route, the caller's choice)."""
    for key, mode in (("int4.wqkv.w4t", "int4"), ("int4.wqkv.w4", "int4_flat"),
                      ("proj.wq.w8", "int8"), ("proj.wq.w4", "int4_proj")):
        if prefix + key in sd:
            return mode
    return None


def from_jax_params(params, vocab_size: int = 32101) -> Dict[str, np.ndarray]:
    """JAX HandsOnVLM parameters (dense or any quantized decoder layout) ->
    a state dict of contiguous numpy arrays under the checkpoint's names
    (the JAX exporter's `export_handsonvlm` mapping, extended to the
    quantized trees)."""
    sd = _llama_names(params["llama"], vocab_size)
    sd["model.mm_projector.weight"] = _np(params["projector"]["kernel"]).T
    sd["model.mm_projector.bias"] = _np(params["projector"]["bias"])
    if "vision" in params:
        sd.update(_clip_names(params["vision"],
                              "model.vision_tower.vision_tower.vision_model."))
    cvae = params["traj"]
    for hf, key in _CVAE_NAMES:
        p = "hand_traj_decoder.hand_traj_decoder.cvae." + hf
        sd[p + ".weight"] = _np(cvae[key]["kernel"]).T
        sd[p + ".bias"] = _np(cvae[key]["bias"])
    lora = params.get("lora")
    if lora is not None:
        for target, ad in lora["adapters"].items():
            sd[f"lora.adapters.{target}.a"] = _np(ad["a"])
            sd[f"lora.adapters.{target}.b"] = _np(ad["b"])
        sd["lora.scale"] = _np(lora["scale"])
    return {k: np.require(v, requirements="C") for k, v in sd.items()}
