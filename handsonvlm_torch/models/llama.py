"""LLaMA/Vicuna decoder (dense, bf16 at 7B).

Port of `handsonvlm_tpu/models/llama.py`: HF-layout `nn.Linear` weights in a
per-layer `ModuleList` run by a Python loop (the JAX package stacks them for
`lax.scan`). Numerics follow HF LLaMA and the JAX package: RMSNorm in fp32,
non-interleaved rotary with cos/sin cast to the activation dtype, SwiGLU
MLP, fp32 softmax, fp32 logits.

Cached decode writes each step's k/v rows into the (L, B, S, K, D) cache in
place (the JAX package returns a new cache) and attends through
`ops.attention.attention`, which serves windows of T <= 8 with the stacked
decode kernel over a view of the layer (no copy) and, on the card, a
prefill of 2048 rows or more with the flash kernel over the same view
(`q_offset` = the cache index). `attn_impl="decode"` sends a one-token step
over a `KVCache` through the per-layer decode kernel instead (the JAX
package reaches that kernel from its per-layer cache-scan modes, which a
Python layer loop does not have); `attn_impl="flash"` asks for the flash
kernel at any prefill length and leaves windows of T <= 8 on the plain
route, as the JAX package's decoder layer does.

The quantized modes hold the JAX package's weight trees, bytes unchanged,
and the head as int8 (`Int8Head`):
- `quantize="int4"` (`quantize_llama_int4`, the JAX package's tree): the
  four fused projections of every layer (wqkv, wo, wgu, w_down) as stacked
  tiled int4 buffers under `Llama.int4`; `"int4_flat"` the same in the flat
  stacked layout. Both are read per layer through
  `ops.int8_matmul.int4_matmul_stacked` (a view, never a copy);
- `quantize="int8"` (`quantize_llama`, the JAX package's `quantize_llama`
  tree): the seven projections per layer (wq, wk, wv, wo, w_gate, w_up,
  w_down) as stacked int8 w8 (L, din, dout) with f32 scales (L, dout) under
  `Llama.proj`; `"int4_proj"` the same seven as flat int4 leaves. Both are
  read per layer through `ops.int8_matmul.maybe_int8_matmul` (kernels B9
  and B4a), as the JAX package's per-projection branch does;
- `quantize="int8_fused"` (the fused QLoRA route, `--qlora int8_fused`):
  the int8 stacks of "int8" (the leaves the JAX package's
  `stack_llama_int8` moves under `layers["int8"]`), read through
  `ops.qlora_fused` (kernels B10a, B10b): a projection with an adapter
  accumulates its low-rank delta in the kernel's output tile instead of
  adding a separate delta, as the JAX package's `proj8` does.
The int8 decode cache (`QuantKVCache`) holds int8 k/v with per-(token, kv
head) f32 scales; decode quantizes each step's rows in place and attends
through kernel B6. `attn_impl="xla"` runs every op's plain version instead
of its kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from handsonvlm_torch.config import LlamaConfig
from handsonvlm_torch.models.lora import lora_delta, lora_delta_multi
from handsonvlm_torch.ops.attention import attention
from handsonvlm_torch.ops.decode_attention import (
    MAX_T_WINDOW,
    BlockList,
    block_list,
    decode_attention_stacked_q,
)
from handsonvlm_torch.ops.int8_matmul import (
    INT4_GROUP,
    dequantize_int4,
    dequantize_tiled,
    int4_group,
    int4_matmul_stacked,
    int8_matmul,
    int8_matmul_ref,
    maybe_int8_matmul,
    quantize_int4,
    quantize_int8,
    quantize_lm_head,
    tile_int4_stacked,
    tiled_shapes,
)
from handsonvlm_torch.ops.qlora_fused import int8_lora_matmul_stacked, int8_matmul_stacked
from handsonvlm_torch.parallel.tp import (
    check_layout,
    copy_to_model,
    head_parallel,
    int4_matmul_stacked_tp,
    linear_f32,
    local_heads,
    reduce_partial,
)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Preallocated decode cache: k, v of shape (L, B, S_max, K, D), written
    in place; `index` counts the valid positions."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int, dtype,
               device, kv_heads: Optional[int] = None) -> "KVCache":
        """`kv_heads` (default: the config's) is a tensor-parallel rank's
        share (`parallel.tp.TPLayout.kv_heads`)."""
        shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.kv_heads, cfg.head_dim_)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class QuantKVCache:
    """int8 decode cache: k, v (L, B, S_max, K, D) int8 and per-(token, kv
    head) scales ks, vs (L, B, K, S_max) f32, laid out head-major so a kv
    head's scales are contiguous in S. Written in place; `index` counts the
    valid positions. Built from a prefill's cache by `quantize_kv_cache`."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor
    index: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def _quantize_kv_rows(x: torch.Tensor):
    """(..., K, D) -> int8 values and f32 scales (..., K), one scale per row:
    amax / 127 (1 for an all-zero row), round half to even, clip to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax / 127.0, 1.0)
    q8 = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q8, sc


def quantize_kv_cache(cache: KVCache) -> QuantKVCache:
    """A filled cache -> its int8 form (every position, as the JAX package
    quantizes it inside the prefill program)."""
    k8, ks = _quantize_kv_rows(cache.k)  # scales (L, B, S, K)
    v8, vs = _quantize_kv_rows(cache.v)
    return QuantKVCache(k=k8, v=v8, ks=ks.transpose(2, 3).contiguous(),
                        vs=vs.transpose(2, 3).contiguous(), index=cache.index)


# ---------------------------------------------------------------------------
# Modules (HF LlamaForCausalLM parameter names)
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim_
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=False, **factory)
        self.k_proj = nn.Linear(d, cfg.kv_heads * hd, bias=False, **factory)
        self.v_proj = nn.Linear(d, cfg.kv_heads * hd, bias=False, **factory)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False, **factory)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)


class LlamaLayer(nn.Module):
    """One block's weights; `dense=False` (the quantized modes) keeps only
    the norms, the projections living in `Llama.int4` or `Llama.proj`.
    Calling the module runs `_layer` on it, so that the hooks of a layer
    FSDP2 shards (`parallel/partition.shard_model`) gather its parameters
    around the call."""

    def __init__(self, cfg: LlamaConfig, dense: bool = True, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, **factory) if dense else None
        self.mlp = LlamaMLP(cfg, **factory) if dense else None
        self.input_layernorm = RMSNorm(cfg.hidden_size, **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **factory)

    def forward(self, llama, cfg, hidden, *args, **kwargs):
        return _layer(llama, self, cfg, hidden, *args, **kwargs)


def int4_projection_shapes(cfg: LlamaConfig):
    """(din, dout) of the four fused projections of a layer."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    return {"wqkv": (d, (cfg.num_heads + 2 * cfg.kv_heads) * hd),
            "wo": (cfg.num_heads * hd, d), "wgu": (d, 2 * f), "w_down": (f, d)}


def projection_shapes(cfg: LlamaConfig):
    """(din, dout) of the seven projections of a layer, JAX names."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    qh, kh = cfg.num_heads * hd, cfg.kv_heads * hd
    return {"wq": (d, qh), "wk": (d, kh), "wv": (d, kh), "wo": (qh, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


class Int4Weight(nn.Module):
    """One projection of every layer in int4: the tiled layout w4t (L, NB,
    G, g/2, BN) int8 and gst (L, NB, G, BN) f32, or (`flat`) the flat one
    w4 (L, G, g/2, n) int8 and gscale (L, G, n) f32."""

    def __init__(self, din: int, dout: int, num_layers: int, group: int = INT4_GROUP,
                 device=None, flat: bool = False):
        super().__init__()
        if flat:
            g = int4_group(din, group)
            shapes = {"w4": (num_layers, din // g, g // 2, dout),
                      "gscale": (num_layers, din // g, dout)}
        else:
            shapes = dict(zip(("w4t", "gst"), tiled_shapes(din, dout, num_layers, group)))
        for (name, shape), dtype in zip(shapes.items(), (torch.int8, torch.float32)):
            self.register_buffer(name, torch.empty(shape, dtype=dtype, device=device))

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, scales): (w4t, gst) or (w4, gscale)."""
        return tuple(self.buffers())

    def leaf(self, layer_idx: int) -> dict:
        """Layer `layer_idx` as views, a JAX-style {"w4", "gscale"} leaf."""
        return {"w4": self.w4[layer_idx], "gscale": self.gscale[layer_idx]}


class Int8Weight(nn.Module):
    """One projection of every layer in int8: w8 (L, din, dout) int8 and one
    f32 scale per output column, scale (L, dout)."""

    def __init__(self, din: int, dout: int, num_layers: int, device=None):
        super().__init__()
        self.register_buffer("w8", torch.empty((num_layers, din, dout), dtype=torch.int8,
                                               device=device))
        self.register_buffer("scale", torch.empty((num_layers, dout), dtype=torch.float32,
                                                  device=device))

    def leaf(self, layer_idx: int) -> dict:
        """Layer `layer_idx` as views, a JAX-style {"w8", "scale"} leaf."""
        return {"w8": self.w8[layer_idx], "scale": self.scale[layer_idx]}


class Int8Head(nn.Module):
    """The head as int8 w8 (V, d) with one f32 scale per vocab entry."""

    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.register_buffer("w8", torch.empty((vocab, d), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty((vocab,), dtype=torch.float32,
                                                  device=device))


QUANTIZE_MODES = (None, "int4", "int4_flat", "int8", "int4_proj", "int8_fused")


class Llama(nn.Module):
    """Decoder stack + head. The embedding and head keep `vocab_size` rows.

    A `quantize` mode builds its layout directly (an `Int8Head`, and the
    projections under `int4`: "int4" tiled, "int4_flat" flat; or under
    `proj`: "int8" and "int8_fused", "int4_proj" flat int4), as the
    quantizers leave a dense model and the JAX package's trees load.
    `quantize` keeps the mode, which the quantizers update: "int8" and
    "int8_fused" share a layout and differ in route only, so switching
    between them is a change of `quantize` alone."""

    def __init__(self, cfg: LlamaConfig, quantize: Optional[str] = None, **factory):
        super().__init__()
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        dense = quantize is None
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, dense, **factory) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, **factory)
        device, L = factory.get("device"), cfg.num_layers
        self.int4 = None if quantize not in ("int4", "int4_flat") else nn.ModuleDict({
            name: Int4Weight(din, dout, L, device=device, flat=quantize == "int4_flat")
            for name, (din, dout) in int4_projection_shapes(cfg).items()})
        self.proj = None if quantize not in ("int8", "int4_proj", "int8_fused") else (
            nn.ModuleDict({
                name: (Int4Weight(din, dout, L, device=device, flat=True)
                       if quantize == "int4_proj" else Int8Weight(din, dout, L, device))
                for name, (din, dout) in projection_shapes(cfg).items()}))
        self.quantize = quantize
        self.tp_layout = None  # a parallel.tp.TPLayout once cut for tensor parallelism
        if cfg.tie_word_embeddings:
            self.lm_head = None
        elif dense:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory)
        else:
            self.lm_head = Int8Head(cfg.vocab_size, cfg.hidden_size, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init like the JAX package: normal(0, 0.02), norms at 1."""
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """HF-style rotary tables. positions (B,T) -> cos/sin (B,T,head_dim)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B,T,H,D); cos/sin (B,T,D). Non-interleaved rotate_half (HF)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotated * sin


# ---------------------------------------------------------------------------
# Quantized weights
# ---------------------------------------------------------------------------

_FUSED = {  # fused projection -> (submodule, Linear names concatenated on dout)
    "wqkv": ("self_attn", ("q_proj", "k_proj", "v_proj")),
    "wo": ("self_attn", ("o_proj",)),
    "wgu": ("mlp", ("gate_proj", "up_proj")),
    "w_down": ("mlp", ("down_proj",)),
}
_PROJ = {  # JAX projection name -> (submodule, Linear name)
    "wq": ("self_attn", "q_proj"), "wk": ("self_attn", "k_proj"),
    "wv": ("self_attn", "v_proj"), "wo": ("self_attn", "o_proj"),
    "w_gate": ("mlp", "gate_proj"), "w_up": ("mlp", "up_proj"),
    "w_down": ("mlp", "down_proj"),
}


def _quantize_head(llama: Llama, device) -> None:
    if llama.lm_head is not None:
        w8, scale = quantize_lm_head(llama.lm_head.weight)
        head = Int8Head(*w8.shape, device=device)
        head.w8.copy_(w8)
        head.scale.copy_(scale)
        llama.lm_head = head


@torch.no_grad()
def quantize_llama_int4(llama: Llama, cfg: LlamaConfig, group: int = INT4_GROUP) -> Llama:
    """Quantize a dense decoder in place into the int4 layout (the JAX
    package's `quantize_llama_int4`): per layer, fuse wq|wk|wv, wo,
    w_gate|w_up and w_down, quantize each to int4 (group 128), tile it into
    the stacked buffers and free its dense weights at once, so the peak is
    the dense model plus one layer's quantization; then quantize the head
    to int8. Norms and the embedding keep their dtype."""
    device = llama.embed_tokens.weight.device
    llama.int4 = nn.ModuleDict({
        name: Int4Weight(din, dout, cfg.num_layers, group, device=device)
        for name, (din, dout) in int4_projection_shapes(cfg).items()})
    for i, lp in enumerate(llama.layers):
        for name, (sub, parts) in _FUSED.items():
            mod = getattr(lp, sub)
            w = torch.cat([getattr(mod, p).weight.t() for p in parts], dim=1)
            w4, gs = quantize_int4(w, group)
            buf = llama.int4[name]
            w4t, gst = tile_int4_stacked(w4[None], gs[None], buf.w4t.shape[-1])
            buf.w4t[i].copy_(w4t[0])
            buf.gst[i].copy_(gst[0])
            del w, w4, gs, w4t, gst
            for p in parts:
                delattr(mod, p)
        lp.self_attn = None
        lp.mlp = None
    _quantize_head(llama, device)
    llama.quantize = "int4"
    return llama


@torch.no_grad()
def quantize_llama(llama: Llama, cfg: LlamaConfig, mode: str = "int8") -> Llama:
    """Quantize a dense decoder in place into the int8 layout (the JAX
    package's `quantize_llama`): per layer, each of the seven projections
    to int8 with one scale per output column into the stacked buffers, its
    dense weight freed at once (the peak is the dense model plus the int8
    buffers); then the head to int8. Norms and the embedding keep their
    dtype. `mode` is "int8" or "int8_fused" (the route)."""
    if mode not in ("int8", "int8_fused"):
        raise ValueError(f"quantize_llama makes the int8 layout, not {mode!r}")
    device = llama.embed_tokens.weight.device
    llama.proj = nn.ModuleDict({
        name: Int8Weight(din, dout, cfg.num_layers, device)
        for name, (din, dout) in projection_shapes(cfg).items()})
    for i, lp in enumerate(llama.layers):
        for name, (sub, lin) in _PROJ.items():
            mod = getattr(lp, sub)
            w8, scale = quantize_int8(getattr(mod, lin).weight.t(), axis=0)
            llama.proj[name].w8[i].copy_(w8)
            llama.proj[name].scale[i].copy_(scale)
            delattr(mod, lin)
        lp.self_attn = None
        lp.mlp = None
    _quantize_head(llama, device)
    llama.quantize = mode
    return llama


def _dequantized(w: nn.Module, i: int) -> torch.Tensor:
    """Layer i of a quantized projection -> its exactly dequantized (din,
    dout) f32 weight (one f32 rounding of values x scales)."""
    if isinstance(w, Int8Weight):
        return w.w8[i].float() * w.scale[i]
    if hasattr(w, "w4t"):
        return dequantize_tiled(w.w4t, w.gst, i)
    return dequantize_int4(w.w4[i], w.gscale[i])


@torch.no_grad()
def dequantize_llama(llama: Llama, cfg: LlamaConfig, dtype) -> Llama:
    """The inverse layout change of any quantized mode, for references:
    rebuild dense `dtype` projections and head from the exactly dequantized
    int4 / int8 values (one f32 rounding each, then the cast to `dtype`)."""
    device = llama.embed_tokens.weight.device
    if llama.int4 is not None:
        weights, table = llama.int4, _FUSED
    else:
        weights, table = llama.proj, {n: (sub, (lin,)) for n, (sub, lin) in _PROJ.items()}
    for i, lp in enumerate(llama.layers):
        lp.self_attn = LlamaAttention(cfg, device=device, dtype=dtype)
        lp.mlp = LlamaMLP(cfg, device=device, dtype=dtype)
        for name, (sub, parts) in table.items():
            w = _dequantized(weights[name], i)
            start = 0
            for p in parts:
                lin = getattr(getattr(lp, sub), p)
                lin.weight.copy_(w[:, start:start + lin.out_features].t())
                start += lin.out_features
    llama.int4 = llama.proj = None
    llama.quantize = None
    if isinstance(llama.lm_head, Int8Head):
        head = llama.lm_head
        lin = nn.Linear(head.w8.shape[1], head.w8.shape[0], bias=False, device=device,
                        dtype=dtype)
        lin.weight.copy_(head.w8.float() * head.scale[:, None])
        llama.lm_head = lin.requires_grad_(False)
    return llama.requires_grad_(False)


# ---------------------------------------------------------------------------
# Decoder block
# ---------------------------------------------------------------------------


def _write_quant_kv(cache: QuantKVCache, layer_idx: int, kx, vx) -> None:
    """Quantize this step's k/v rows (B, t, K, D) and write them and their
    scales into the int8 cache in place."""
    idx, t = cache.index, kx.shape[1]
    k8, ksc = _quantize_kv_rows(kx)  # scales (B, t, K)
    v8, vsc = _quantize_kv_rows(vx)
    cache.k[layer_idx, :, idx:idx + t] = k8
    cache.v[layer_idx, :, idx:idx + t] = v8
    cache.ks[layer_idx, :, :, idx:idx + t] = ksc.transpose(1, 2)
    cache.vs[layer_idx, :, :, idx:idx + t] = vsc.transpose(1, 2)


def _add(y: torch.Tensor, delta) -> torch.Tensor:
    """y plus a LoRA delta; the untargeted delta 0.0 adds no op."""
    return y if isinstance(delta, float) else y + delta


def _layer(
    llama: Llama,
    lp: LlamaLayer,
    cfg: LlamaConfig,
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    kv_cache,
    layer_idx: int,
    attn_impl: str,
    blocks: Optional[BlockList] = None,
    lora_layer=None,
    lora_scale=0.0,
    tp=None,
    layout=None,
    seq=None,
) -> torch.Tensor:
    """One decoder block, dense, fused int4 (`Llama.int4`), per projection
    int8 / flat int4 (`Llama.proj`) or fused QLoRA int8 (`Llama.proj` under
    `quantize="int8_fused"`). With a cache (bf16/f32 `KVCache` or int8
    `QuantKVCache`), this layer's k/v rows are written at `kv_cache.index`
    before attention reads them; a decode window attends over the forward's
    compacted block list `blocks`. `lora_layer` (the layer's adapter views,
    `LoRA.layer(i)`) adds each target's low-rank delta where the JAX
    package's `_layer` adds it (on the fused route, inside the kernel).

    `tp` (a `parallel.tp.TPGroup`) with `layout` (the decoder's
    `TPLayout`) runs this rank's shard, as the JAX package's `tp_mesh`:
    int4 projections column-parallel with their outputs gathered, the
    attention over this rank's heads and cache (gathered after it on the
    int4 route, which feeds the column-parallel wo), dense and int8 q / k /
    v / gate / up column-parallel behind `copy_to_model`, o / down
    row-parallel (the f32 partials and their LoRA terms summed over the
    group). Every collective is differentiable, so a training cut
    (`parallel.tp.shard_for_training`) runs the same code under autograd
    and remat. `seq` (a mesh with a 'seq' axis) makes the attention of a
    cache-less forward ring attention over its ranks, each holding T/P rows
    (`parallel/ring_attention.py`), as the JAX package's `seq_mesh`."""
    b, t, _ = hidden.shape
    h, k, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim_
    int4, proj = llama.int4, llama.proj
    plain = attn_impl == "xla"
    fused = llama.quantize == "int8_fused"
    heads = layout is not None and layout.heads
    mlp_cut = layout is not None and layout.mlp

    def fproj(x, name):  # the fused QLoRA route, the JAX package's proj8
        w = proj[name]
        if lora_layer is not None and name in lora_layer:
            ad = lora_layer[name]
            return int8_lora_matmul_stacked(x, w.w8, w.scale, ad["a"], ad["b"], lora_scale,
                                            layer_idx, plain=plain)
        return int8_matmul_stacked(x, w.w8, w.scale, layer_idx, plain=plain)

    def iproj(x, name):
        if layout is None:
            return int4_matmul_stacked(x, *int4[name].packed(), layer_idx, plain=plain)
        return int4_matmul_stacked_tp(x, *int4[name].packed(), layer_idx, plain=plain,
                                      tp=tp if layout.int4[name] else None)

    def base(x, name):  # a dense, per-projection or fused weight (this rank's slice)
        if fused:
            return fproj(x, name)
        if proj is not None:
            return maybe_int8_matmul(x, proj[name].leaf(layer_idx), plain=plain)
        sub, lin = _PROJ[name]
        return getattr(getattr(lp, sub), lin)(x)

    def column(x, names, cut):  # q / k / v or gate / up, each with its delta
        xc = copy_to_model(x, tp) if cut else x  # its dx is summed over the group
        if fused:
            return tuple(fproj(xc, n) for n in names)
        delta = lora_delta_multi(lora_layer, names, xc, lora_scale)
        if not isinstance(delta, tuple):  # 0.0, or one concatenated delta
            widths = [lora_layer[n]["b"].shape[-1] for n in names] if lora_layer else []
            delta = ((0.0,) * len(names) if isinstance(delta, float)
                     else tuple(delta.split(widths, dim=-1)))
        return tuple(_add(base(xc, n), d) for n, d in zip(names, delta))

    def row(x, name, cut):  # o / down: row-parallel when this rank holds a slice
        if not cut:
            return base(x, name) if fused else _add(
                base(x, name), lora_delta(lora_layer, name, x, lora_scale))
        extra = None
        if fused:  # the term is in the kernel's partial
            part = fproj(x, name)
        elif proj is not None:
            w = proj[name].leaf(layer_idx)
            part = (int8_matmul_ref if plain else int8_matmul)(x, w["w8"], w["scale"],
                                                               torch.float32)
        else:
            sub, lin = _PROJ[name]
            part = linear_f32(x, getattr(getattr(lp, sub), lin).weight)
        if not fused and lora_layer is not None and name in lora_layer:
            extra = lora_delta(lora_layer, name, x, lora_scale, out_dtype=torch.float32)
        return reduce_partial(part, tp, x.dtype, extra)

    x = rms_norm(hidden, lp.input_layernorm.weight, cfg.rms_norm_eps)
    if int4 is not None:
        qkv_widths = [h * hd, k * hd, k * hd]
        dqkv = lora_delta_multi(lora_layer, ("wq", "wk", "wv"), x, lora_scale)
        qkv = iproj(x, "wqkv")
        if not isinstance(dqkv, tuple):  # one concatenated delta, or none
            qkv, dqkv = _add(qkv, dqkv), (0.0, 0.0, 0.0)
        q, kx, vx = (_add(y, dy) for y, dy in zip(qkv.split(qkv_widths, dim=-1), dqkv))
    else:
        q, kx, vx = column(x, ("wq", "wk", "wv"), heads)
    # a dense or int8 shard's projections give this rank's heads alone, hence -1
    q = apply_rope(q.reshape(b, t, -1, hd), cos, sin)
    kx = apply_rope(kx.reshape(b, t, -1, hd), cos, sin)
    vx = vx.reshape(b, t, -1, hd)
    head_split = heads and int4 is not None  # every head projected: attend this rank's
    if head_split:
        kx, vx = local_heads(kx, tp), local_heads(vx, tp)

    def attend(q):
        if kv_cache is None:
            if seq is not None:
                from handsonvlm_torch.parallel.ring_attention import ring_attention

                return ring_attention(q, kx, vx, mesh=seq, causal=True, key_mask=key_mask)
            return attention(q, kx, vx, key_mask=key_mask, causal=True, impl=attn_impl)
        if isinstance(kv_cache, QuantKVCache):
            _write_quant_kv(kv_cache, layer_idx, kx, vx)
            idx, c = kv_cache.index, kv_cache
            if t <= MAX_T_WINDOW and attn_impl in ("auto", "decode", "stacked"):
                return decode_attention_stacked_q(q, c.k, c.v, c.ks, c.vs, layer_idx, idx + t,
                                                  key_mask=key_mask, blocks=blocks)
            # plain route, as the JAX package's: dequantize the layer and
            # attend over all of it (keys past the written prefix masked)
            k_l = (c.k[layer_idx].float() * c.ks[layer_idx].transpose(1, 2)[..., None])
            v_l = (c.v[layer_idx].float() * c.vs[layer_idx].transpose(1, 2)[..., None])
            return attention(q, k_l.to(q.dtype), v_l.to(q.dtype), key_mask=key_mask,
                             causal=True, q_offset=idx, impl="xla")
        idx = kv_cache.index
        kv_cache.k[layer_idx, :, idx:idx + t] = kx
        kv_cache.v[layer_idx, :, idx:idx + t] = vx
        # "auto" serves windows of T <= MAX_T_WINDOW with the stacked decode
        # kernel and long prefills with the flash kernel, both over this
        # layer's view of the cache; "xla" attends over the whole layer, as
        # the JAX package does: keys past the written prefix are masked, and
        # a fully masked (left-pad) query row then averages over all S_max
        # keys there (the flash kernel gives such a row 0; it is never read)
        impl = "xla" if attn_impl == "flash" and t <= MAX_T_WINDOW else attn_impl
        return attention(
            q, kv_cache.k[layer_idx], kv_cache.v[layer_idx], key_mask=key_mask,
            causal=True, q_offset=idx, impl=impl, decode_length=idx + t, blocks=blocks)

    out = head_parallel(attend, q, tp if head_split else None).reshape(b, t, -1)
    f = cfg.intermediate_size
    if int4 is not None:
        hidden = _add(hidden + iproj(out, "wo"), lora_delta(lora_layer, "wo", out, lora_scale))
        x = rms_norm(hidden, lp.post_attention_layernorm.weight, cfg.rms_norm_eps)
        gu = iproj(x, "wgu")
        dgu = lora_delta_multi(lora_layer, ("w_gate", "w_up"), x, lora_scale)
        if not isinstance(dgu, tuple):
            gu, dgu = _add(gu, dgu), (0.0, 0.0)
        gate, up = (_add(y, dy) for y, dy in zip(gu.split([f, f], dim=-1), dgu))
        gu = F.silu(gate) * up
        return _add(hidden + iproj(gu, "w_down"),
                    lora_delta(lora_layer, "w_down", gu, lora_scale))
    hidden = hidden + row(out, "wo", heads)
    x = rms_norm(hidden, lp.post_attention_layernorm.weight, cfg.rms_norm_eps)
    gate, up = column(x, ("w_gate", "w_up"), mlp_cut)
    return hidden + row(F.silu(gate) * up, "w_down", mlp_cut)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots", "dots_nobatch", "save_lora")


def _remat_context(remat):
    """`context_fn` of torch.utils.checkpoint for a remat policy, as the JAX
    package's `_remat` picks its jax.checkpoint policy: True / "full" save
    nothing (the default contexts); "dots" keep every matmul output
    (dots_saveable); "dots_nobatch" those without batch dimensions, mm and
    not bmm (dots_with_no_batch_dims_saveable); "save_lora" only the
    adapters' first-stage x @ a (the op `handsonvlm_torch::lora_u`, JAX's
    `save_only_these_names("lora_u")`). An unknown policy raises."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    aten, lora = torch.ops.aten, torch.ops.handsonvlm_torch.lora_u.default
    saved = {
        "dots": (aten.mm.default, aten.addmm.default, aten.bmm.default,
                 aten.baddbmm.default, lora),
        "dots_nobatch": (aten.mm.default, aten.addmm.default, lora),
        "save_lora": (lora,),
    }
    if remat is True or remat == "full":
        return noop_context_fn
    if remat not in saved:
        raise ValueError(f"unknown remat policy {remat!r} (use {REMAT_POLICIES})")
    ops = saved[remat]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def apply_llama(
    llama: Llama,
    cfg: LlamaConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache=None,
    attn_impl: str = "auto",
    lora=None,
    remat=False,
    tp=None,
    seq=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    - Training/prefill without a cache: `attn_mask` (B,T) marks valid keys.
    - With `kv_cache`: new keys/values are written at `kv_cache.index` (in
      place), attention spans the written prefix, and `attn_mask` covers the
      S_max cache keys (None: every written key is valid). The cache's
      index advances by T. A `QuantKVCache` serves windows of T <= 8 only:
      a prefill fills a `KVCache` and then `quantize_kv_cache`.

    `lora` (a `models.lora.LoRA`) adds its adapters' deltas in every layer.
    `remat` (False, True / "full", "dots", "dots_nobatch", "save_lora")
    recomputes each layer in the backward (`torch.utils.checkpoint`, one
    checkpoint per layer) with the JAX package's save policies: "full"
    saves nothing, "dots" every matmul output, "dots_nobatch" those
    without batch dimensions, "save_lora" only the adapters' x @ a.

    `tp` (a `parallel.tp.TPGroup`) runs this rank's shard of a decoder cut
    by `parallel.tp.shard_llama_tp` for it, over a cache of its kv heads
    (the JAX package's `tp_mesh`), or trains it (a cut by
    `parallel.tp.shard_for_training`, the adapters cut with it). `seq` (a mesh with a 'seq' axis) runs a
    cache-less forward sequence-parallel: each rank passes its T/P rows and
    their global `positions`, and the attention is ring attention (the JAX
    package's `seq_mesh`).

    Returns the final-normed hidden states (B,T,D) and the cache (or None).
    """
    layout = check_layout(llama, tp)
    if (layout is not None and lora is not None and llama.int4 is None
            and (layout.heads or layout.mlp)
            and getattr(lora, "tp_for", None) != (layout.rank, layout.size)):
        raise ValueError("whole LoRA adapters on a dense or int8 tensor-parallel shard: merge "
                         "them into the weights first (models.lora.merge_lora), then cut the "
                         "shards, or cut them with the decoder (parallel.tp.shard_lora_tp)")
    if layout is not None and kv_cache is not None and (
            kv_cache.k.shape[3] != layout.kv_heads(cfg.kv_heads)):
        raise ValueError(f"the cache holds {kv_cache.k.shape[3]} kv heads, this rank's shard "
                         f"{layout.kv_heads(cfg.kv_heads)}")
    if inputs_embeds is None:
        inputs_embeds = llama.embed_tokens(input_ids)
    b, t, _ = inputs_embeds.shape
    device = inputs_embeds.device

    start = 0
    if isinstance(kv_cache, QuantKVCache) and t > MAX_T_WINDOW:
        raise ValueError(f"QuantKVCache serves decode windows (t <= {MAX_T_WINDOW}), "
                         f"got t={t}: prefill into a KVCache, then quantize_kv_cache")
    if kv_cache is not None:
        start = kv_cache.index
        if start + t > kv_cache.max_len:
            raise ValueError(f"{start + t} positions do not fit cache {kv_cache.max_len}")
        written = torch.arange(kv_cache.max_len, device=device) < start + t
        key_mask = written[None, :]
        if attn_mask is not None:
            key_mask = key_mask & attn_mask.bool()
        key_mask = key_mask.expand(b, kv_cache.max_len).contiguous()
    else:
        key_mask = attn_mask.bool() if attn_mask is not None else None

    if positions is None:
        positions = (torch.arange(t, device=device) + start)[None].expand(b, t)
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    # a decode window's compacted block list, built once for all layers
    # (the per-layer decode kernel of attn_impl="decode" at t == 1 needs none)
    blocks = None
    stacked = attn_impl in ("auto", "stacked") or (
        attn_impl == "decode" and (t > 1 or isinstance(kv_cache, QuantKVCache)))
    if kv_cache is not None and t <= MAX_T_WINDOW and stacked:
        blocks = block_list(key_mask, start + t, b, kv_cache.max_len, device)

    context_fn = _remat_context(remat) if remat else None
    lora_scale = lora.scale if lora is not None else 0.0

    def run(i, lp, hidden):
        lora_layer = lora.layer(i) if lora is not None else None
        return lp(llama, cfg, hidden, cos, sin, key_mask, kv_cache, i, attn_impl,
                  blocks, lora_layer, lora_scale, tp, layout, seq)

    hidden = inputs_embeds
    for i, lp in enumerate(llama.layers):
        if context_fn is None:
            hidden = run(i, lp, hidden)
        else:
            hidden = torch.utils.checkpoint.checkpoint(
                functools.partial(run, i, lp), hidden, use_reentrant=False,
                context_fn=context_fn)
    hidden = rms_norm(hidden, llama.norm.weight, cfg.rms_norm_eps)
    if kv_cache is not None:
        kv_cache.index += t
    return hidden, kv_cache


def lm_logits(llama: Llama, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project to the vocab with fp32 output: bf16 operands, fp32
    accumulation, no bf16 rounding of the logits (which would move the
    top-p cutoff) and no fp32 copy of the head on the card. The int8 head
    (`Int8Head`) is cast to the activations' dtype, multiplied with fp32
    accumulation, and its scales are applied to the fp32 logits, as the JAX
    package does."""
    scale = None
    if cfg.tie_word_embeddings:
        w = llama.embed_tokens.weight
    elif isinstance(llama.lm_head, Int8Head):
        w, scale = llama.lm_head.w8.to(hidden.dtype), llama.lm_head.scale
    else:
        w = llama.lm_head.weight
    flat = hidden.reshape(-1, hidden.shape[-1])
    if flat.is_cuda and flat.dtype != torch.float32:
        logits = _HeadMatmul.apply(flat, w)
    else:
        logits = flat.float() @ w.float().t()
    if scale is not None:
        logits = logits * scale
    return logits.reshape(*hidden.shape[:-1], w.shape[0])


class _HeadMatmul(torch.autograd.Function):
    """logits = flat @ w^T with f32 output from bf16 operands (`torch.mm`'s
    out_dtype form, which autograd cannot differentiate), and a plain
    backward: the f32 logits' gradient rounded to the operands' dtype, f32
    sums in the products."""

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(flat, w)
        return torch.mm(flat, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dlogits):
        flat, w = ctx.saved_tensors
        g = dlogits.to(flat.dtype)
        dflat = g @ w.to(flat.dtype) if ctx.needs_input_grad[0] else None
        dw = (g.t() @ flat).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dflat, dw
