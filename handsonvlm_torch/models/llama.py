"""LLaMA/Vicuna decoder (dense, bf16 at 7B).

Port of `handsonvlm_tpu/models/llama.py`: HF-layout `nn.Linear` weights in a
per-layer `ModuleList` run by a Python loop (the JAX package stacks them for
`lax.scan`). Numerics follow HF LLaMA and the JAX package: RMSNorm in fp32,
non-interleaved rotary with cos/sin cast to the activation dtype, SwiGLU
MLP, fp32 softmax, fp32 logits.

Cached decode writes each step's k/v rows into the (L, B, S, K, D) cache in
place (the JAX package returns a new cache) and attends through
`ops.attention.attention`, which serves windows of T <= 8 with the decode
kernel over a view of the layer (no copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from handsonvlm_torch.config import LlamaConfig
from handsonvlm_torch.ops.attention import attention


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
               device) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim_)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


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
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, **factory)
        self.mlp = LlamaMLP(cfg, **factory)
        self.input_layernorm = RMSNorm(cfg.hidden_size, **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **factory)


class Llama(nn.Module):
    """Decoder stack + head. The embedding and head keep `vocab_size` rows."""

    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, **factory)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory))

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


def _layer(
    lp: LlamaLayer,
    cfg: LlamaConfig,
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    kv_cache: Optional[KVCache],
    layer_idx: int,
    attn_impl: str,
) -> torch.Tensor:
    """One decoder block (dense). With a cache, this layer's k/v rows are
    written at `kv_cache.index` before attention reads them."""
    b, t, _ = hidden.shape
    h, k, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim_
    attn = lp.self_attn

    x = rms_norm(hidden, lp.input_layernorm.weight, cfg.rms_norm_eps)
    q = apply_rope(attn.q_proj(x).view(b, t, h, hd), cos, sin)
    kx = apply_rope(attn.k_proj(x).view(b, t, k, hd), cos, sin)
    vx = attn.v_proj(x).view(b, t, k, hd)

    if kv_cache is None:
        out = attention(q, kx, vx, key_mask=key_mask, causal=True, impl=attn_impl)
    else:
        idx = kv_cache.index
        kv_cache.k[layer_idx, :, idx:idx + t] = kx
        kv_cache.v[layer_idx, :, idx:idx + t] = vx
        # "auto" serves windows of T <= MAX_T_WINDOW with the decode kernel
        # over this layer's view of the cache; "xla" attends over the whole
        # layer, as the JAX package does: keys past the written prefix are
        # masked, and a fully masked (left-pad) query row then averages over
        # all S_max keys there too
        out = attention(
            q, kv_cache.k[layer_idx], kv_cache.v[layer_idx], key_mask=key_mask,
            causal=True, q_offset=idx, impl=attn_impl, decode_length=idx + t)
    hidden = hidden + attn.o_proj(out.reshape(b, t, h * hd))

    x = rms_norm(hidden, lp.post_attention_layernorm.weight, cfg.rms_norm_eps)
    gate = F.silu(lp.mlp.gate_proj(x))
    return hidden + lp.mlp.down_proj(gate * lp.mlp.up_proj(x))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def apply_llama(
    llama: Llama,
    cfg: LlamaConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    - Training/prefill without a cache: `attn_mask` (B,T) marks valid keys.
    - With `kv_cache`: new keys/values are written at `kv_cache.index` (in
      place), attention spans the written prefix, and `attn_mask` covers the
      S_max cache keys (None: every written key is valid). The cache's
      index advances by T.

    Returns the final-normed hidden states (B,T,D) and the cache (or None).
    """
    if inputs_embeds is None:
        inputs_embeds = llama.embed_tokens(input_ids)
    b, t, _ = inputs_embeds.shape
    device = inputs_embeds.device

    start = 0
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

    hidden = inputs_embeds
    for i, lp in enumerate(llama.layers):
        hidden = _layer(lp, cfg, hidden, cos, sin, key_mask, kv_cache, i, attn_impl)
    hidden = rms_norm(hidden, llama.norm.weight, cfg.rms_norm_eps)
    if kv_cache is not None:
        kv_cache.index += t
    return hidden, kv_cache


def lm_logits(llama: Llama, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project to the vocab with fp32 output: bf16 operands, fp32
    accumulation, no bf16 rounding of the logits (which would move the
    top-p cutoff) and no fp32 copy of the head on the card."""
    w = llama.embed_tokens.weight if cfg.tie_word_embeddings else llama.lm_head.weight
    flat = hidden.reshape(-1, hidden.shape[-1])
    if flat.is_cuda and flat.dtype != torch.float32:
        logits = torch.mm(flat, w.t(), out_dtype=torch.float32)
    else:
        logits = flat.float() @ w.float().t()
    return logits.reshape(*hidden.shape[:-1], w.shape[0])
