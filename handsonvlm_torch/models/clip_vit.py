"""CLIP ViT vision tower (frozen CLIP ViT-L/14 in the reference).

Port of `handsonvlm_tpu/models/clip_vit.py` with HF `CLIPVisionModel`
parameter names: penultimate-layer hidden states (`select_layer=-2`), so
only the first `num_layers + select_layer + 1` layers run (23 of 24 at
ViT-L), and patch features only (CLS dropped). Layer norms run in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handsonvlm_torch.config import ClipVisionConfig
from handsonvlm_torch.ops.attention import attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x, scale, bias, eps):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.bias = nn.Parameter(torch.empty(dim, **factory))


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, **factory):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False, **factory)
        self.class_embedding = nn.Parameter(torch.empty(d, **factory))
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d, **factory)


class ClipAttention(nn.Module):
    def __init__(self, d: int, **factory):
        super().__init__()
        self.q_proj = nn.Linear(d, d, **factory)
        self.k_proj = nn.Linear(d, d, **factory)
        self.v_proj = nn.Linear(d, d, **factory)
        self.out_proj = nn.Linear(d, d, **factory)


class ClipMLP(nn.Module):
    def __init__(self, d: int, f: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(d, f, **factory)
        self.fc2 = nn.Linear(f, d, **factory)


class ClipLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = ClipAttention(d, **factory)
        self.layer_norm1 = LayerNorm(d, **factory)
        self.mlp = ClipMLP(d, cfg.intermediate_size, **factory)
        self.layer_norm2 = LayerNorm(d, **factory)

    def forward(self, hidden, cfg: ClipVisionConfig, attn_impl: str):
        """`_encoder_layer` on this layer, as a module call (for FSDP2's hooks)."""
        return _encoder_layer(hidden, self, cfg, attn_impl)


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, **factory):
        super().__init__()
        self.layers = nn.ModuleList(ClipLayer(cfg, **factory) for _ in range(cfg.num_layers))


class ClipVision(nn.Module):
    """All `num_layers` layers are held (checkpoints carry them); the
    forward runs the first `num_layers + select_layer + 1`."""

    def __init__(self, cfg: ClipVisionConfig, **factory):
        super().__init__()
        self.embeddings = ClipEmbeddings(cfg, **factory)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, **factory)
        self.encoder = ClipEncoder(cfg, **factory)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init like the JAX package: normal(0, 0.02) weights and
        embeddings, zero biases, layer norms at (1, 0)."""
        for name, p in self.named_parameters():
            if "layer_norm" in name or "layrnorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)


def _encoder_layer(hidden, lp: ClipLayer, cfg: ClipVisionConfig, attn_impl: str):
    b, t, d = hidden.shape
    h = cfg.num_heads
    a = lp.self_attn

    x = layer_norm(hidden, lp.layer_norm1.weight, lp.layer_norm1.bias, cfg.layer_norm_eps)
    q = a.q_proj(x).view(b, t, h, d // h)
    k = a.k_proj(x).view(b, t, h, d // h)
    v = a.v_proj(x).view(b, t, h, d // h)
    out = attention(q, k, v, causal=False, impl=attn_impl).reshape(b, t, d)
    hidden = hidden + a.out_proj(out)

    x = layer_norm(hidden, lp.layer_norm2.weight, lp.layer_norm2.bias, cfg.layer_norm_eps)
    return hidden + lp.mlp.fc2(quick_gelu(lp.mlp.fc1(x)))


def apply_clip_vision(
    vision: ClipVision,
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """(B, 3, H, W) CLIP-normalized images -> (B, num_patches, D) features
    of layer `num_layers + select_layer + 1`, CLS dropped."""
    emb = vision.embeddings
    x = pixel_values.to(emb.patch_embedding.weight.dtype)
    x = F.conv2d(x, emb.patch_embedding.weight, stride=cfg.patch_size)  # (B,D,g,g)
    x = x.flatten(2).transpose(1, 2)  # (B, g*g, D), row-major patches
    b, _, d = x.shape
    cls = emb.class_embedding.to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(x.dtype)
    x = layer_norm(x, vision.pre_layrnorm.weight, vision.pre_layrnorm.bias, cfg.layer_norm_eps)

    n_run = cfg.num_layers + cfg.select_layer + 1
    for lp in vision.encoder.layers[:n_run]:
        x = lp(x, cfg, attn_impl)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    return x
