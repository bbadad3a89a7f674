"""Visual-token fusion modes (the VisualToTokenHelper pipeline).

Port of `handsonvlm_tpu/models/visual_tokens.py`: alternative vision -> LLM
adapters that fuse precomputed TSN features (B, 5, T, 1024) and the hand /
object boxes instead of raw CLIP frames, with the random / zero / reverse
ablations the reference uses to isolate the language path. The shipped
HandsOnVLM path is 'origin' (CLIP on the raw frames, as
`models.handsonvlm.encode_video`); the hoi modes serve the LITA-HOI model
family (`models.lita_hoi`) and ablation studies.

The fusion layers keep the names of the JAX tree's leaves as torch module
paths: `downproject`, `bbox_to_feature.{0,2}` (fc1, fc2) and
`feat_fusion.0`. The ablations' uniform draws come from a passed
`torch.Generator`, or are passed in whole as `noise`, so a test can feed
both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.models.clip_vit import apply_clip_vision
from handsonvlm_torch.models.pooling import pool_video_tokens
from handsonvlm_torch.models.projector import apply_projector

ABLATIONS = ("-random-zero-embed-one-attention", "-random", "-reverse")


class HoiEncoder(nn.Module):
    """The bbox / feature fusion layers (lita_llama_hoi_encoder.py:10-22)."""

    def __init__(self, coord_dim: int = 64, feat_dim: int = 1024, **factory):
        super().__init__()
        self.bbox_to_feature = nn.Sequential(
            nn.Linear(4, coord_dim // 2, **factory), nn.ELU(),
            nn.Linear(coord_dim // 2, coord_dim, **factory), nn.ELU())
        self.feat_fusion = nn.Sequential(
            nn.Linear(feat_dim + coord_dim, feat_dim, **factory), nn.ELU())
        self.downproject = nn.Linear(feat_dim, feat_dim, **factory)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """uniform(-1/sqrt(in), 1/sqrt(in)) weights and biases, as in JAX."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


def _bbox_features(hoi_encoder: HoiEncoder, bbox: torch.Tensor) -> torch.Tensor:
    return hoi_encoder.bbox_to_feature(bbox)


def _base_mode(mode: str) -> str:
    for suffix in ABLATIONS:
        if mode.endswith(suffix):
            return mode[: -len(suffix)]
    return mode


def _uniform(shape, like: torch.Tensor, noise, generator) -> torch.Tensor:
    if noise is not None:
        return noise.to(like.device, like.dtype)
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def fuse_hoi_features(
    hoi_encoder: HoiEncoder,
    projector: nn.Linear,
    mode: str,
    feat: torch.Tensor,  # (B, 5, T, 1024) global / rhand / lhand / robj / lobj
    bbox_feat: torch.Tensor,  # (B, 4, T, 4)
    valid_mask: torch.Tensor,  # (B, 5, T)
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fuse_input for the hoi modes -> (tokens (B, T, S, D), attn (B, T, S)
    bool). Modes (visual_to_tokens.py:179-227): 'hoi-global', 'clip',
    'hoi-hand', 'hoi' and their '-random' / '-reverse' /
    '-random-zero-embed-one-attention' ablations. The inputs are cast to the
    layers' dtype. '-random' replaces the tokens by uniform [0, 1) draws:
    `noise` (the tokens' shape) when given, else from `generator`."""
    dtype = hoi_encoder.downproject.weight.dtype
    feat, bbox_feat = feat.to(dtype), bbox_feat.to(dtype)
    base = _base_mode(mode)
    feat_p = hoi_encoder.downproject(feat)

    if base in ("hoi-global", "clip"):
        tokens = apply_projector(projector, feat_p[:, 0:1].transpose(1, 2))  # (B,T,1,D)
        attn = valid_mask[:, 0:1].transpose(1, 2).bool()
    elif base == "hoi-hand":
        bb = _bbox_features(hoi_encoder, bbox_feat[:, :2])  # (B,2,T,coord)
        hand = feat_p[:, 1:3]
        fused = hoi_encoder.feat_fusion(torch.cat([hand, bb], dim=-1))
        # the reference computes the fusion and feeds the raw hand features
        # to the projector (visual_to_tokens.py:114-125), as the JAX package
        # does: feat_fusion gets no gradient from this mode
        del fused
        tokens = torch.cat([feat_p[:, 0:1], hand], dim=1).transpose(1, 2)
        tokens = apply_projector(projector, tokens)
        attn = valid_mask[:, 0:3].transpose(1, 2).bool()
    elif base == "hoi":
        bb = _bbox_features(hoi_encoder, bbox_feat)  # (B,4,T,coord)
        fused = hoi_encoder.feat_fusion(torch.cat([feat_p[:, 1:5], bb], dim=-1))
        tokens = torch.cat([feat_p[:, 0:1], fused], dim=1).transpose(1, 2)
        tokens = apply_projector(projector, tokens)
        attn = valid_mask.transpose(1, 2).bool()
    else:
        raise ValueError(f"unknown fuse mode {mode}")

    if mode.endswith("-random-zero-embed-one-attention"):
        tokens = torch.zeros_like(tokens)
        attn = torch.ones_like(attn)
    elif mode.endswith("-random"):
        if noise is None and generator is None:
            raise ValueError(f"fuse mode {mode} needs `noise` or a generator")
        tokens = _uniform(tokens.shape, tokens, noise, generator)
    elif mode.endswith("-reverse"):
        attn = ~attn
    return tokens, attn


def visual_pipeline(
    model: nn.Module,
    cfg: HandsOnVLMConfig,
    *,
    images: Optional[torch.Tensor] = None,
    feat: Optional[torch.Tensor] = None,
    bbox_feat: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """VisualToTokenHelper.pipeline: fuse_input -> compress_tokens.

    `model` holds `projector` and, per mode, `vision` (origin: the CLIP
    tower, run through `apply_clip_vision` with `attn_impl`, so on the card
    the CLIP kernel serves it) or `hoi_encoder` (the hoi modes). The CLIP
    tower is frozen in every reference recipe and runs without a graph, as
    in `encode_video`. 'origin-random' draws uniform tokens (B, T, S, D) in
    the images' dtype: `noise` when given, else from `generator`.

    Returns (visual_tokens (B, N, D), attention_mask (B, N) bool)."""
    mode = cfg.fuse_input_mode
    if mode in ("origin", "origin-random"):
        b, t = images.shape[:2]
        if mode == "origin-random":
            if noise is None and generator is None:
                raise ValueError("fuse mode origin-random needs `noise` or a generator")
            shape = (b, t, cfg.vision.num_patches, cfg.llama.hidden_size)
            tokens = _uniform(shape, images, noise, generator)
        else:
            flat = images.reshape((b * t,) + tuple(images.shape[2:]))
            with torch.no_grad():
                feats = apply_clip_vision(model.vision, cfg.vision, flat, attn_impl=attn_impl)
            tokens = apply_projector(model.projector, feats)
            tokens = tokens.reshape(b, t, tokens.shape[1], tokens.shape[2])
        attn = torch.ones(tokens.shape[:-1], dtype=torch.bool, device=tokens.device)
    else:
        tokens, attn = fuse_hoi_features(model.hoi_encoder, model.projector, mode, feat,
                                         bbox_feat, valid_mask, noise=noise,
                                         generator=generator)

    b, t, s, _ = tokens.shape
    compressed = pool_video_tokens(tokens, cfg.video_arch)
    if cfg.video_arch in ("all", "none"):
        out_attn = attn.reshape(b, t * s)
    else:
        # pooled modes return all-ones masks in the reference
        # (visual_to_tokens.py:271)
        out_attn = torch.ones(compressed.shape[:-1], dtype=torch.bool,
                              device=compressed.device)
    return compressed, out_attn
