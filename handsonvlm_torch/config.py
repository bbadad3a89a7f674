"""Configuration dataclasses for the PyTorch port.

Field-for-field the same frozen dataclasses and presets as
`handsonvlm_tpu/core/config.py` (Vicuna-7B/13B-v1.3 + CLIP ViT-L/14), so a
configuration means the same model in both packages. `pdtype`/`cdtype`
return torch dtypes. `pad_vocab_multiple` is kept for equality with the
JAX presets only: the port's embedding and head tables keep `vocab_size`
rows (the pad was a TPU sharding layout that `lm_logits` masked anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder (Vicuna/LLaMA) architecture config."""

    vocab_size: int = 32101  # 32000 base + 100 time tokens + <hand_traj>
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA (vicuna v1.3)
    head_dim: Optional[int] = None  # None -> hidden_size // num_heads
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    pad_vocab_multiple: int = 0

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m if m else self.vocab_size

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower config (ViT-L/14, 224px)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # penultimate layer, patch tokens only (CLS dropped)
    select_layer: int = -2
    select_feature: str = "patch"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class TrajDecoderConfig:
    """CVAE hand-trajectory head config (token_dim = llm_hidden // 2)."""

    kind: str = "CVAE"  # "CVAE" | "MLP"
    hidden_dim: int = 512
    latent_dim: int = 256
    coord_dim: int = 64
    z_scale: float = 2.0
    condition_contact: bool = False


@dataclasses.dataclass(frozen=True)
class HandsOnVLMConfig:
    """Full model: vision tower + projector + decoder + trajectory head."""

    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    traj: TrajDecoderConfig = dataclasses.field(default_factory=TrajDecoderConfig)

    num_frames: int = 100
    # 'all' | 'temporal' | 'spatial' | 'temporal_spatial' |
    # 'temporal_spatial_pool' | 'spatial_pool'
    video_arch: str = "temporal_spatial_pool"
    fuse_input_mode: str = "origin"
    mm_hidden_size: int = 1024

    lambda_traj: float = 1.0
    lambda_traj_kl: float = 1e-3
    hoi_lambda: float = 1.0

    hand_token_id: int = 32100
    image_token_index: int = -200
    ignore_index: int = -100
    max_length: int = 2048

    # bf16 params+activations at 7B/13B; fp32 softmax/norm/logits always
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def num_visual_tokens(self) -> int:
        """Visual tokens produced by `video_arch` for `num_frames` input."""
        s = self.vision.num_patches
        t = self.num_frames
        return {
            "all": t * s,
            "temporal": t,
            "spatial": s,
            "temporal_spatial": t + s,
            "temporal_spatial_pool": t + s,
            "spatial_pool": s,
        }[self.video_arch]


def tiny_config(**overrides) -> HandsOnVLMConfig:
    """A small-but-complete config for tests: full architecture, tiny dims."""
    base = HandsOnVLMConfig(
        llama=LlamaConfig(
            vocab_size=32101,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            max_position_embeddings=2048,
        ),
        vision=ClipVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
            image_size=56,
            patch_size=14,
        ),
        traj=TrajDecoderConfig(hidden_dim=32, latent_dim=16, coord_dim=8),
        num_frames=8,
        mm_hidden_size=32,
        max_length=256,
    )
    return dataclasses.replace(base, **overrides)


def vicuna_7b_config(**overrides) -> HandsOnVLMConfig:
    base = HandsOnVLMConfig(
        llama=LlamaConfig(
            hidden_size=4096,
            intermediate_size=11008,
            num_layers=32,
            num_heads=32,
            pad_vocab_multiple=128,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
    return dataclasses.replace(base, **overrides)


def vicuna_13b_config(**overrides) -> HandsOnVLMConfig:
    base = HandsOnVLMConfig(
        llama=LlamaConfig(
            hidden_size=5120,
            intermediate_size=13824,
            num_layers=40,
            num_heads=40,
            pad_vocab_multiple=128,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
    return dataclasses.replace(base, **overrides)


def tiny224_config(**overrides) -> HandsOnVLMConfig:
    """Tiny transformer dims at the real data interface: 224px frames, 100
    frame slots, 356 visual tokens."""
    base = tiny_config(
        vision=ClipVisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
            image_size=224,
            patch_size=14,
        ),
        num_frames=100,
        max_length=2048,
    )
    return dataclasses.replace(base, **overrides)


def llama_1b_config(**overrides) -> HandsOnVLMConfig:
    """~1B decoder at the real data interface (a measurement preset)."""
    base = HandsOnVLMConfig(
        llama=LlamaConfig(
            hidden_size=2048,
            intermediate_size=5504,
            num_layers=16,
            num_heads=16,
            pad_vocab_multiple=128,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
    return dataclasses.replace(base, **overrides)


def graft_config(**overrides) -> HandsOnVLMConfig:
    """Architecture-complete, small shape of `__graft_entry__._config('graft')`."""
    base = HandsOnVLMConfig(
        llama=LlamaConfig(
            vocab_size=32101, hidden_size=256, intermediate_size=512,
            num_layers=4, num_heads=8,
        ),
        vision=ClipVisionConfig(
            hidden_size=128, intermediate_size=256, num_layers=4,
            num_heads=4, image_size=56, patch_size=14,
        ),
        traj=TrajDecoderConfig(hidden_dim=64, latent_dim=32, coord_dim=16),
        num_frames=16,
        mm_hidden_size=128,
    )
    return dataclasses.replace(base, **overrides)


PRESETS = {
    "tiny": tiny_config,
    "tiny224": tiny224_config,
    "1b": llama_1b_config,
    "7b": vicuna_7b_config,
    "13b": vicuna_13b_config,
    "graft": graft_config,
}


def get_config(name: str, **overrides) -> HandsOnVLMConfig:
    return PRESETS[name](**overrides)
