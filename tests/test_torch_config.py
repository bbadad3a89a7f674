"""The port's presets equal the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from __graft_entry__ import _config as jax_graft_config
from handsonvlm_tpu.core.config import get_config as jax_get_config
from handsonvlm_torch.config import get_config


def _same(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("num_visual_tokens",):
        assert getattr(port, prop) == getattr(ref, prop)
    for sub in ("llama", "vision"):
        p, r = getattr(port, sub), getattr(ref, sub)
        for prop in {"llama": ("padded_vocab_size", "kv_heads", "head_dim_"),
                     "vision": ("num_patches", "grid_size")}[sub]:
            assert getattr(p, prop) == getattr(r, prop), (sub, prop)
    assert port.pdtype == getattr(torch, str(ref.pdtype))
    assert port.cdtype == getattr(torch, str(ref.cdtype))


@pytest.mark.parametrize("preset", ["tiny", "tiny224", "1b", "7b", "13b"])
def test_preset_matches_jax(preset):
    _same(get_config(preset), jax_get_config(preset))


def test_graft_shape_matches_entry():
    _same(get_config("graft"), jax_graft_config("graft"))


def test_overrides_apply_like_jax():
    _same(get_config("tiny", num_frames=16, video_arch="spatial_pool"),
          jax_get_config("tiny", num_frames=16, video_arch="spatial_pool"))
