"""Multimodal projector: CLIP feature space -> decoder embedding space.

Port of `handsonvlm_tpu/models/projector.py`: the reference's single
`mm_projector = nn.Linear(1024, hidden)`.
"""

from __future__ import annotations

import torch
from torch import nn


def build_projector(in_dim: int, out_dim: int, **factory) -> nn.Linear:
    return nn.Linear(in_dim, out_dim, **factory)


@torch.no_grad()
def init_projector(proj: nn.Linear, generator: torch.Generator) -> None:
    """Random init like the JAX package: uniform(-1, 1) / sqrt(in), zero bias."""
    proj.weight.uniform_(-1.0, 1.0, generator=generator)
    proj.weight.mul_(1.0 / proj.in_features ** 0.5)
    proj.bias.zero_()


def apply_projector(proj: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return proj(x)
