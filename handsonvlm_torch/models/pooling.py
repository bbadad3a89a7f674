"""LITA-style video token compression (slow-fast pooling).

Port of `handsonvlm_tpu/models/pooling.py`: per-frame tokens (B, T, S, D)
compress to the `video_arch` layout. The shipped mode is
`temporal_spatial_pool`: T temporal means + 4 evenly spaced keyframes
2x2-avg-pooled => T + S tokens (356 for T=100, S=256).
"""

from __future__ import annotations

import numpy as np
import torch


def _selected_frames(t: int, n: int = 4) -> np.ndarray:
    # matches np.round(np.linspace(0, t-1, pool_size**2)) in the reference
    return np.round(np.linspace(0, t - 1, n)).astype(int)


def pool_video_tokens(tokens: torch.Tensor, video_arch: str) -> torch.Tensor:
    """tokens (B, T, S, D) -> (B, N_vis, D) per video_arch."""
    b, t, s, d = tokens.shape
    if video_arch in ("all", "none"):
        return tokens.reshape(b, t * s, d)
    if video_arch == "temporal":
        return tokens.mean(dim=2)
    if video_arch == "spatial":
        return tokens.mean(dim=1)
    if video_arch == "temporal_spatial":
        return torch.cat([tokens.mean(dim=2), tokens.mean(dim=1)], dim=1)
    if video_arch in ("temporal_spatial_pool", "spatial_pool"):
        pool = 2
        grid = int(round(s ** 0.5))
        if grid * grid != s:
            raise ValueError(f"patch count {s} is not square")
        sel = torch.as_tensor(_selected_frames(t, pool * pool), device=tokens.device)
        st = tokens[:, sel].reshape(b, pool * pool, grid // 2, 2, grid // 2, 2, d)
        s_tokens = st.mean(dim=(3, 5)).reshape(b, pool * pool * (grid // 2) ** 2, d)
        if video_arch == "spatial_pool":
            return s_tokens
        return torch.cat([tokens.mean(dim=2), s_tokens], dim=1)
    raise ValueError(f"unknown video_arch {video_arch}")
