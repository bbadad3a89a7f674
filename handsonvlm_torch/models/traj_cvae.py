"""CVAE hand-trajectory head.

Port of `handsonvlm_tpu/models/traj_cvae.py` (the CVAE kind, which every
released checkpoint ships) with the reference's parameter names
(`hand_traj_decoder.hand_traj_decoder.cvae.*`): a conditional encoder ->
(mean, log_var) -> reparameterised z -> decoder, per-sample
sum-of-squares recon loss and analytic KL. The condition is one hand's half
of the hand-token hidden state (token_dim = llm_hidden // 2).

Random draws come from a passed `torch.Generator`; `cvae_inference` takes
the latent `z` and `cvae_forward` the noise `eps` directly when given, so a
test can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from handsonvlm_torch.config import TrajDecoderConfig


class TrajCVAE(nn.Module):
    def __init__(self, cfg: TrajDecoderConfig, token_dim: int, **factory):
        super().__init__()
        if cfg.kind != "CVAE":
            raise NotImplementedError(
                f"traj head {cfg.kind!r}: the port has the CVAE head only")
        in_dim = 2  # (x, y) waypoint
        self.enc_MLP = nn.Sequential(
            nn.Linear(in_dim + token_dim, cfg.hidden_dim, **factory), nn.ELU())
        self.linear_means = nn.Linear(cfg.hidden_dim, cfg.latent_dim, **factory)
        self.linear_log_var = nn.Linear(cfg.hidden_dim, cfg.latent_dim, **factory)
        self.dec_MLP = nn.Sequential(
            nn.Linear(cfg.latent_dim + token_dim, cfg.hidden_dim, **factory),
            nn.ELU(),
            nn.Linear(cfg.hidden_dim, in_dim, **factory),
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """uniform(-1/sqrt(in), 1/sqrt(in)) weights and biases, as in JAX."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


def _cvae_decode(cvae: TrajCVAE, z, cond):
    return cvae.dec_MLP(torch.cat([z, cond], dim=-1))


def cvae_forward(
    cvae: TrajCVAE,
    gt: torch.Tensor,  # (N, 2)
    cond: torch.Tensor,  # (N, token_dim)
    *,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (recon, per-sample recon_loss, per-sample KLD)."""
    h = cvae.enc_MLP(torch.cat([gt, cond], dim=-1))
    mean, log_var = cvae.linear_means(h), cvae.linear_log_var(h)
    std = torch.exp(0.5 * log_var)
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
    z = mean + eps.to(std.dtype) * std
    recon = _cvae_decode(cvae, z, cond)
    recon_loss = ((recon - gt) ** 2).sum(dim=1)
    kld = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum(dim=1)
    return recon, recon_loss, kld


def cvae_inference(
    cvae: TrajCVAE,
    cfg: TrajDecoderConfig,
    cond: torch.Tensor,  # (N, token_dim)
    *,
    z: Optional[torch.Tensor] = None,  # (N, latent_dim), already scaled
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """z ~ z_scale * N(0, I) unless given; decode -> (N, 2)."""
    if z is None:
        z = cfg.z_scale * torch.randn((cond.shape[0], cfg.latent_dim),
                                      generator=generator, device=cond.device,
                                      dtype=cond.dtype)
    return _cvae_decode(cvae, z.to(cond.dtype), cond)


def traj_decoder_loss(
    cvae: TrajCVAE,
    cfg: TrajDecoderConfig,
    pred_hand_embeddings: torch.Tensor,  # (B, 2, T_pred, token_dim)
    future_hands: torch.Tensor,  # (B, 2, T_pred, 2)
    future_valid: torch.Tensor,  # (B, 2)
    lambda_traj: float,
    lambda_traj_kl: float,
    *,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    kl_valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """`kl_valid`, when given, is the valid count of the whole batch the KL
    quirk below multiplies by, for a rank that holds some of its rows
    (train/step.py under data parallelism): the rank's share of the KL
    term is then lambda_traj_kl * sum(its KLD) * kl_valid."""
    b, _, t_pred, token_dim = pred_hand_embeddings.shape
    cond = pred_hand_embeddings.reshape(-1, token_dim)
    gt = future_hands.reshape(-1, 2).to(cond.dtype)
    valid = future_valid.float()
    _, recon, kld = cvae_forward(cvae, gt, cond, eps=eps, generator=generator)
    recon = recon.reshape(b, 2, t_pred).float()
    # reference quirk (traj_decoder.py:66): the KL is summed over the WHOLE
    # flattened batch and scaled by each sample's valid count, not masked
    # per sample like the recon term
    traj_per_b = (recon.sum(-1) * valid).sum(1)
    traj_loss = lambda_traj * traj_per_b.sum()
    if kl_valid is None:
        kl_loss = lambda_traj_kl * (kld.float().sum() * valid.sum(1)).sum()
    else:
        kl_loss = lambda_traj_kl * (kld.float().sum() * kl_valid)
    return {"traj_loss": traj_loss, "traj_kl_loss": kl_loss,
            "total_loss": traj_loss + kl_loss}


def traj_decoder_inference(
    cvae: TrajCVAE,
    cfg: TrajDecoderConfig,
    pred_hand_embeddings: torch.Tensor,  # (B, 2, T_pred, token_dim)
    *,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """-> (B, 2, T_pred, 2) waypoints."""
    b, _, t_pred, token_dim = pred_hand_embeddings.shape
    cond = pred_hand_embeddings.reshape(-1, token_dim)
    pred = cvae_inference(cvae, cfg, cond, z=z, generator=generator)
    return pred.reshape(b, 2, t_pred, 2)
