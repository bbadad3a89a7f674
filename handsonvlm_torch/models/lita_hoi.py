"""LITA-HOI model family: LLM-encoded hoi features + transformer heads.

Port of `handsonvlm_tpu/models/lita_hoi.py` (the reference's
lita_llama_hoi.py:18-423, the earlier HandsOnVLM architecture): the Vicuna
decoder *encodes* the fused hoi visual tokens (video_arch 'none', fuse
modes 'hoi' / 'hoi-hand' / 'hoi-global'), and the hidden states of the last
observed frame's tokens feed an ObjectTransformer decoder + TrajCVAE +
AffordanceCVAE stack, teacher-forced in training and rolled out
autoregressively at inference.

Kept from the JAX package: the contact-loss validity gate is per element
(`obj_loss[~(future_valid > 0)] = 1e9`, lita_llama_hoi.py:173) where the
standalone ObjectTransformer gates on the batch-global sum; the KL is the
whole-batch sum scaled by the valid counts; the lambda weights come from
the config (obj_kl_loss is weighted by `lambda_traj_kl`, as in JAX) and
the total is scaled by `hoi_lambda`.

The decoder runs through the port's `apply_llama` with the caller's
`attn_impl`, a key mask over the B x (T*S) fused tokens and causal
attention: under "flash" on the card each layer's attention is kernel B3
and its backward B3b. `LitaHoi` takes an existing `Llama` (a loaded
HandsOnVLM's decoder) or builds its own. The draws are injectable as in
`models.object_transformer` (`eps`, `z`) and `models.visual_tokens`
(`noise`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.models.llama import Llama, apply_llama
from handsonvlm_torch.models.object_transformer import (
    AffordanceHead,
    HandHead,
    Heads,
    ObjectTransformerConfig,
    ObjectTransformerDecoder,
    init_transformer_weights,
    rollout,
    select_contact,
    select_contact_losses,
    teacher_forced_losses,
)
from handsonvlm_torch.models.projector import build_projector
from handsonvlm_torch.models.visual_tokens import HoiEncoder, visual_pipeline


def _oct_cfg(cfg: HandsOnVLMConfig) -> ObjectTransformerConfig:
    return ObjectTransformerConfig(
        token_dim=cfg.llama.hidden_size,
        coord_dim=64,
        num_heads=8,
        dec_depth=4,
        hidden_dim=cfg.traj.hidden_dim,
        latent_dim=cfg.traj.latent_dim,
        z_scale=cfg.traj.z_scale,
    )


class LitaHoi(nn.Module):
    """llama (the decoder), hoi_encoder, projector, oct_decoder, hand_head,
    affordance, last_obs_rhand / last_obs_lhand: the JAX tree's keys."""

    def __init__(self, cfg: HandsOnVLMConfig, llama: Optional[Llama] = None, device=None):
        super().__init__()
        factory = {"device": device, "dtype": cfg.pdtype}
        oct_cfg = _oct_cfg(cfg)
        d = cfg.llama.hidden_size
        self.llama = llama if llama is not None else Llama(cfg.llama, **factory)
        self.hoi_encoder = HoiEncoder(**factory)
        self.projector = build_projector(cfg.mm_hidden_size, d, **factory)
        self.oct_decoder = ObjectTransformerDecoder(oct_cfg, **factory)
        self.hand_head = HandHead(oct_cfg, **factory)
        self.affordance = AffordanceHead(oct_cfg, **factory)
        self.last_obs_rhand = nn.Linear(d, d, **factory)
        self.last_obs_lhand = nn.Linear(d, d, **factory)

    def heads(self) -> Heads:
        return Heads(self.oct_decoder, self.hand_head.cvae, self.affordance,
                     self.last_obs_rhand, self.last_obs_lhand)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, init_llama: bool = True) -> None:
        """The JAX package's init of every part but, with init_llama=False,
        the decoder (a loaded one stays as it is): the projector N(0, 0.02)
        with zero bias, the hoi encoder uniform, the transformer heads as
        the ObjectTransformer's."""
        if init_llama:
            self.llama.init_weights(generator)
        self.hoi_encoder.init_weights(generator)
        self.projector.weight.normal_(0.0, 0.02, generator=generator)
        self.projector.bias.zero_()
        for part in (self.oct_decoder, self.hand_head, self.affordance, self.last_obs_rhand,
                     self.last_obs_lhand):
            init_transformer_weights(part, generator)


def _last_hidden_state(cfg: HandsOnVLMConfig, hidden, valid_mask):
    """_get_last_hidden_state (lita_llama_hoi.py:79-95): the trailing tokens
    of the sequence are the last observed frame's streams."""
    mode = cfg.fuse_input_mode
    last_frame_mask = valid_mask[:, :, -1]  # (B, 5)
    if mode.startswith("hoi-hand"):
        last, mask = hidden[:, -3:, :], last_frame_mask[:, :3]
    elif mode.startswith("hoi-global"):
        last, mask = hidden[:, -1:, :], last_frame_mask[:, :1]
    elif mode.startswith("hoi"):
        last, mask = hidden[:, -5:, :], last_frame_mask
    else:
        raise NotImplementedError(mode)
    return last, (mask != 0)[:, None, :]  # (B, 1, N)


def _encode(model: LitaHoi, cfg: HandsOnVLMConfig, feat, bbox_feat, valid_mask, *,
            noise=None, generator=None, attn_impl: str = "auto"):
    if cfg.video_arch not in ("none", "all"):
        raise ValueError(f"lita-hoi requires video_arch 'none', got {cfg.video_arch!r}")
    visual_tokens, visual_attn = visual_pipeline(
        model, cfg, feat=feat, bbox_feat=bbox_feat, valid_mask=valid_mask, noise=noise,
        generator=generator, attn_impl=attn_impl)
    hidden, _ = apply_llama(model.llama, cfg.llama, inputs_embeds=visual_tokens,
                            attn_mask=visual_attn, attn_impl=attn_impl)
    return _last_hidden_state(cfg, hidden, valid_mask)


def lita_hoi_forward(
    model: LitaHoi, cfg: HandsOnVLMConfig, batch: Dict, *,
    eps: Optional[Dict[str, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    lambda_obj=0.1, lambda_obj_kl=1e-3, lambda_last_hand=1e-3,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss (forward + forward_decoder_and_get_loss). `eps` as
    `object_transformer.teacher_forced_losses` takes it; `noise` the
    '-random' ablation's tokens. `lambda_obj_kl` is unused, as in the JAX
    package (the contact KL takes cfg.lambda_traj_kl)."""
    oct_cfg = _oct_cfg(cfg)
    last_hidden, memory_mask = _encode(model, cfg, batch["feat"], batch["bbox_feat"],
                                       batch["valid_mask"], noise=noise, generator=generator,
                                       attn_impl=attn_impl)
    future_valid = batch["future_valid"]
    parts = teacher_forced_losses(model.heads(), oct_cfg, last_hidden, memory_mask,
                                  batch["future_hands"], batch["contact_point"], future_valid,
                                  eps=eps, generator=generator)
    # per-element validity gate (lita_llama_hoi.py:173)
    obj_loss = torch.where(future_valid > 0, parts["obj"], 1e9)
    sel_obj, sel_kl, sel_last = select_contact_losses(obj_loss, parts["obj_kl"],
                                                      parts["last_hand"], future_valid)
    losses = {
        "obj_loss": lambda_obj * sel_obj.sum(),
        "obj_kl_loss": cfg.lambda_traj_kl * sel_kl.sum(),
        "traj_loss": cfg.lambda_traj * parts["traj_loss"].sum(),
        "traj_kl_loss": cfg.lambda_traj_kl * parts["traj_kl_loss"].sum(),
        "last_hand_loss": lambda_last_hand * sel_last.sum(),
    }
    losses["hoi_forecast_loss"] = sum(losses.values())
    return cfg.hoi_lambda * losses["hoi_forecast_loss"], losses


def lita_hoi_inference(
    model: LitaHoi, cfg: HandsOnVLMConfig, batch: Dict, pred_len: int = 4, *,
    z: Optional[Dict[str, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    attn_impl: str = "auto",
):
    """Autoregressive rollout (lita_llama_hoi.py:294-404). `z` as
    `object_transformer.rollout` takes it. The contact is the hand's whose
    trajectory passes nearer its contact point, hands valid by
    `gt_hand_valid` (B, 2, T) when the batch holds it, else the right
    hand's.

    Returns (pred_hand (B, 2, pred_len, 2), pred_contact (B, 2))."""
    last_hidden, memory_mask = _encode(model, cfg, batch["feat"], batch["bbox_feat"],
                                       batch["valid_mask"], noise=noise, generator=generator,
                                       attn_impl=attn_impl)
    pred_hand, pred_contact = rollout(model.heads(), _oct_cfg(cfg), last_hidden, memory_mask,
                                      pred_len, z=z, generator=generator)
    gt_valid = batch.get("gt_hand_valid")
    if gt_valid is None:
        return pred_hand, pred_contact[:, 0]
    traj_valid = torch.as_tensor(gt_valid, device=pred_hand.device).bool().any(dim=-1).float()
    return pred_hand, select_contact(pred_hand, pred_contact, traj_valid)
