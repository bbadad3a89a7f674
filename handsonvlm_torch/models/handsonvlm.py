"""HandsOnVLM: video-language model with a hand-trajectory head.

Port of `handsonvlm_tpu/models/handsonvlm.py`:
- visual pipeline: CLIP(select_layer=-2, patch) -> linear projector ->
  video_arch pooling (356 tokens for temporal_spatial_pool @ 100 frames),
  with `frame_map` so only the unique frames are encoded;
- <hand_traj> (id 32100) input embeddings get a sinusoidal coordinate
  encoding of their waypoints added;
- the fixed-shape splice of the visual tokens into the prompt;
- loss = CE(shifted) + hoi_lambda * (lambda_traj * sum_B recon +
  lambda_traj_kl * sum_B KL), hand hidden states taken at the position
  before each <hand_traj> label; `forward` takes the LoRA adapters and the
  remat policy of the train step (train/step.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_torch.models.clip_vit import ClipVision, apply_clip_vision
from handsonvlm_torch.models.llama import Llama, apply_llama, lm_logits
from handsonvlm_torch.models.pooling import pool_video_tokens
from handsonvlm_torch.models.projector import (
    apply_projector,
    build_projector,
    init_projector,
)
from handsonvlm_torch.models.traj_cvae import (
    TrajCVAE,
    traj_decoder_inference,
    traj_decoder_loss,
)

NUM_HAND_TOKENS = 4  # waypoints per answer (4 future steps)


class HandsOnVLM(nn.Module):
    """llama (decoder + head), vision (CLIP), projector, traj (CVAE).
    `quantize` gives the decoder a quantized layout ("int4", "int8", or a
    flat int4 one: `models.llama.QUANTIZE_MODES`)."""

    def __init__(self, cfg: HandsOnVLMConfig, device=None, quantize=None):
        super().__init__()
        factory = {"device": device, "dtype": cfg.pdtype}
        self.llama = Llama(cfg.llama, quantize, **factory)
        self.vision = ClipVision(cfg.vision, **factory)
        self.projector = build_projector(cfg.mm_hidden_size, cfg.llama.hidden_size, **factory)
        self.traj = TrajCVAE(cfg.traj, cfg.llama.hidden_size // 2, **factory)
        self.lora = None  # a models.lora.LoRA once adapters are attached

    def forward(self, cfg: HandsOnVLMConfig, **kwargs) -> Dict[str, torch.Tensor]:
        """The module-level `forward(self, cfg, **kwargs)` as a module call,
        so that hooks on the model (FSDP2's gathers and gradient reduction)
        run around it."""
        return forward(self, cfg, **kwargs)

    def init_weights(self, generator: torch.Generator) -> None:
        self.llama.init_weights(generator)
        self.vision.init_weights(generator)
        init_projector(self.projector, generator)
        self.traj.init_weights(generator)


# ---------------------------------------------------------------------------
# Visual pipeline
# ---------------------------------------------------------------------------


def encode_video(
    model: HandsOnVLM, cfg: HandsOnVLMConfig, images: torch.Tensor, *,
    attn_impl: str = "auto", frame_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, 3, H, W) frames -> (B, N_vis, D) visual tokens.

    `frame_map` int (num_frames,) or (B, num_frames): `images` holds only the
    unique frames and video slot i is frame images[:, frame_map[i]] (or
    images[b, frame_map[b, i]]). Encoding the unique frames and gathering
    their features equals encoding the duplicates. The CLIP tower is frozen
    in every reference recipe: its features carry no gradient (the JAX
    package's stop_gradient), so it runs without a graph, and the projector
    after it still trains."""
    b, t = images.shape[:2]
    flat = images.reshape((b * t,) + tuple(images.shape[2:]))
    with torch.no_grad():
        feats = apply_clip_vision(model.vision, cfg.vision, flat, attn_impl=attn_impl)
    tokens = apply_projector(model.projector, feats)
    tokens = tokens.reshape(b, t, tokens.shape[1], tokens.shape[2])
    if frame_map is not None:
        frame_map = torch.as_tensor(frame_map, device=tokens.device).long()
        if frame_map.dim() == 2:  # per-row maps
            tokens = tokens[torch.arange(b, device=tokens.device)[:, None], frame_map]
        else:
            tokens = tokens[:, frame_map]
    return pool_video_tokens(tokens, cfg.video_arch)


# ---------------------------------------------------------------------------
# Hand-token coordinate embedding
# ---------------------------------------------------------------------------


def traj_positional_embedding(gt_hand: torch.Tensor, token_dim: int) -> torch.Tensor:
    """(..., 2, n, 2) waypoints (right/left hands) -> (..., n, token_dim).

    Sinusoidal x/y encoding per hand; the two hands interleave along the
    feature axis as (token_dim//2, 2), so the decode-side reshape
    hidden(D) -> (D//2, 2) -> (2, D//2) recovers per-hand halves."""
    lead = gt_hand.shape[:-3]
    n = gt_hand.shape[-2]
    channels = token_dim // 4
    flat = gt_hand.reshape(*lead, -1, 2).float()  # (..., 2n, 2) hands-major
    inv_freq = 1.0 / torch.pow(
        torch.tensor(10000.0, device=gt_hand.device),
        torch.arange(0, channels, 2, dtype=torch.float32, device=gt_hand.device) / channels)
    x_enc = flat[..., 0:1] * inv_freq
    y_enc = flat[..., 1:2] * inv_freq
    pos_enc = torch.cat([torch.sin(x_enc), torch.cos(y_enc),
                         torch.sin(x_enc), torch.cos(y_enc)], dim=-1)
    emb = pos_enc.reshape(*lead, 2, n, token_dim // 2)
    return emb.movedim(-3, -1).reshape(*lead, n, token_dim)


def add_hand_coord_embeddings(
    text_embeds: torch.Tensor,  # (B, T, D)
    input_ids: torch.Tensor,  # (B, T)
    future_hands: torch.Tensor,  # (B, 2, n, 2)
    *,
    scale_by_count: bool,
) -> torch.Tensor:
    """Add the k-th waypoint's encoding at the k-th <hand_traj> position
    (k < n; later hand tokens get nothing). With `scale_by_count` (the
    training path) the encodings are scaled by hand_token_count / n."""
    d = text_embeds.shape[-1]
    n = future_hands.shape[2]
    mask = input_ids == HAND_TOKEN_ID
    rank = mask.long().cumsum(dim=1) - 1  # k for the k-th hand token
    emb = traj_positional_embedding(future_hands, d)  # (B, n, D)
    if scale_by_count:
        emb = emb * (mask.sum(dim=1).float() / n)[:, None, None]
    idx = rank.clamp(0, n - 1)[..., None].expand(-1, -1, d)
    add = torch.where((mask & (rank < n))[..., None], torch.gather(emb, 1, idx), 0.0)
    return text_embeds + add.to(text_embeds.dtype)


# ---------------------------------------------------------------------------
# Fixed-shape multimodal splice
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SplicedBatch:
    embeds: torch.Tensor  # (B, T_out, D)
    attn_mask: torch.Tensor  # (B, T_out) bool
    labels: Optional[torch.Tensor]  # (B, T_out)
    hand_mask: Optional[torch.Tensor]  # (B, T_out) labels == hand token


def splice_visual_tokens(
    text_embeds: torch.Tensor,  # (B, T, D)
    input_ids: torch.Tensor,  # (B, T) with one IMAGE_TOKEN_INDEX sentinel
    visual_tokens: torch.Tensor,  # (B, N, D)
    visual_attn: Optional[torch.Tensor] = None,  # (B, N) bool
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    labels: Optional[torch.Tensor] = None,  # (B, T)
) -> SplicedBatch:
    """Replace the image sentinel with N visual tokens; the output length is
    always T + N - 1. Samples without a sentinel keep their text at the
    front and the tail is padding (attn 0, labels IGNORE)."""
    b, t, d = text_embeds.shape
    n = visual_tokens.shape[1]
    dev = text_embeds.device
    if attn_mask is None:
        attn_mask = torch.ones((b, t), dtype=torch.bool, device=dev)
    if visual_attn is None:
        visual_attn = torch.ones((b, n), dtype=torch.bool, device=dev)

    is_img = input_ids == IMAGE_TOKEN_INDEX
    has_img = is_img.any(dim=1)
    img_pos = torch.where(has_img, is_img.int().argmax(dim=1), t)  # first sentinel

    j = torch.arange(t + n - 1, device=dev)[None, :]
    ip = img_pos[:, None]
    before = j < ip
    in_vis = (j >= ip) & (j < ip + n) & has_img[:, None]
    text_idx = torch.where(before, j, j - (n - 1))
    vis_idx = (j - ip).clamp(0, n - 1)
    valid_text = ~in_vis & (text_idx >= 0) & (text_idx < t) & (before | (j >= ip + n))
    text_idx = text_idx.clamp(0, t - 1)

    bidx = torch.arange(b, device=dev)[:, None]
    embeds = torch.where(
        in_vis[..., None],
        visual_tokens[bidx, vis_idx],
        torch.where(valid_text[..., None], text_embeds[bidx, text_idx], 0.0),
    )
    out_attn = torch.where(in_vis, visual_attn[bidx, vis_idx],
                           valid_text & attn_mask.bool()[bidx, text_idx])

    out_labels = hand_mask = None
    if labels is not None:
        out_labels = torch.where(in_vis | ~valid_text, IGNORE_INDEX, labels[bidx, text_idx])
        hand_mask = out_labels == HAND_TOKEN_ID
    return SplicedBatch(embeds, out_attn, out_labels, hand_mask)


# ---------------------------------------------------------------------------
# Hand hidden-state extraction
# ---------------------------------------------------------------------------


def extract_hand_embeddings(
    hidden: torch.Tensor,  # (B, T', D): positions [start, start + T')
    labels: torch.Tensor,  # (B, T)
    future_valid: torch.Tensor,  # (B, 2)
    start=0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden states at the positions predicting the first 4 <hand_traj>
    labels -> ((B, 2, 4, D//2), future_valid). A row with no hand token
    gets zeros and future_valid 0. `hidden` may hold a block of positions
    from `start` on (a rank's rows of a sequence spread over ranks); a
    hand position outside it gives zeros."""
    b, tl, d = hidden.shape
    mask = labels == HAND_TOKEN_ID
    # position p predicts label p+1: shift left, pad False
    shifted = torch.cat([mask[:, 1:], torch.zeros((b, 1), dtype=torch.bool,
                                                   device=mask.device)], dim=1)
    rank = shifted.long().cumsum(dim=1) - 1
    rows, cols = torch.nonzero(shifted & (rank < NUM_HAND_TOKENS), as_tuple=True)
    pos = torch.zeros((b, NUM_HAND_TOKENS), dtype=torch.long, device=hidden.device)
    pos[rows, rank[rows, cols]] = cols
    here = (pos >= start) & (pos < start + tl)
    emb = hidden[torch.arange(b, device=hidden.device)[:, None],
                 (pos - start).clamp(0, tl - 1)]  # (B, 4, D)
    emb = torch.where(here[..., None], emb, 0.0)
    emb = emb.reshape(b, NUM_HAND_TOKENS, d // 2, 2).permute(0, 3, 1, 2)
    ok = shifted.any(dim=1)
    emb = torch.where(ok[:, None, None, None], emb, 0.0)
    return emb, future_valid * ok[:, None].to(future_valid.dtype)


# ---------------------------------------------------------------------------
# Teacher-forced forward (forward pass and loss only)
# ---------------------------------------------------------------------------


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Each position's target: the next label; the last position gets none."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE summed over the non-ignored targets and divided by `count` (by
    default their number: HF CrossEntropyLoss's mean)."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    if count is None:
        count = valid.sum()
    return (nll * valid).sum() / count.clamp(min=1)


def forward(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, T)
    attn_mask: Optional[torch.Tensor],  # (B, T)
    images: torch.Tensor,  # (B, T_frames, 3, H, W)
    labels: Optional[torch.Tensor] = None,  # (B, T)
    future_hands: Optional[torch.Tensor] = None,  # (B, 2, 5, 2) incl. last obs
    future_valid: Optional[torch.Tensor] = None,  # (B, 2)
    eps: Optional[torch.Tensor] = None,  # CVAE noise (B*2*4, latent)
    generator: Optional[torch.Generator] = None,
    attn_impl: str = "auto",
    lora=None,
    remat=False,
    frame_map: Optional[torch.Tensor] = None,
    data_parallel: bool = False,
    seq=None,
    tp=None,
    data_group=None,
) -> Dict[str, torch.Tensor]:
    """Teacher-forced forward: logits, hidden, and with labels the losses.

    Drops the last-observed waypoint (future_hands[:, :, 1:]), splices the
    visual tokens, adds gt coordinate embeddings at <hand_traj> inputs, runs
    the decoder, computes shifted CE + CVAE losses. `lora` (default: the
    model's attached `model.lora`) and `remat` go to `apply_llama`;
    `frame_map` (the unique frames' slot map) goes to `encode_video`.

    `data_parallel`: the batch is spread over the ranks of the default
    group (train/step.py), each holding some of its rows, and the losses
    are this rank's share, the shares of all ranks summing to the whole
    batch's: the CE's target count and the KL quirk's valid count are
    summed over the ranks of `data_group` (None: the default group; on a
    ('data', 'model') mesh the data axis's, whose ranks hold other rows,
    while the ranks of a model group hold the same). `tp` (a
    `parallel.tp.TPGroup`) runs the decoder's tensor-parallel shard. `seq` (a mesh with a 'seq' axis) also spreads
    the positions: the decoder runs on this rank's T/P of them with ring
    attention (logits and hidden are then those positions'), the hand
    hidden states are summed over the ring from the rank holding each, and
    the CVAE terms, which every rank of a ring computes for the same rows,
    are divided by P."""
    train = labels is not None
    if train:
        future_hands = future_hands[:, :, 1:]

    text_embeds = model.llama.embed_tokens(torch.where(input_ids < 0, 0, input_ids))
    if train:
        text_embeds = add_hand_coord_embeddings(
            text_embeds, input_ids, future_hands, scale_by_count=True)

    visual = encode_video(model, cfg, images, attn_impl=attn_impl,
                          frame_map=frame_map).to(text_embeds.dtype)
    sp = splice_visual_tokens(text_embeds, input_ids, visual, attn_mask=attn_mask,
                              labels=labels)
    embeds, mask, positions = sp.embeds, sp.attn_mask, None
    targets = shift_labels(sp.labels) if train else None
    n_seq, start = 1, 0
    if seq is not None:
        from handsonvlm_torch.parallel.mesh import mesh_shape
        from handsonvlm_torch.parallel.ring_attention import shard_sequence

        b, t = embeds.shape[:2]
        positions = torch.arange(t, device=embeds.device)[None].expand(b, t)
        embeds, mask, positions = (shard_sequence(x, seq) for x in (embeds, mask, positions))
        targets = shard_sequence(targets, seq) if train else None
        n_seq, start = mesh_shape(seq)["seq"], positions[0, 0]
    hidden, _ = apply_llama(model.llama, cfg.llama, inputs_embeds=embeds, attn_mask=mask,
                            positions=positions, attn_impl=attn_impl,
                            lora=model.lora if lora is None else lora, remat=remat, seq=seq,
                            tp=tp)
    logits = lm_logits(model.llama, cfg.llama, hidden)

    out = {"logits": logits, "hidden": hidden}
    if train:
        from handsonvlm_torch.parallel.distributed import all_reduce_sum, all_reduce_sum_grad

        count = kl_valid = None
        if data_parallel:
            count = all_reduce_sum((targets != IGNORE_INDEX).sum().float(), data_group)
        text_loss = cross_entropy(logits, targets, count)
        emb, fv = extract_hand_embeddings(hidden, sp.labels, future_valid, start=start)
        if seq is not None:
            emb = all_reduce_sum_grad(emb, seq.get_group("seq"))
        if data_parallel:
            kl_valid = all_reduce_sum(fv.float().sum(), data_group) / n_seq
        losses = traj_decoder_loss(
            model.traj, cfg.traj, emb, future_hands, fv,
            cfg.lambda_traj, cfg.lambda_traj_kl, eps=eps, generator=generator,
            kl_valid=kl_valid)
        traj, kl = losses["traj_loss"] / n_seq, losses["traj_kl_loss"] / n_seq
        out.update(text_loss=text_loss, traj_loss=traj, traj_kl_loss=kl, total_loss=traj + kl,
                   loss=cfg.hoi_lambda * (traj + kl) + text_loss)
    return out


# ---------------------------------------------------------------------------
# Decode-time pieces (used by infer/sampler.py)
# ---------------------------------------------------------------------------


def decode_hand_waypoint(
    model: HandsOnVLM, cfg: HandsOnVLMConfig, last_hidden: torch.Tensor, *,
    z: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """hidden (B, D) at the position that predicted <hand_traj> -> (B, 2, 2)
    waypoint for both hands."""
    b, d = last_hidden.shape
    emb = last_hidden.reshape(b, d // 2, 2).permute(0, 2, 1)[:, :, None, :]  # (B,2,1,D//2)
    pred = traj_decoder_inference(model.traj, cfg.traj, emb, z=z, generator=generator)
    return pred[:, :, 0, :]


def embed_next_token(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    token: torch.Tensor,  # (B,) next input token ids
    last_waypoint: torch.Tensor,  # (B, 2, 2) waypoint decoded for this token
) -> torch.Tensor:
    """Embedding of a decode-step input token; a <hand_traj> token gets the
    coordinate encoding of its own (just decoded) waypoint added."""
    d = cfg.llama.hidden_size
    emb = model.llama.embed_tokens(token)  # (B, D)
    coord = traj_positional_embedding(last_waypoint[:, :, None, :], d)[:, 0]  # (B, D)
    add = torch.where((token == cfg.hand_token_id)[:, None], coord, 0.0)
    return emb + add.to(emb.dtype)
