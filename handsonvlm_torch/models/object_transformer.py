"""hoi-forecast ObjectTransformer stack (encoder-decoder + CVAE heads).

Port of `handsonvlm_tpu/models/object_transformer.py`:

- a joint space-time encoder over 5 patch streams (global / hands /
  objects) with a learned space pos-embed plus a sinusoidal time encoding,
  pre-norm blocks and a key pad mask filled with -1e30;
- the coordinate decoder: (x, y) -> token embedding, causal self-attention,
  then cross-attention to the last observed frame's tokens. The reference's
  DecoderBlock feeds its MLP from the *second* norm's output rather than
  norm3 (layer.py:148), and norm3 is present but unused: kept;
- the TrajCVAE hand head (`models.traj_cvae`) and the AffordanceCVAE
  contact head conditioned on the global token and a trajectory;
- the training losses with the min-hand contact selection and the
  last-observation hand-embedding MSE (object_transformer.py:302-338);
- the autoregressive coordinate rollout with contact selection at
  inference (object_transformer.py:340-425). As in the JAX package, each
  step runs the decoder at the final length under the causal mask and
  reads one position.

The modules carry the reference checkpoint's names (`downproject`,
`oct_encoder.encoder_blocks.<i>.attn.proj_q`, `object_head.cvae.enc_MLP.0`,
...), so a reference state dict loads by name (`convert.object_transformer`).
Attention here is the JAX package's plain einsum, not a kernel: 50 tokens a
clip, and a head size (token_dim / 8) no attention kernel takes at 7B width.

Random draws come from a passed `torch.Generator`, or are passed in whole:
`eps` (the training reparameterisation noise) and `z` (the inference
latents, already scaled by z_scale), so a test can feed both packages the
same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from handsonvlm_torch.config import TrajDecoderConfig
from handsonvlm_torch.models.traj_cvae import TrajCVAE, cvae_forward, cvae_inference

MASK_VALUE = -1e30
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ObjectTransformerConfig:
    src_in_features: int = 1024
    trg_in_features: int = 2
    num_patches: int = 5
    token_dim: int = 512
    coord_dim: int = 64
    num_heads: int = 8
    enc_depth: int = 6
    dec_depth: int = 4
    mlp_ratio: float = 4.0
    hidden_dim: int = 512  # CVAE heads
    latent_dim: int = 256
    pred_len: int = 4
    z_scale: float = 2.0
    global_only: bool = False  # ObjectTransformer_global variant

    def head_cfg(self) -> TrajDecoderConfig:
        return TrajDecoderConfig(kind="CVAE", hidden_dim=self.hidden_dim,
                                 latent_dim=self.latent_dim, coord_dim=self.coord_dim,
                                 z_scale=self.z_scale)


# ---------------------------------------------------------------------------
# Modules (the reference's names)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    """layer.py:48-82: separate q / k / v projections without bias, an
    output projection with bias."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.proj_q = nn.Linear(dim, dim, bias=False, **factory)
        self.proj_k = nn.Linear(dim, dim, bias=False, **factory)
        self.proj_v = nn.Linear(dim, dim, bias=False, **factory)
        self.proj = nn.Linear(dim, dim, **factory)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **factory)
        self.fc2 = nn.Linear(hidden, dim, **factory)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        d = cfg.token_dim
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS, **factory)
        self.attn = MultiHeadAttention(d, **factory)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS, **factory)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), **factory)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        d = cfg.token_dim
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS, **factory)
        self.self_attn = MultiHeadAttention(d, **factory)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS, **factory)
        self.enc_dec_attn = MultiHeadAttention(d, **factory)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS, **factory)  # present but unused (quirk)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), **factory)


class ObjectTransformerEncoder(nn.Module):
    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros((1, cfg.num_patches, cfg.token_dim), **factory))
        self.encoder_blocks = nn.ModuleList(EncoderBlock(cfg, **factory)
                                            for _ in range(cfg.enc_depth))
        self.norm = nn.LayerNorm(cfg.token_dim, eps=LN_EPS, **factory)


class ObjectTransformerDecoder(nn.Module):
    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        self.target_embedding = nn.Linear(cfg.trg_in_features, cfg.token_dim, **factory)
        self.decoder_blocks = nn.ModuleList(DecoderBlock(cfg, **factory)
                                            for _ in range(cfg.dec_depth))
        self.norm = nn.LayerNorm(cfg.token_dim, eps=LN_EPS, **factory)


class HandHead(nn.Module):
    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        self.cvae = TrajCVAE(cfg.head_cfg(), cfg.token_dim, **factory)


class AffordanceHead(nn.Module):
    """AffordanceCVAE (affordance_decoder.py): the contact point's CVAE
    conditioned on the global token fused with a (pred_len + 1)-point
    trajectory; both fusion layers have no bias."""

    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        t1, d, c = cfg.pred_len + 1, cfg.token_dim, cfg.coord_dim
        self.traj_to_feature = nn.Sequential(nn.Linear(2 * t1, c * t1, bias=False, **factory),
                                             nn.ELU())
        self.traj_context_fusion = nn.Sequential(
            nn.Linear(d + c * t1, d, bias=False, **factory), nn.ELU())
        self.cvae = TrajCVAE(cfg.head_cfg(), d, **factory)


class ObjectTransformer(nn.Module):
    """The standalone hoi-forecast model (object_transformer.py:129-175)."""

    def __init__(self, cfg: ObjectTransformerConfig, **factory):
        super().__init__()
        d, c = cfg.token_dim, cfg.coord_dim
        self.downproject = nn.Linear(cfg.src_in_features, d, **factory)
        self.bbox_to_feature = nn.Sequential(
            nn.Linear(4, c // 2, **factory), nn.ELU(), nn.Linear(c // 2, c, **factory), nn.ELU())
        self.feat_fusion = nn.Sequential(nn.Linear(d + c, d, **factory), nn.ELU())
        self.oct_encoder = ObjectTransformerEncoder(cfg, **factory)
        self.oct_decoder = ObjectTransformerDecoder(cfg, **factory)
        self.last_obs_rhand_embedding_predictor = nn.Linear(d, d, **factory)
        self.last_obs_lhand_embedding_predictor = nn.Linear(d, d, **factory)
        self.hand_head = HandHead(cfg, **factory)
        self.object_head = AffordanceHead(cfg, **factory)

    def init_weights(self, generator: torch.Generator) -> None:
        init_transformer_weights(self, generator)


@torch.no_grad()
def init_transformer_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference init, as the JAX package draws it: truncated normal
    (+-2 std) x 0.02 weights and zero biases for the transformer's linears
    and the pos-embed, ones / zeros for the layer norms, and the CVAEs'
    uniform init (`TrajCVAE.init_weights`)."""
    cvaes = [m for m in module.modules() if isinstance(m, TrajCVAE)]
    in_cvae = {id(p) for m in cvaes for p in m.parameters()}
    for m in cvaes:
        m.init_weights(generator)
    for name, p in module.named_parameters():
        if id(p) in in_cvae:
            continue
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:  # a layer norm's scale
            p.fill_(1.0)
        else:
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.mul_(0.02)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


def _attention(attn: MultiHeadAttention, q, k, v, num_heads: int, mask=None):
    """MultiHeadAttention (layer.py:48-82): divisor temperature
    head_dim**0.5, fp32 scores, mask == 0 filled with -1e30, the
    probabilities cast to q's dtype before P.V."""
    b, nq, c = q.shape
    nk = k.shape[1]
    hd = c // num_heads
    qh = attn.proj_q(q).reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = attn.proj_k(k).reshape(b, nk, num_heads, hd).transpose(1, 2)
    vh = attn.proj_v(v).reshape(b, nk, num_heads, hd).transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", (qh / hd ** 0.5).float(), kh.float())
    if mask is not None:
        scores = torch.where(mask[:, None] != 0, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2).reshape(b, nq, c)
    return attn.proj(out)


def _mlp(mlp: Mlp, x):
    return mlp.fc2(F.gelu(mlp.fc1(x)))


def _encoder_block(blk: EncoderBlock, x, num_heads, mask):
    x2 = _layer_norm(x, blk.norm1)
    x = x + _attention(blk.attn, x2, x2, x2, num_heads, mask=mask)
    return x + _mlp(blk.mlp, _layer_norm(x, blk.norm2))


def _decoder_block(blk: DecoderBlock, hand, memory, memory_mask, causal_mask, num_heads):
    h1 = _layer_norm(hand, blk.norm1)
    hand = hand + _attention(blk.self_attn, h1, h1, h1, num_heads, mask=causal_mask)
    h2 = _layer_norm(hand, blk.norm2)
    hand = hand + _attention(blk.enc_dec_attn, h2, memory, memory, num_heads, mask=memory_mask)
    # reference quirk: the MLP consumes h2, not a third norm (layer.py:148)
    return hand + _mlp(blk.mlp, h2)


def sinusoidal_time_encoding(t: int, d: int, device=None) -> torch.Tensor:
    """PositionalEncoding (embedding.py:7-21), computed in float32 numpy as
    the JAX package does."""
    position = np.arange(t)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d, 2).astype(np.float32) * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe).to(device)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------


def apply_encoder(encoder: ObjectTransformerEncoder, cfg: ObjectTransformerConfig,
                  tokens: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, T, N, D), valid_mask (B, T, N) -> (B, T, N, D)."""
    b, t, n, d = tokens.shape
    x = tokens + encoder.pos_embed.to(tokens.dtype)  # space
    x = x + sinusoidal_time_encoding(t, d, tokens.device).to(tokens.dtype)[None, :, None, :]
    x = x.transpose(1, 2).reshape(b, n * t, d)  # (B, (n t), D)
    # pad mask over keys: (B, 1, N*T), valid_mask transposed to (B, N, T)
    mask = valid_mask.transpose(1, 2).reshape(b, 1, n * t)
    for blk in encoder.encoder_blocks:
        x = _encoder_block(blk, x, cfg.num_heads, mask)
    x = x.reshape(b, n, t, d).transpose(1, 2)
    return _layer_norm(x, encoder.norm)


def apply_decoder(decoder: ObjectTransformerDecoder, cfg: ObjectTransformerConfig,
                  coords: torch.Tensor, memory: torch.Tensor, memory_mask: torch.Tensor,
                  causal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """coords (B, T, 2), memory (B, N, D), memory_mask (B, 1, N) -> (B, T, D)."""
    t = coords.shape[1]
    dtype = decoder.target_embedding.weight.dtype
    x = decoder.target_embedding(coords.to(dtype))
    x = x + sinusoidal_time_encoding(t, cfg.token_dim, x.device).to(dtype)[None]
    if causal_mask is None:
        causal_mask = torch.tril(torch.ones((1, t, t), device=x.device))  # subsequent mask
    for blk in decoder.decoder_blocks:
        x = _decoder_block(blk, x, memory, memory_mask, causal_mask, cfg.num_heads)
    return _layer_norm(x, decoder.norm)


def encoder_input(model: ObjectTransformer, cfg: ObjectTransformerConfig, feat, bbox_feat,
                  src_mask):
    """(B, 5, T, 1024) + (B, 4, T, 4) -> (B, T, 5, D) fused tokens
    (object_transformer.py:186-227) and the (B, T, N) mask; the global-only
    variant keeps just the global stream (:448-459)."""
    dtype = model.downproject.weight.dtype
    feat = model.downproject(feat.to(dtype))
    if cfg.global_only:
        return feat[:, 0:1].transpose(1, 2), src_mask[:, :, :1]
    bb = model.bbox_to_feature(bbox_feat.to(dtype))  # (B, 4, T, coord)
    ho = model.feat_fusion(torch.cat([feat[:, 1:], bb], dim=-1))  # (B, 4, T, D)
    fused = torch.cat([feat[:, 0:1], ho], dim=1)  # (B, 5, T, D)
    return fused.transpose(1, 2), src_mask


# ---------------------------------------------------------------------------
# Affordance head
# ---------------------------------------------------------------------------


def affordance_condition(head: AffordanceHead, global_token, hand_traj):
    b = global_token.shape[0]
    traj_feat = head.traj_to_feature(hand_traj.reshape(b, -1).to(global_token.dtype))
    return head.traj_context_fusion(torch.cat([global_token, traj_feat], dim=1))


def affordance_forward(head: AffordanceHead, global_token, contact_point, hand_traj, *,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
    """-> (per-sample recon loss, per-sample KLD) of the contact point."""
    cond = affordance_condition(head, global_token, hand_traj)
    _, recon, kld = cvae_forward(head.cvae, contact_point.to(cond.dtype), cond, eps=eps,
                                 generator=generator)
    return recon, kld


def affordance_inference(head: AffordanceHead, cfg: ObjectTransformerConfig, global_token,
                         hand_traj, *, z: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    cond = affordance_condition(head, global_token, hand_traj)
    return cvae_inference(head.cvae, cfg.head_cfg(), cond, z=z, generator=generator)


def traj_affordance_dist(hand_traj, contact_point, future_valid, invalid_value=9.0):
    """net_utils.traj_affordance_dist: the min squared distance between the
    predicted trajectory points and a contact point, hand-selected by
    validity. hand_traj (B*2*T, 2), contact_point (B, 2), future_valid (B, 2)."""
    b = contact_point.shape[0]
    expand = hand_traj.shape[0] // b
    cp = contact_point[:, None, :].expand(b, expand, 2).reshape(-1, 2)
    dist = ((hand_traj - cp) ** 2).sum(dim=1).reshape(b, 2, -1)
    valid = future_valid > 0
    dist = torch.where(valid[:, :, None], dist, invalid_value)
    per_hand = dist.amin(dim=-1)  # (B, 2)
    sel = per_hand.argmin(dim=1, keepdim=True)
    sel_valid = torch.gather(valid, 1, sel)[:, 0]
    return torch.gather(per_hand, 1, sel)[:, 0] * sel_valid


# ---------------------------------------------------------------------------
# The heads over an encoded clip (shared with models.lita_hoi)
# ---------------------------------------------------------------------------


class Heads(NamedTuple):
    """The decoder and heads over an encoded clip: the ObjectTransformer's,
    or LITA-HOI's (models.lita_hoi)."""

    decoder: ObjectTransformerDecoder
    hand_cvae: TrajCVAE
    affordance: AffordanceHead
    last_obs_rhand: nn.Linear
    last_obs_lhand: nn.Linear


def heads_of(model: ObjectTransformer) -> Heads:
    return Heads(model.oct_decoder, model.hand_head.cvae, model.object_head,
                 model.last_obs_rhand_embedding_predictor,
                 model.last_obs_lhand_embedding_predictor)


def teacher_forced_losses(heads: Heads, cfg: ObjectTransformerConfig, last_hidden, memory_mask,
                          future_hands, contact_point, future_valid, *,
                          eps: Optional[Dict[str, torch.Tensor]] = None,
                          generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The decoder's teacher-forced pass and the heads' losses before the
    contact gate: traj_loss and traj_kl_loss (B,), last_hand, obj and
    obj_kl (B, 2) (object_transformer.py:262-337), summed in f32 whatever
    the weights' dtype. `eps` holds the
    reparameterisation noise: "traj" (B*2*(T_pred-1), latent), "obj_r" and
    "obj_l" (B, latent)."""
    eps = eps or {}
    b, t_pred = future_hands.shape[0], future_hands.shape[2]
    d = cfg.token_dim
    dtype = last_hidden.dtype
    future_hands = future_hands.to(dtype)
    gt_rhand, gt_lhand = future_hands[:, 0], future_hands[:, 1]
    rh_emb = apply_decoder(heads.decoder, cfg, gt_rhand[:, :-1], last_hidden, memory_mask)
    lh_emb = apply_decoder(heads.decoder, cfg, gt_lhand[:, :-1], last_hidden, memory_mask)

    gt_emb = torch.cat([rh_emb, lh_emb], dim=1).reshape(-1, d)
    gt_target = future_hands[:, :, 1:, :].reshape(-1, 2)
    _, recon, kld = cvae_forward(heads.hand_cvae, gt_target, gt_emb, eps=eps.get("traj"),
                                 generator=generator)
    recon = recon.float().reshape(b, 2, t_pred - 1).sum(-1)
    fv = future_valid.float()
    traj_loss = (recon * fv).sum(1)
    # reference quirk: the KL summed over the whole flattened batch, scaled
    # by each sample's valid count (traj_decoder.py:66-67)
    traj_kl_loss = kld.float().sum() * fv.sum(1)

    # last-observation hand-embedding MSE (object_transformer.py:302-314)
    global_token = last_hidden[:, 0]
    pred_r = heads.last_obs_rhand(global_token)
    pred_l = heads.last_obs_lhand(global_token)
    last_hand = torch.stack([((pred_r - rh_emb[:, 0]).float() ** 2).mean(-1),
                             ((pred_l - lh_emb[:, 0]).float() ** 2).mean(-1)], dim=1)

    r_obj, r_kl = affordance_forward(heads.affordance, global_token, contact_point, gt_rhand,
                                     eps=eps.get("obj_r"), generator=generator)
    l_obj, l_kl = affordance_forward(heads.affordance, global_token, contact_point, gt_lhand,
                                     eps=eps.get("obj_l"), generator=generator)
    return {"traj_loss": traj_loss, "traj_kl_loss": traj_kl_loss, "last_hand": last_hand,
            "obj": torch.stack([r_obj, l_obj], dim=1).float(),
            "obj_kl": torch.stack([r_kl, l_kl], dim=1).float()}


def select_contact_losses(obj_loss, obj_kl, last_hand, future_valid):
    """The min-hand selection (object_transformer.py:326-337): the hand with
    the smaller (gated) contact loss, zeroed where that hand is invalid.
    -> (obj, obj_kl, last_hand), each (B,)."""
    sel = obj_loss.argmin(dim=1, keepdim=True)
    sel_valid = torch.gather(future_valid.to(obj_loss.dtype), 1, sel)[:, 0]
    return tuple(torch.gather(x, 1, sel)[:, 0] * sel_valid for x in (obj_loss, obj_kl, last_hand))


def rollout(heads: Heads, cfg: ObjectTransformerConfig, last_hidden, memory_mask,
            pred_len: int = 4, *, z: Optional[Dict[str, torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None):
    """The autoregressive coordinate rollout of both hands and their contact
    points (object_transformer.py:368-415). `z` holds the latents, already
    scaled: "first_r" / "first_l" (B, latent), "roll_r" / "roll_l"
    (pred_len, B, latent), "contact_r" / "contact_l" (B, latent).
    -> (pred_hand (B, 2, pred_len, 2), pred_contact (B, 2, 2))."""
    z = z or {}
    b = last_hidden.shape[0]
    head_cfg = cfg.head_cfg()
    global_token = last_hidden[:, 0]
    first_r = cvae_inference(heads.hand_cvae, head_cfg, heads.last_obs_rhand(global_token),
                             z=z.get("first_r"), generator=generator)
    first_l = cvae_inference(heads.hand_cvae, head_cfg, heads.last_obs_lhand(global_token),
                             z=z.get("first_l"), generator=generator)

    def roll(first, zs):
        # fixed shape: step i runs the decoder at full length under the
        # causal mask and reads position i
        coords = torch.zeros((b, pred_len + 1, 2), dtype=first.dtype, device=first.device)
        coords[:, 0] = first
        for i in range(pred_len):
            emb = apply_decoder(heads.decoder, cfg, coords[:, :-1], last_hidden, memory_mask)
            nxt = cvae_inference(heads.hand_cvae, head_cfg, emb[:, i],
                                 z=None if zs is None else zs[i], generator=generator)
            coords = coords.clone()
            coords[:, i + 1] = nxt
        return coords

    rhand = roll(first_r, z.get("roll_r"))
    lhand = roll(first_l, z.get("roll_l"))
    pred_hand = torch.stack([rhand[:, 1:], lhand[:, 1:]], dim=1)
    r_contact = affordance_inference(heads.affordance, cfg, global_token, rhand,
                                     z=z.get("contact_r"), generator=generator)
    l_contact = affordance_inference(heads.affordance, cfg, global_token, lhand,
                                     z=z.get("contact_l"), generator=generator)
    return pred_hand, torch.stack([r_contact, l_contact], dim=1)


def select_contact(pred_hand, pred_contact, traj_valid):
    """The contact of the hand whose trajectory passes nearer its contact
    point (object_transformer.py:417-424)."""
    flat = pred_hand.reshape(-1, 2)
    r_dist = traj_affordance_dist(flat, pred_contact[:, 0], traj_valid)
    l_dist = traj_affordance_dist(flat, pred_contact[:, 1], traj_valid)
    sel = torch.stack([r_dist, l_dist], dim=1).argmin(dim=1)
    return pred_contact[torch.arange(pred_contact.shape[0], device=sel.device), sel]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _encode(model: ObjectTransformer, cfg: ObjectTransformerConfig, feat, bbox_feat, valid_mask):
    """-> (the last frame's tokens (B, N, D), their key mask (B, 1, N))."""
    src_mask = valid_mask.transpose(1, 2)  # (B, T, 5)
    tokens, src_mask = encoder_input(model, cfg, feat, bbox_feat, src_mask)
    hidden = apply_encoder(model.oct_encoder, cfg, tokens, src_mask)
    return hidden[:, -1], (src_mask[:, -1, :] != 0)[:, None, :]


def object_transformer_forward(
    model: ObjectTransformer, cfg: ObjectTransformerConfig,
    feat, bbox_feat, valid_mask, future_hands, contact_point, future_valid, *,
    eps: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Teacher-forced training losses (object_transformer.py:229-338).

    Returns dict(traj_loss, traj_kl_loss, obj_loss, obj_kl_loss,
    last_hand_loss), each (B,)."""
    last_hidden, memory_mask = _encode(model, cfg, feat, bbox_feat, valid_mask)
    parts = teacher_forced_losses(heads_of(model), cfg, last_hidden, memory_mask, future_hands,
                                  contact_point, future_valid, eps=eps, generator=generator)
    # reference quirk: a batch-global validity gate (future_valid.sum() > 0)
    obj_loss = torch.where(future_valid.sum() > 0, parts["obj"], 1e9)
    sel_obj, sel_kl, sel_last = select_contact_losses(obj_loss, parts["obj_kl"],
                                                      parts["last_hand"], future_valid)
    return {"traj_loss": parts["traj_loss"], "traj_kl_loss": parts["traj_kl_loss"],
            "obj_loss": sel_obj, "obj_kl_loss": sel_kl, "last_hand_loss": sel_last}


def object_transformer_inference(
    model: ObjectTransformer, cfg: ObjectTransformerConfig,
    feat, bbox_feat, valid_mask, future_valid, pred_len: int = 4, *,
    z: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
):
    """Autoregressive rollout (object_transformer.py:340-425).

    Returns (pred_hand (B, 2, pred_len, 2), pred_contact (B, 2))."""
    last_hidden, memory_mask = _encode(model, cfg, feat, bbox_feat, valid_mask)
    pred_hand, pred_contact = rollout(heads_of(model), cfg, last_hidden, memory_mask, pred_len,
                                      z=z, generator=generator)
    return pred_hand, select_contact(pred_hand, pred_contact, future_valid)


LOSS_KEYS = ("traj_loss", "traj_kl_loss", "obj_loss", "obj_kl_loss", "last_hand_loss")


def hoi_forecast_loss(
    model: ObjectTransformer, cfg: ObjectTransformerConfig, batch: Dict, *,
    eps: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    lambda_obj=0.1, lambda_traj=1.0, lambda_obj_kl=1e-3, lambda_traj_kl=1e-3,
    lambda_last_hand=1e-3,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """HoiForecastModel.forward's training composition (build_model.py:18-71)."""
    losses = object_transformer_forward(
        model, cfg, batch["feat"], batch["bbox_feat"], batch["valid_mask"],
        batch["future_hands"], batch["contact_point"], batch["future_valid"],
        eps=eps, generator=generator)
    weights = dict(zip(LOSS_KEYS, (lambda_traj, lambda_traj_kl, lambda_obj, lambda_obj_kl,
                                   lambda_last_hand)))
    out = {k: weights[k] * losses[k].sum() for k in LOSS_KEYS}
    total = sum(out.values())
    out["total_loss"] = total
    return total, out


def hoi_forecast_sample(
    model: ObjectTransformer, cfg: ObjectTransformerConfig, batch: Dict,
    num_samples: int = 5, pred_len: int = 4, *,
    z: Optional[list] = None,
    generator: Optional[torch.Generator] = None,
):
    """Multi-sample stochastic inference (build_model.py:72-87): the clip
    encoded once, `num_samples` rollouts (`z`: one latents dict a sample).
    Returns (future_hands (B, S, 2, T, 2), contacts (B, S, 2))."""
    last_hidden, memory_mask = _encode(model, cfg, batch["feat"], batch["bbox_feat"],
                                       batch["valid_mask"])
    hands, contacts = [], []
    for s in range(num_samples):
        pred_hand, pred_contact = rollout(heads_of(model), cfg, last_hidden, memory_mask,
                                          pred_len, z=None if z is None else z[s],
                                          generator=generator)
        hands.append(pred_hand)
        contacts.append(select_contact(pred_hand, pred_contact, batch["future_valid"]))
    return torch.stack(hands, dim=1), torch.stack(contacts, dim=1)
