"""KV-cached autoregressive sampler with the <hand_traj> decode hook.

Port of `handsonvlm_tpu/infer/sampler.py` (prefill, the warper, decode_step,
generate_host, clip_pred_hands): prefill prompt + visual tokens once, then
decode one token per step from the cache, driven by the host. When
<hand_traj> (32100) is sampled, the hidden state decodes one (right, left)
waypoint through the CVAE (z ~ 2*N(0,I)); when that token is fed back, its
embedding gets the sinusoidal encoding of its own waypoint added.

Sampling follows HF's warper stack: temperature, then top-p, then a
categorical draw (temperature <= 0: greedy argmax). Draws come from a
`torch.Generator`. The cache holds prompt + max_new_tokens + 1 positions.
`kv_quant="int8"` decodes over the int8 cache: the prefill attends over a
cache in the model's dtype, which is then quantized, as the JAX package
does.

`tp` (a `parallel.tp.TPGroup`, the JAX package's `tp_mesh`) runs every
rank of the group on its shard of the decoder (`parallel.tp.shard_llama_tp`)
over a cache of its kv heads; the rest of the model is whole on every rank.
Every rank samples from the same generator over the same logits; the
group's first rank's token and waypoint are then broadcast, so the ranks
feed the same token back whatever their sampling did.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.models.handsonvlm import (
    HandsOnVLM,
    decode_hand_waypoint,
    embed_next_token,
    encode_video,
    splice_visual_tokens,
)
from handsonvlm_torch.models.llama import KVCache, apply_llama, lm_logits, quantize_kv_cache
from handsonvlm_torch.parallel.tp import broadcast_from_first, check_layout, tp_size
from handsonvlm_torch.utils import profiling

MAX_HAND_STEPS = 10  # generous cap; eval pads/clips to 4

EOS_TOKEN_ID = 2
PAD_TOKEN_ID = 0


@dataclasses.dataclass
class SampleOutput:
    """Host numpy results (the reference's SampleDecoderOnlyOutput + hands)."""

    sequences: np.ndarray  # (B, max_new_tokens), PAD-filled after EOS
    num_tokens: np.ndarray  # (B,) generated length incl. EOS
    pred_hands: np.ndarray  # (B, 2, MAX_HAND_STEPS, 2)
    num_hands: np.ndarray  # (B,)


def _warp_logits(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """HF TemperatureLogitsWarper + TopPLogitsWarper semantics (fp32)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1).values  # ascending
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # drop tokens whose cumulative prob is <= 1 - top_p; the threshold is
        # the smallest surviving logit, so ties with it are kept
        cutoff_idx = (cum_probs <= (1.0 - top_p)).sum(dim=-1, keepdim=True)
        threshold = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < threshold, -torch.inf, logits)
    return logits


def _sample_token(generator, logits: torch.Tensor, temperature: float, top_p: float):
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_warp_logits(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                uniforms: torch.Tensor) -> torch.Tensor:
    """Per-row sampling with each row's own settings, held as tensors:
    logits (B, V), temps and top_ps (B,), uniforms (B,) in [0, 1), one draw
    per row. The warper is `_warp_logits`'s (a top_p of 1 cuts nothing),
    and the categorical draw is the inverse CDF at the row's uniform, so a
    row's token depends only on its own logits, settings and draw. A row
    with temperature <= 0 takes the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    warped = logits.float() / temps.float().clamp(min=1e-6)[:, None]
    sorted_logits = torch.sort(warped, dim=-1).values  # ascending
    cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum_probs <= (1.0 - top_ps.float())[:, None]).sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=logits.shape[-1] - 1))
    warped = torch.where(warped < threshold, -torch.inf, warped)
    cdf = torch.cumsum(torch.softmax(warped, dim=-1), dim=-1)
    target = (uniforms.float() * cdf[:, -1])[:, None]
    sampled = torch.searchsorted(cdf, target, right=True)[:, 0].clamp(max=logits.shape[-1] - 1)
    return torch.where(temps > 0, sampled, greedy)


@torch.inference_mode()
def prefill(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    input_ids: torch.Tensor,  # (B, T) with the IMAGE sentinel
    images: torch.Tensor,  # (B, T_frames, 3, H, W)
    max_len: int,
    *,
    attn_mask: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    frame_map: Optional[torch.Tensor] = None,
    kv_quant: Optional[str] = None,
    positions_from_mask: bool = False,
    tp=None,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Encode the video, splice, run the prompt through the decoder once.

    `positions_from_mask` derives per-row rotary positions from the
    post-splice mask (a row's real tokens count 0..t_r-1 whatever its left
    padding) instead of the default arange: the continuous engine's group
    join uses it so that each row stays position-exact against its solo
    prefill (serve/continuous.join_many).
    Returns (last_hidden (B,D), cache, cache_attn_mask (B, max_len)); with
    kv_quant="int8" the cache is a QuantKVCache. Spans (utils/profiling.py):
    `join.vision` (CLIP and the projector), `join.prefill` (the splice and
    the decoder)."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    b = input_ids.shape[0]
    with profiling.span("join.vision"):
        visual = encode_video(model, cfg, images, attn_impl=attn_impl, frame_map=frame_map)
    with profiling.span("join.prefill"):
        text_embeds = model.llama.embed_tokens(torch.where(input_ids < 0, 0, input_ids))
        sp = splice_visual_tokens(text_embeds, input_ids, visual.to(text_embeds.dtype),
                                  attn_mask=attn_mask)
        t_out = sp.embeds.shape[1]
        if t_out + 1 > max_len:
            raise ValueError(f"prompt {t_out} does not fit cache {max_len}")
        layout = check_layout(model.llama, tp)
        cache = KVCache.create(cfg.llama, b, max_len, sp.embeds.dtype, sp.embeds.device,
                               kv_heads=layout.kv_heads(cfg.llama.kv_heads) if layout else None)
        cache_mask = torch.cat([sp.attn_mask, torch.ones((b, max_len - t_out), dtype=torch.bool,
                                                         device=sp.embeds.device)], dim=1)
        positions = None
        if positions_from_mask:
            positions = (torch.cumsum(sp.attn_mask.long(), dim=1) - 1).clamp(min=0)
        hidden, cache = apply_llama(model.llama, cfg.llama, inputs_embeds=sp.embeds,
                                    attn_mask=cache_mask, positions=positions, kv_cache=cache,
                                    attn_impl=attn_impl, lora=model.lora, tp=tp)
        if kv_quant == "int8":
            cache = quantize_kv_cache(cache)
    return hidden[:, -1, :], cache, cache_mask


def _sample_and_hook(model, cfg, hidden, generator, temperature, top_p, z, tp=None):
    """Sample the next token from `hidden` (B, D) and decode the waypoint
    that goes with it (used if the token is <hand_traj>); under `tp` the
    group's first rank's pair."""
    logits = lm_logits(model.llama, cfg.llama, hidden)
    token = _sample_token(generator, logits, temperature, top_p)
    waypoint = decode_hand_waypoint(model, cfg, hidden, z=z, generator=generator)
    if tp_size(tp) > 1:
        token, waypoint = broadcast_from_first((token, waypoint), tp)
    return token, waypoint


@torch.inference_mode()
def decode_step(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    cache: KVCache,
    cache_mask: torch.Tensor,
    cur_token: torch.Tensor,  # (B,)
    cur_waypoint: torch.Tensor,  # (B, 2, 2)
    generator: Optional[torch.Generator],
    *,
    temperature: float = 0.5,
    top_p: float = 0.9,
    attn_impl: str = "auto",
    z: Optional[torch.Tensor] = None,
    tp=None,
):
    """One cached decode step: feed cur_token (with its waypoint if it is
    <hand_traj>), sample the next token. Returns (token, waypoint, cache)."""
    emb = embed_next_token(model, cfg, cur_token, cur_waypoint)
    hidden, cache = apply_llama(model.llama, cfg.llama, inputs_embeds=emb[:, None, :],
                                attn_mask=cache_mask, kv_cache=cache, attn_impl=attn_impl,
                                lora=model.lora, tp=tp)
    token, waypoint = _sample_and_hook(model, cfg, hidden[:, 0], generator,
                                       temperature, top_p, z, tp)
    return token, waypoint, cache


@torch.inference_mode()
def generate_host(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    input_ids,
    images,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int = 100,
    max_len: int = 0,
    temperature: float = 0.5,
    top_p: float = 0.9,
    eos_token_id: int = EOS_TOKEN_ID,
    attn_impl: str = "auto",
    attn_mask=None,
    frame_map=None,
    on_token=None,
    stop_strs=None,
    tokenizer=None,
    z_steps: Optional[Sequence] = None,
    kv_quant: Optional[str] = None,
    tp=None,
) -> SampleOutput:
    """Prefill + host-driven per-token decode (`kv_quant="int8"`: over the
    int8 cache; `tp`: this rank's shard of a tensor-parallel group, every
    rank of which calls this with the same arguments).

    `on_token` (token_id -> None) streams row 0's tokens as they are sampled.
    `stop_strs` (+ `tokenizer`) finish a row when the decoded tail of its
    text contains a keyword (the reference's KeywordsStoppingCriteria).
    `attn_mask` marks valid prompt positions of LEFT-padded prompts;
    `frame_map` lets callers pass the unique frames only (see encode_video).
    `z_steps[i]` (B*2, latent_dim), when given, is the CVAE latent of step i
    instead of a draw, so a test can inject the reference's draws."""
    device = model.llama.embed_tokens.weight.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    images = torch.as_tensor(images, device=device)
    if attn_mask is not None:
        attn_mask = torch.as_tensor(attn_mask, device=device).bool()
    b = input_ids.shape[0]
    if max_len == 0:
        max_len = input_ids.shape[1] + cfg.num_visual_tokens - 1 + max_new_tokens + 1

    def z_at(step):
        if z_steps is None:
            return None
        return torch.as_tensor(z_steps[step], device=device)

    last_hidden, cache, cache_mask = prefill(
        model, cfg, input_ids, images, max_len, attn_mask=attn_mask,
        attn_impl=attn_impl, frame_map=frame_map, kv_quant=kv_quant, tp=tp)
    token, waypoint = _sample_and_hook(model, cfg, last_hidden, generator,
                                       temperature, top_p, z_at(0), tp)

    tokens = np.zeros((b, max_new_tokens), np.int32)
    num_tokens = np.zeros((b,), np.int32)
    pred_hands = np.zeros((b, MAX_HAND_STEPS, 2, 2), np.float32)
    num_hands = np.zeros((b,), np.int32)
    finished = np.zeros((b,), bool)

    def record(step, token_d, waypoint_d):
        nonlocal finished
        tok = np.where(finished, PAD_TOKEN_ID, token_d.cpu().numpy())
        tokens[:, step] = tok
        num_tokens[:] += (~finished).astype(np.int32)
        is_hand = (tok == cfg.hand_token_id) & ~finished
        if is_hand.any():
            wp = waypoint_d.float().cpu().numpy()
            for i in np.nonzero(is_hand)[0]:
                pred_hands[i, min(num_hands[i], MAX_HAND_STEPS - 1)] = wp[i]
                num_hands[i] += 1
        finished = finished | (tok == eos_token_id)
        if stop_strs and tokenizer is not None:
            for i in np.nonzero(~finished)[0]:
                n = num_tokens[i]
                tail = tokenizer.decode([int(t) for t in tokens[i, max(n - 4, 0):n]])
                if any(s in tail for s in stop_strs):
                    finished[i] = True
        if on_token is not None and not finished[0]:
            on_token(int(tok[0]))
        return tok

    tok_h = record(0, token, waypoint)
    step = 1
    while step < max_new_tokens and not finished.all():
        # `waypoint` was decoded at the step tok_h was sampled: it is the
        # coordinate embedded when tok_h is a <hand_traj> input
        token, waypoint, cache = decode_step(
            model, cfg, cache, cache_mask, torch.as_tensor(tok_h, device=device).long(),
            waypoint, generator, temperature=temperature, top_p=top_p,
            attn_impl=attn_impl, z=z_at(step), tp=tp)
        tok_h = record(step, token, waypoint)
        step += 1

    return SampleOutput(
        sequences=tokens,
        num_tokens=num_tokens,
        pred_hands=np.ascontiguousarray(pred_hands.transpose(0, 2, 1, 3)),
        num_hands=num_hands,
    )


def clip_pred_hands(pred_hands, num_hands, num_steps: int = 4):
    """Pad/clip decoded waypoints to `num_steps` like the eval harness: keep
    the LAST num_steps when longer, zero-pad at the end when shorter.
    Returns (out (B,2,num_steps,2), valid (B,)), valid False when no hand
    token was produced."""
    pred = np.asarray(pred_hands)
    n = np.asarray(num_hands)
    b = pred.shape[0]
    out = np.zeros((b, 2, num_steps, 2), np.float32)
    valid = np.zeros((b,), bool)
    for i in range(b):
        k = int(n[i])
        if k == 0:
            continue
        valid[i] = True
        traj = pred[i, :, :k, :]
        if k > num_steps:
            traj = traj[:, -num_steps:, :]
        out[i, :, : traj.shape[1], :] = traj
    return out, valid
