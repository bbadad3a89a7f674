"""N-gram speculative decoding (prompt / history / bank lookup), the B = 1
latency mode.

Port of `handsonvlm_tpu/infer/speculative.py`. A one-token decode step
streams every weight of the decoder for one position. Speculation spreads
that cost: draft K candidate tokens from an n-gram match over (template
bank + prompt + generated so far), run ONE cached forward over K + 1
positions (the same weight traffic as a one-token step; the window goes
through the stacked decode kernel and the int4 GEMV, as a decode step
does), and accept a prefix by rejection sampling: 1..K+1 tokens per
forward.

What is exact:
- Rejection sampling against the warped (temperature + top-p) distribution
  keeps the target distribution for a deterministic draft: accept d with
  probability p(d), else resample from p with d excluded. Greedy
  (temperature <= 0) accepts iff argmax, so greedy speculative output is
  that of sequential greedy decode.
- Acceptance truncates after the first emitted <hand_traj> or EOS: the
  positions after a hand token need its waypoint's coordinate encoding
  added to their input embedding (`embed_next_token`), which a token draft
  cannot give. Cache rows written past the accepted prefix are stale; they
  are never read, because the cache index is set back to the accepted
  prefix after every forward and the next forward's key mask and block
  list are built from it, and the next forward overwrites them.

Drafting: the latest bigram match. `bank_ids` (the tokenized answer
templates the model was trained to emit, `build_template_bank`) is put
ahead of the prompt in the search buffer, so even the first generation of
a template sentence finds long drafts.

The loop is driven by the host, one forward per iteration: the n-gram
buffer and the draft lookup live on the host (the emitted tokens come to
the host anyway, to set the cache index). Draws come from a
`torch.Generator`; `spec_verify` also takes injected uniforms and
`generate_spec` injected CVAE latents, so a test can feed another
implementation's draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.infer.sampler import (
    EOS_TOKEN_ID,
    MAX_HAND_STEPS,
    PAD_TOKEN_ID,
    SampleOutput,
    _sample_and_hook,
    _warp_logits,
    prefill,
)
from handsonvlm_torch.models.handsonvlm import (
    HandsOnVLM,
    decode_hand_waypoint,
    embed_next_token,
)
from handsonvlm_torch.models.llama import apply_llama, lm_logits


def ngram_draft(buf: np.ndarray, buf_len: int, t_prev: int, t_cur: int,
                k: int) -> Tuple[np.ndarray, bool]:
    """The latest i with buf[i:i+2] == (t_prev, t_cur) and room after it
    (i + 2 < buf_len); returns (draft = buf[i+2 : i+2+k] (k,) int32, found).
    Slots past `buf_len` draft PAD (rejected as a matter of course), and so
    does every slot when nothing matches."""
    buf = np.asarray(buf)
    draft = np.full((k,), PAD_TOKEN_ID, np.int32)
    n = min(int(buf_len), buf.shape[0])
    hits = np.nonzero((buf[:n - 2] == t_prev) & (buf[1:n - 1] == t_cur))[0] if n > 2 else ()
    if len(hits) == 0:
        return draft, False
    start = int(hits[-1]) + 2
    take = buf[start:min(start + k, n)]
    draft[:len(take)] = take
    return draft, True


def _inverse_cdf(logits: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """A categorical draw per row of `logits` (-inf: excluded) at the row's
    uniform in [0, 1)."""
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    target = (uniforms.float() * cdf[..., -1])[..., None]
    return torch.searchsorted(cdf, target, right=True)[..., 0].clamp(max=logits.shape[-1] - 1)


def spec_verify(
    logits: torch.Tensor,  # (k+1, V) raw logits of positions 0..k
    draft,  # (k,) drafted tokens entering positions 1..k
    temperature: float,
    top_p: float,
    hand_token_id: int,
    eos_token_id: int,
    *,
    generator: Optional[torch.Generator] = None,
    u=None,  # (k,) acceptance uniforms
    fallback_u=None,  # (k,) uniforms of the resampled tokens
    bonus_u=None,  # () uniform of the bonus token
) -> Tuple[np.ndarray, int]:
    """Returns (emitted (k+1,) int32, n_emit): emitted[:n_emit] are the
    tokens this forward produced (0 beyond the raw emission); n_emit is in
    1..k+1.

    Position i's logits sample the token that enters position i+1. Draft
    d_i is accepted with probability p_i(d_i) (1 iff argmax when greedy);
    the first rejection resamples from p_i with d_i excluded; full
    acceptance appends a bonus token from position k. The emission is then
    cut after the first <hand_traj> or EOS. Uniforms not given are drawn
    from `generator`."""
    draft_h = np.asarray(draft.cpu() if torch.is_tensor(draft) else draft).astype(np.int64)
    k = draft_h.shape[0]
    dev = logits.device
    if temperature <= 0.0:
        target = torch.argmax(logits, dim=-1).cpu().numpy()
        accept = target[:k] == draft_h
        fallback, bonus = target[:k], target[k]
    else:
        drawn = None
        if u is None or fallback_u is None or bonus_u is None:
            drawn = torch.rand((2 * k + 1,), generator=generator, device=dev)

        def draws(given, lo, hi):
            if given is not None:
                return torch.tensor(np.asarray(given), dtype=torch.float32,
                                    device=dev).reshape(hi - lo)
            return drawn[lo:hi]

        u, fallback_u, bonus_u = draws(u, 0, k), draws(fallback_u, k, 2 * k), draws(
            bonus_u, 2 * k, 2 * k + 1)
        warped = _warp_logits(logits, temperature, top_p)  # (k+1, V), -inf tails
        probs = torch.softmax(warped, dim=-1)
        draft_d = torch.as_tensor(draft_h, device=dev)
        p_draft = torch.gather(probs[:k], 1, draft_d[:, None])[:, 0]
        masked = warped[:k].scatter(1, draft_d[:, None], -torch.inf)
        # one transfer for everything the host decides on
        packed = torch.cat([(u < p_draft).long(), _inverse_cdf(masked, fallback_u),
                            _inverse_cdf(warped[k:], bonus_u)]).cpu().numpy()
        accept, fallback, bonus = packed[:k].astype(bool), packed[k:2 * k], packed[2 * k]

    rejected = np.nonzero(~accept)[0]
    j = int(rejected[0]) if len(rejected) else k  # the first rejection; k if none
    emitted = np.zeros((k + 1,), np.int32)
    emitted[:j] = draft_h[:j]
    emitted[j] = fallback[j] if j < k else bonus
    n_emit = j + 1
    stops = np.nonzero((emitted[:n_emit] == hand_token_id)
                       | (emitted[:n_emit] == eos_token_id))[0]
    if len(stops):
        n_emit = int(stops[0]) + 1
    return emitted, n_emit


@torch.inference_mode()
def generate_spec(
    model: HandsOnVLM,
    cfg: HandsOnVLMConfig,
    input_ids,  # (1, T) with the IMAGE sentinel
    images,
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int = 100,
    k: int = 4,
    temperature: float = 0.5,
    top_p: float = 0.9,
    eos_token_id: int = EOS_TOKEN_ID,
    attn_impl: str = "auto",
    attn_mask=None,  # (1, T) valid-prompt mask of a LEFT-padded prompt
    frame_map=None,
    bank_ids=None,  # (N,) template-bank tokens
    max_len: int = 0,
    on_token=None,
    kv_quant: Optional[str] = None,  # "int8": the int8 decode cache
    gate_tok_per_fwd: float = 1.2,
    probe_iters: int = 8,
    z_steps: Optional[Sequence] = None,
):
    """Speculative generate, B = 1. Returns (SampleOutput, stats): stats
    holds `iters` (forwards), `drafts_found`, `tokens`, `accept_hist`
    (bucket i counts the forwards that emitted i tokens), `gated`, and
    `trace`, one (cache index before, tokens emitted, cache index after)
    per forward. The sampling distribution is that of `generate_host`
    (greedy: the same tokens).

    `on_token` (token_id -> None) streams the tokens in bursts, one burst
    per forward.

    The acceptance gate: a K-token verify forward streams the same weights
    as a one-token step but computes K + 1 positions, so speculation pays
    only when drafts are accepted. The first `probe_iters` forwards run
    speculatively; if they emitted fewer than `gate_tok_per_fwd` tokens per
    forward, the rest of the decode goes on with k = 0, which is sequential
    decode in this very loop (empty draft, one position per forward, the
    same sampling and state), so nothing is redone. `gate_tok_per_fwd=0`
    turns the gate off.

    `z_steps[i]` (2, latent_dim), when given, is the CVAE latent of the
    first token (i = 0) and of forward i - 1 (i >= 1) instead of a draw."""
    device = model.llama.embed_tokens.weight.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    if input_ids.shape[0] != 1:
        raise ValueError("speculative decode is the B = 1 latency mode, "
                         f"got batch {input_ids.shape[0]}")
    images = torch.as_tensor(images, device=device)
    if attn_mask is not None:
        attn_mask = torch.as_tensor(attn_mask, device=device).bool()
    t_prompt = input_ids.shape[1] + cfg.num_visual_tokens - 1
    need = t_prompt + max_new_tokens + k + 2
    if max_len == 0:
        max_len = need
    elif max_len < need:
        raise ValueError(f"max_len {max_len} < prompt {t_prompt} + max_new_tokens "
                         f"{max_new_tokens} + k {k} + 2")

    def z_at(i):
        return None if z_steps is None else torch.as_tensor(z_steps[i], device=device)

    last_hidden, cache, cache_mask = prefill(
        model, cfg, input_ids, images, max_len, attn_mask=attn_mask, attn_impl=attn_impl,
        frame_map=frame_map, kv_quant=kv_quant)
    token, waypoint = _sample_and_hook(model, cfg, last_hidden, generator, temperature,
                                       top_p, z_at(0))
    tok0 = int(token[0])
    cur_wp = waypoint[0].float()  # (2, 2), on the device

    row = input_ids[0].cpu().numpy()
    if attn_mask is not None:
        row = row[attn_mask[0].cpu().numpy()]  # drop the left-pad bucket slots
    prompt_row = np.where(row < 0, PAD_TOKEN_ID, row).astype(np.int32)
    bank = (np.zeros((0,), np.int32) if bank_ids is None
            else np.asarray(bank_ids, np.int32).reshape(-1))
    buf = np.zeros((bank.shape[0] + prompt_row.shape[0] + max_new_tokens + k + 2,), np.int32)
    buf[:bank.shape[0]] = bank
    buf_len = bank.shape[0] + prompt_row.shape[0]
    buf[bank.shape[0]:buf_len] = prompt_row

    # the first token (sampled from the prefill), recorded as the other loops do
    tokens = np.zeros((max_new_tokens + k + 1,), np.int32)
    tokens[0] = buf[buf_len] = tok0
    buf_len += 1
    n_tokens = 1
    prev_tok, cur_tok = int(prompt_row[-1]), tok0
    pred_hands = np.zeros((MAX_HAND_STEPS, 2, 2), np.float32)
    num_hands = 0
    if tok0 == cfg.hand_token_id:
        pred_hands[0] = cur_wp.cpu().numpy()
        num_hands = 1
    finished = tok0 == eos_token_id or n_tokens >= max_new_tokens
    if on_token is not None and tok0 != eos_token_id:
        on_token(tok0)

    gating = gate_tok_per_fwd > 0 and probe_iters > 0 and k > 0
    k_run, gated = k, False
    iters = drafts_found = 0
    accept_hist = [0] * (k + 2)
    trace = []
    embed = model.llama.embed_tokens
    while not finished:
        draft, found = ngram_draft(buf, buf_len, prev_tok, cur_tok, k_run)
        # position 0 is the last emitted token, with its waypoint's encoding
        # if it is <hand_traj>; the drafted positions are plain tokens
        e0 = embed_next_token(model, cfg, torch.tensor([cur_tok], device=device),
                              cur_wp[None])
        embs = torch.cat([e0, embed(torch.as_tensor(draft, device=device).long())])[None]
        index = cache.index
        hidden, cache = apply_llama(model.llama, cfg.llama, inputs_embeds=embs,
                                    attn_mask=cache_mask, kv_cache=cache,
                                    attn_impl=attn_impl, lora=model.lora)
        logits = lm_logits(model.llama, cfg.llama, hidden)[0]  # (k_run + 1, V)
        emitted, n_emit = spec_verify(logits, draft, temperature, top_p, cfg.hand_token_id,
                                      eos_token_id, generator=generator)
        # rows written past the accepted prefix are stale: the next forward
        # masks by this index and overwrites them
        cache.index = index + n_emit
        trace.append((index, n_emit, cache.index))
        last = n_emit - 1
        # one waypoint decode per forward: the emission is cut after the
        # first <hand_traj>, so a hand token, the only position whose
        # waypoint is ever read, can only sit at the last emitted position
        iters += 1
        cur_wp = decode_hand_waypoint(model, cfg, hidden[0, last][None], z=z_at(iters),
                                      generator=generator)[0].float()
        tokens[n_tokens:n_tokens + n_emit] = emitted[:n_emit]
        buf[buf_len:buf_len + n_emit] = emitted[:n_emit]
        if emitted[last] == cfg.hand_token_id:
            pred_hands[min(num_hands, MAX_HAND_STEPS - 1)] = cur_wp.cpu().numpy()
            num_hands += 1
        prev_tok = int(emitted[n_emit - 2]) if n_emit >= 2 else cur_tok
        cur_tok = int(emitted[last])
        buf_len += n_emit
        drafts_found += int(found)
        accept_hist[min(n_emit, k_run + 1)] += 1
        hit_eos = bool((emitted[:n_emit] == eos_token_id).any())
        if on_token is not None:
            for t_id in tokens[n_tokens:min(n_tokens + n_emit, max_new_tokens)]:
                if t_id == eos_token_id:
                    break
                on_token(int(t_id))
        n_tokens += n_emit
        finished = hit_eos or n_tokens >= max_new_tokens
        if gating and iters == probe_iters and not finished:
            # the probe's verdict: below the break-even acceptance, go on in
            # the same loop with k = 0 (sequential cost, the same semantics)
            if (n_tokens - 1) / iters < gate_tok_per_fwd:
                k_run, gated = 0, True

    n = min(n_tokens, max_new_tokens)
    seq = np.full((1, max_new_tokens), PAD_TOKEN_ID, np.int32)
    seq[0, :n] = tokens[:n]
    eos_pos = np.nonzero(seq[0] == eos_token_id)[0]
    if eos_pos.size:  # the slots after the first EOS are not output
        n = min(n, int(eos_pos[0]) + 1)
        seq[0, n:] = PAD_TOKEN_ID
    out = SampleOutput(
        sequences=seq,
        num_tokens=np.asarray([n], np.int32),
        pred_hands=np.ascontiguousarray(pred_hands[None].transpose(0, 2, 1, 3)),
        num_hands=np.asarray([num_hands], np.int32),
    )
    stats = {"iters": iters, "drafts_found": drafts_found, "tokens": n,
             "accept_hist": accept_hist, "gated": gated, "trace": trace}
    return out, stats


def build_template_bank(tokenizer, cfg: HandsOnVLMConfig, narrations=()) -> np.ndarray:
    """Tokenize the EK answer templates (the SFT answers are drawn from
    exactly these strings) into one draft-search buffer, (N,) int32.
    `narrations` adds action-specific fills ("reach for the cup"). The
    templates are joined with EOS, so that no useful bigram straddles two
    of them."""
    from handsonvlm_torch.constants import (
        ACTION_ANSWER_TEMPLATES,
        GENERAL_ANSWER_TEMPLATES,
        GENERAL_TRAJECTORY_ANSWER_TEMPLATES,
        HAND_TOKEN_TEMPLATE,
    )
    from handsonvlm_torch.data.tokenization import tokenizer_image_token

    hand4 = " ".join([HAND_TOKEN_TEMPLATE] * 4)
    texts = [t.format(hand4)
             for t in GENERAL_TRAJECTORY_ANSWER_TEMPLATES + GENERAL_ANSWER_TEMPLATES]
    for t in ACTION_ANSWER_TEMPLATES:
        texts.extend(t.format(narr, hand4) for narr in narrations or ("",))
    rows = []
    for text in texts:
        rows.extend(int(i) for i in tokenizer_image_token(text, tokenizer) if int(i) >= 0)
        rows.append(EOS_TOKEN_ID)
    return np.asarray(rows, np.int32)
