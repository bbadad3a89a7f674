"""Continuous batching: requests join and leave a shared decode batch at
chunk boundaries.

Port of `handsonvlm_tpu/serve/continuous.py` (`ContinuousEngine`), driven
from the host: one torch call per operation, the cache written in place.

- ONE persistent stacked cache (L, slots, S, K, D) (`KVCache`, or the int8
  `QuantKVCache`) and ONE shared write cursor (`pos`, the cache's index).
  Every live row writes its next token at the same global position.
- A joining request's prompt is prefilled (B=1, or one left-padded group
  for `join_many`) into a transient cache of its bucket length and spliced
  into its slot's plane at [cursor, cursor + bucket); the cursor then jumps
  past it for everyone. Other rows have a masked hole there: each row's
  valid keys are tracked in a host (slots, S) mask, uploaded once a chunk.
- Rotary positions are per row: position = cursor - start_r, and a join
  moves the live rows' starts with the cursor past the new bucket, so a
  row's positions run on as in a solo decode and its logits do not depend
  on where its keys sit in the shared cache or on who joined beside it.
  (The JAX package's engine leaves the live rows' starts where they were,
  so their positions jump by the bucket at another request's join.)
- Draws are per row: each slot owns a `torch.Generator` seeded from its
  request's seed, which gives the token draw and the CVAE latent of every
  step in order, so a request's stream depends on its seed and its step,
  never on the other rows.
- Space: the cursor consumes one prompt bucket per join call plus one
  chunk per step. `can_admit` refuses joins that would overrun; an idle
  engine resets the cursor to 0; `compact()` reclaims dead cache blocks in
  place (kernel B8, ops/cache_ops) without changing a live row's stream.
- Spans (utils/profiling.py, kept while the tracer is on): `engine.join`
  (rid: its requests' ids) over `join.vision`, `join.prefill`,
  `join.splice` and `join.first_token`; `engine.step` (rid: the index of
  its first decode forward) over `step.mask`, then for each forward
  `decode.draws`, `decode.upload` and `decode.dispatch` (the forward's
  launches, enqueued only), then `step.readback` and `step.bookkeeping`;
  `engine.compact`. With the tracer on, the host's waits on the card are
  counted under the span they happen in (`profiling`'s `syncs`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from handsonvlm_torch.infer.sampler import (
    EOS_TOKEN_ID,
    MAX_HAND_STEPS,
    PAD_TOKEN_ID,
    SampleOutput,
    prefill,
    sample_rows,
)
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.llama import KVCache, QuantKVCache, apply_llama, lm_logits
from handsonvlm_torch.ops.cache_ops import (
    build_row_table,
    count_removable_blocks,
    gather_cache_blocks,
)
from handsonvlm_torch.ops.decode_attention import pick_block_k
from handsonvlm_torch.utils import profiling


@dataclasses.dataclass
class _Slot:
    busy: bool = False
    max_new: int = 0
    seed: int = 0
    tokens: Optional[List[int]] = None
    wps: Optional[List[np.ndarray]] = None
    hands: Optional[List[bool]] = None
    done: bool = False


class ContinuousEngine:
    """Slot-based continuous decode over one persistent cache.

    Host API (every method is a chunk-boundary operation):
      can_admit(prompt_len) -> bool
      join(input_ids (1,Tp), images (1,F,3,H,W), seed, max_new) -> slot id
      join_many([request dicts]) -> slot ids
      step() -> list of (slot, SampleOutput) for requests finished this chunk
      compact() -> cursor positions reclaimed
      idle() -> True when no slot is busy

    `z_fn(seed, step)`, when given, returns the (2, latent_dim) CVAE latent
    of a request's step instead of a draw (tests inject another sampler's
    latents with it); the token draw still comes from the slot's generator.
    """

    def __init__(self, model, cfg, *, slots: int = 4, max_len: int = 2048, chunk: int = 8,
                 temperature: float = 0.5, top_p: float = 0.9, attn_impl: str = "auto",
                 kv_quant: Optional[str] = None, eos_token_id: int = EOS_TOKEN_ID,
                 z_fn: Optional[Callable[[int, int], np.ndarray]] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        self.model = model
        self.cfg = cfg
        self.b = slots
        self.s = max_len
        self.chunk = chunk
        self.temperature = temperature
        self.top_p = top_p
        self.attn_impl = attn_impl
        self.kv_quant = kv_quant
        self.eos = eos_token_id
        self.z_fn = z_fn

        weight = model.llama.embed_tokens.weight
        self.device, self.dtype = weight.device, weight.dtype
        lc = cfg.llama
        if kv_quant == "int8":
            # built directly (scales 1 dequantize the zeros)
            shape = (lc.num_layers, slots, max_len, lc.kv_heads, lc.head_dim_)
            sshape = (lc.num_layers, slots, lc.kv_heads, max_len)
            self.cache = QuantKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=self.device),
                v=torch.zeros(shape, dtype=torch.int8, device=self.device),
                ks=torch.ones(sshape, dtype=torch.float32, device=self.device),
                vs=torch.ones(sshape, dtype=torch.float32, device=self.device))
        else:
            self.cache = KVCache.create(lc, slots, max_len, self.dtype, self.device)
        self.pos = 0  # the shared cursor (= cache.index)
        self.mask = np.zeros((slots, max_len), bool)
        # per-row decode state on the device
        self.temps = torch.full((slots,), temperature, dtype=torch.float32, device=self.device)
        self.top_ps = torch.full((slots,), top_p, dtype=torch.float32, device=self.device)
        self.starts = torch.zeros((slots,), dtype=torch.long, device=self.device)
        self.cur_token = torch.zeros((slots,), dtype=torch.long, device=self.device)
        self.cur_waypoint = torch.zeros((slots, 2, 2), dtype=torch.float32, device=self.device)
        self.finished = torch.ones((slots,), dtype=torch.bool, device=self.device)
        # per-row draws on the host: a generator and the request's step
        self.gens = [torch.Generator() for _ in range(slots)]
        self.seeds = [0] * slots
        self.steps = [0] * slots
        self.slots = [_Slot() for _ in range(slots)]
        self._last_compact_pos = -1  # skip re-planning when nothing changed
        self.compactions = 0  # successful compaction events
        self.prefills = 0  # prefill calls (one per join or group join)
        self.decode_steps = 0  # decode forwards of the slot batch
        self.join_group_sizes: List[int] = []  # n of every join_many call

    # -- admission ----------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        # the transient prefill cache needs t_out + 1 positions, rounded to
        # 128 to keep the set of prefill shapes small
        t_out = prompt_len + self.cfg.num_visual_tokens - 1
        return -(-(t_out + 1) // 128) * 128

    def can_admit(self, prompt_len: int) -> bool:
        if not any(not s.busy for s in self.slots):
            return False
        # an idle engine reclaims the cursor on the next join: judge from 0
        pos = 0 if self.idle() else self.pos
        return pos + self._bucket(prompt_len) + self.chunk <= self.s

    def idle(self) -> bool:
        return not any(s.busy for s in self.slots)

    def _reset_if_idle(self) -> None:
        if self.idle() and self.pos > 0:
            # every plane is dead: reclaim the whole cursor range
            self.pos = 0
            self.cache.index = 0
            self.mask[:] = False

    def _draws(self, rows) -> np.ndarray:
        """(len(rows), 1 + 2 * latent_dim) host floats: each row's token
        draw (a uniform) and CVAE latent for its request's current step,
        from its own generator (the latent from z_fn when given); advances
        the rows' steps."""
        lat = self.cfg.traj.latent_dim
        out = np.zeros((len(rows), 1 + 2 * lat), np.float32)
        for i, r in enumerate(rows):
            out[i, 0] = float(torch.rand((), generator=self.gens[r]))
            z = self.cfg.traj.z_scale * torch.randn((2, lat), generator=self.gens[r])
            if self.z_fn is not None:
                z = self.z_fn(self.seeds[r], self.steps[r])
            out[i, 1:] = np.asarray(z, np.float32).reshape(-1)
            self.steps[r] += 1
        return out

    def _upload_draws(self, draws: np.ndarray):
        """Host draws -> (uniforms (n,), z (n * 2, latent)) on the device."""
        t = torch.from_numpy(draws).to(self.device)
        return t[:, 0], t[:, 1:].reshape(-1, self.cfg.traj.latent_dim)

    def _first_tokens(self, rows, seeds, last_hidden, temps, top_ps):
        """Seed the rows' generators and sample their first token and
        waypoint from the prefill's last hidden states (n, D)."""
        for r, seed in zip(rows, seeds):
            self.gens[r].manual_seed(seed)
            self.seeds[r], self.steps[r] = seed, 0
        u, z = self._upload_draws(self._draws(rows))
        logits = lm_logits(self.model.llama, self.cfg.llama, last_hidden)
        temps = torch.tensor(temps, dtype=torch.float32, device=self.device)
        top_ps = torch.tensor(top_ps, dtype=torch.float32, device=self.device)
        token = sample_rows(logits, temps, top_ps, u)
        waypoint = decode_hand_waypoint(self.model, self.cfg, last_hidden, z=z).float()
        idx = torch.tensor(rows, dtype=torch.long, device=self.device)
        self.temps[idx] = temps
        self.top_ps[idx] = top_ps
        self.cur_token[idx] = token
        self.cur_waypoint[idx] = waypoint
        self.finished[idx] = token == self.eos
        return token.cpu().numpy(), waypoint.cpu().numpy()

    def _splice(self, pcache, rows, at: int, s1: int) -> None:
        """Copy the transient prefill cache's rows into the persistent
        cache's planes `rows` at [at, at + s1)."""
        c = self.cache
        for i, r in enumerate(rows):
            c.k[:, r, at:at + s1] = pcache.k[:, i].to(c.k.dtype)
            c.v[:, r, at:at + s1] = pcache.v[:, i].to(c.v.dtype)
            if self.kv_quant == "int8":
                c.ks[:, r, :, at:at + s1] = pcache.ks[:, i]
                c.vs[:, r, :, at:at + s1] = pcache.vs[:, i]

    @torch.inference_mode()
    def join(self, input_ids, images, seed: int, max_new: int,
             temperature: Optional[float] = None, top_p: Optional[float] = None,
             frame_map=None) -> int:
        """Admit one request (the caller checked can_admit).

        `temperature`/`top_p` override the engine defaults for this request
        only. `frame_map` is the evaluator's dedup contract: `images` holds
        the unique frames and the map scatters them back."""
        return self._join([dict(input_ids=input_ids, images=images, seed=seed,
                                max_new=max_new, temperature=temperature, top_p=top_p,
                                frame_map=frame_map)])[0]

    @torch.inference_mode()
    def join_many(self, requests) -> List[int]:
        """Admit n requests with ONE prefill (the scheduler's burst path).

        Each request is a dict with input_ids (1,Tp), images, seed, max_new
        and optional temperature / top_p / frame_map. Prompts are LEFT-padded
        to the group's longest (rotary positions come from the mask, so each
        row keeps its solo positions) and every row is spliced into the same
        cursor span: the group consumes ONE prompt bucket. The caller
        checked n <= free slots, matching image and frame_map shapes, and
        can_admit(longest prompt)."""
        self.join_group_sizes.append(len(requests))
        return self._join(requests)

    def _join(self, requests) -> List[int]:
        rid = tuple(r.get("rid") for r in requests)
        with profiling.span("engine.join", rid):
            return self._join_rows(requests)

    def _join_rows(self, requests) -> List[int]:
        self._reset_if_idle()
        n = len(requests)
        id_rows = [np.asarray(r["input_ids"])[0] for r in requests]
        plens = [row.shape[0] for row in id_rows]
        p = max(plens)
        s1 = self._bucket(p)
        at = self.pos
        if at + s1 + self.chunk > self.s:
            raise RuntimeError("cache exhausted; check can_admit first")
        free = [i for i, s in enumerate(self.slots) if not s.busy]
        if len(free) < n:
            raise RuntimeError(f"{n} joins but only {len(free)} free slots")
        rows = free[:n]

        nv = self.cfg.num_visual_tokens
        ids = np.zeros((n, p), np.int64)
        attn = np.zeros((n, p), bool)
        for i, row in enumerate(id_rows):
            ids[i, p - row.shape[0]:] = row
            attn[i, p - row.shape[0]:] = True
        images = torch.cat([torch.as_tensor(r["images"], device=self.device)
                            for r in requests]).to(self.dtype)
        fmaps = [r.get("frame_map") for r in requests]
        frame_map = None
        if fmaps[0] is not None:
            frame_map = torch.as_tensor(np.stack([np.asarray(m).reshape(-1) for m in fmaps]),
                                        device=self.device)
            if n == 1:
                frame_map = frame_map[0]
        last_hidden, pcache, _ = prefill(
            self.model, self.cfg, torch.as_tensor(ids, device=self.device), images, s1,
            attn_mask=None if n == 1 else torch.as_tensor(attn, device=self.device),
            attn_impl=self.attn_impl, frame_map=frame_map, kv_quant=self.kv_quant,
            positions_from_mask=n > 1)
        self.prefills += 1
        with profiling.span("join.splice"):
            self._splice(pcache, rows, at, s1)
        del pcache
        self.pos = self.cache.index = at + s1
        # the rows already live step over the new bucket (a masked hole in
        # their planes): their starts move with the cursor, so their rotary
        # positions go on from where they were, as in a solo decode
        live = [r for r, slot in enumerate(self.slots) if slot.busy]
        if live:
            self.starts[torch.tensor(live, device=self.device)] += s1

        t_outs = [pl + nv - 1 for pl in plens]
        t_pad = p + nv - 1
        for i, r in enumerate(rows):
            # left padding: row i's real span is the LAST t_outs[i] of the
            # group's [at, at + t_pad) splice window
            self.mask[r, :] = False
            self.mask[r, at + t_pad - t_outs[i]:at + t_pad] = True
        starts = torch.tensor([at + s1 - t for t in t_outs], dtype=torch.long,
                              device=self.device)
        self.starts[torch.tensor(rows, device=self.device)] = starts
        temps = [self.temperature if r.get("temperature") is None else r["temperature"]
                 for r in requests]
        top_ps = [self.top_p if r.get("top_p") is None else r["top_p"] for r in requests]
        with profiling.span("join.first_token"):
            tok, wp = self._first_tokens(rows, [r["seed"] for r in requests], last_hidden,
                                         temps, top_ps)
        for i, r in enumerate(rows):
            t0 = int(tok[i])
            self.slots[r] = _Slot(busy=True, max_new=requests[i]["max_new"],
                                  seed=requests[i]["seed"],
                                  tokens=[t0], wps=[wp[i]],
                                  hands=[t0 == self.cfg.hand_token_id], done=t0 == self.eos)
        return rows

    # -- decode -------------------------------------------------------------

    @torch.inference_mode()
    def step(self):
        """`chunk` decode steps for every slot; returns the finished
        requests. Idle and finished rows decode masked garbage that the
        host discards; their draws are not taken."""
        with profiling.span("engine.step", self.decode_steps):
            return self._step()

    def _step(self):
        if self.pos + self.chunk > self.s:
            raise RuntimeError("cache exhausted")
        # the chunk writes [pos, pos + chunk) for every row
        self.mask[:, self.pos:self.pos + self.chunk] = True
        with profiling.span("step.mask"):
            mask = torch.as_tensor(self.mask, device=self.device)
        busy = [r for r, s in enumerate(self.slots) if s.busy]
        draws = np.zeros((self.b, 1 + 2 * self.cfg.traj.latent_dim), np.float32)
        tokens, wps = [], []
        for _ in range(self.chunk):
            with profiling.span("decode.draws"):
                if busy:
                    draws[busy] = self._draws(busy)
            with profiling.span("decode.upload"):
                u, z = self._upload_draws(draws)
            with profiling.span("decode.dispatch"):
                emb = embed_next_token(self.model, self.cfg, self.cur_token, self.cur_waypoint)
                positions = (self.cache.index - self.starts)[:, None]
                hidden, _ = apply_llama(self.model.llama, self.cfg.llama,
                                        inputs_embeds=emb[:, None, :], attn_mask=mask,
                                        positions=positions, kv_cache=self.cache,
                                        attn_impl=self.attn_impl, lora=self.model.lora)
                h = hidden[:, 0]
                logits = lm_logits(self.model.llama, self.cfg.llama, h)
                ntok = sample_rows(logits, self.temps, self.top_ps, u)
                nwp = decode_hand_waypoint(self.model, self.cfg, h, z=z).float()
                ntok = torch.where(self.finished, PAD_TOKEN_ID, ntok)
                tokens.append(ntok)
                wps.append(nwp)
                self.finished = self.finished | (ntok == self.eos)
                self.cur_token, self.cur_waypoint = ntok, nwp
            self.decode_steps += 1
        self.pos = self.cache.index
        # one copy to the host for the whole chunk
        with profiling.span("step.readback"):
            packed = torch.cat([torch.stack(tokens, 1).float()[..., None],
                                torch.stack(wps, 1).reshape(self.b, self.chunk, 4)], -1).cpu()
        toks = packed[..., 0].numpy().astype(np.int64)
        wps_h = packed[..., 1:].numpy().reshape(self.b, self.chunk, 2, 2)

        done = []
        with profiling.span("step.bookkeeping"):
            for r, slot in enumerate(self.slots):
                if not slot.busy:
                    continue
                for i in range(self.chunk):
                    if slot.done or len(slot.tokens) >= slot.max_new:
                        break
                    tok = int(toks[r, i])
                    slot.tokens.append(tok)
                    slot.wps.append(wps_h[r, i])
                    slot.hands.append(tok == self.cfg.hand_token_id)
                    if tok == self.eos:
                        slot.done = True
                if slot.done or len(slot.tokens) >= slot.max_new:
                    done.append((r, self._finalize(slot)))
                    self.slots[r] = _Slot()
        return done

    @torch.inference_mode()
    def compact(self) -> int:
        """Block-aligned compaction: pull every live row's valid cache
        blocks toward the front and reclaim the cursor slack (the dead
        buckets of finished requests and the holes each join burned into
        the other rows' planes).

        The same number h of fully-invalid blocks is deleted from every
        live row (h = the least headroom over the live rows,
        ops/cache_ops.count_removable_blocks) and the cursor moves back by
        h * block_k. Valid blocks keep their content, lane masks and order,
        and every row's later writes stay congruent mod block_k, so the
        decode attention's block sweep (B1/B6) sees the same inputs and a
        live row's stream is bit-equal across the event. Positions are
        `index - starts`, and both move by the same delta.

        Returns the cursor positions reclaimed (0: not worth a rewrite, or
        nothing changed since the last attempt). Cost: one in-place pass
        over the moved blocks of each cache plane (B8), no second cache."""
        with profiling.span("engine.compact"):
            return self._compact()

    def _compact(self) -> int:
        if self.idle():
            reclaimed = self.pos
            if reclaimed:
                self.pos = self.cache.index = 0
                self.mask[:] = False
            return reclaimed
        if self.pos == self._last_compact_pos:
            return 0
        bk = pick_block_k(self.s)
        if self.s % bk:
            return 0  # no block-aligned view of this cache length
        nk = self.s // bk
        pos = min(self.pos, self.s)
        h = min((count_removable_blocks(self.mask[r], pos, bk)
                 for r in range(self.b) if self.slots[r].busy), default=0)
        reclaimed = h * bk
        if reclaimed < self.chunk:
            self._last_compact_pos = self.pos
            return 0
        tables = np.tile(np.arange(nk, dtype=np.int32), (self.b, 1))
        new_mask = np.zeros_like(self.mask)
        for r in range(self.b):
            if self.slots[r].busy:  # a dead plane keeps identity blocks
                tables[r], new_mask[r] = build_row_table(self.mask[r], pos, bk, nk, h)
        table = torch.as_tensor(tables, device=self.device)
        c = self.cache
        gather_cache_blocks(c.k, table, block_k=bk)
        gather_cache_blocks(c.v, table, block_k=bk)
        if self.kv_quant == "int8":
            gather_cache_blocks(c.ks, table, block_k=bk, seq_axis=3)
            gather_cache_blocks(c.vs, table, block_k=bk, seq_axis=3)
        new_len = self.pos - reclaimed
        self.starts -= reclaimed
        self.mask = new_mask
        self.pos = c.index = new_len
        self.compactions += 1
        return reclaimed

    def drain(self):
        """Finalize every busy slot with what it has (host only). Used when
        the cursor would overrun with rows still live: their generations
        come back truncated."""
        done = []
        for r, slot in enumerate(self.slots):
            if slot.busy:
                done.append((r, self._finalize(slot)))
                self.slots[r] = _Slot()
        return done

    def _finalize(self, slot: _Slot) -> SampleOutput:
        n = len(slot.tokens)
        toks = np.full((1, slot.max_new), PAD_TOKEN_ID, np.int32)
        toks[0, :n] = slot.tokens
        pred = np.zeros((1, MAX_HAND_STEPS, 2, 2), np.float32)
        nh = 0
        for j, is_hand in enumerate(slot.hands):
            if is_hand and nh < MAX_HAND_STEPS:
                pred[0, nh] = slot.wps[j]
                nh += 1
        return SampleOutput(
            sequences=toks,
            num_tokens=np.asarray([n], np.int32),
            pred_hands=np.ascontiguousarray(pred.transpose(0, 2, 1, 3)),
            num_hands=np.asarray([nh], np.int32),
        )
