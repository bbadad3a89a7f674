"""EK100 trajectory evaluation harness.

Port of `handsonvlm_tpu/eval/evaluator.py`. Protocol: a deterministic
conversation dataset (items with "prompt", "image" (T, 3, H, W) frames,
"future_hands" (2, 5, 2) and "future_valid" (2,)), sampled decode
(temperature 0.5, top-p 0.9), each prediction clipped / padded to 4 steps
(zero-pad, or the last 4), scored by the stochastic ADE/FDE/WDE with the
reference's name swap (eval/traj_metrics).

Two modes:
- serial: the cached sampler (`generate_host`) once per (clip, sample), or
  with `spec_k` > 0 the speculative sampler (`generate_spec`) with the
  answer-template bank as its draft source (exact in distribution, so the
  metrics keep their sampling semantics);
- `batched=SLOTS`: every decode goes through the continuous-batching
  scheduler (serve/scheduler.py), SLOTS requests sharing one decode batch.
  Each request's draws and rotary positions do not depend on the batch;
  its logits differ from serial only by rounding (its keys sit elsewhere
  in the shared cache), the same class of difference as another sampling
  seed, which the stochastic protocol averages over.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from handsonvlm_torch.constants import DEFAULT_IMAGE_TOKEN
from handsonvlm_torch.data.conversation import conv_templates
from handsonvlm_torch.data.tokenization import tokenizer_image_token
from handsonvlm_torch.eval.traj_metrics import evaluate_traj_stochastic
from handsonvlm_torch.infer.sampler import clip_pred_hands, generate_host
from handsonvlm_torch.infer.speculative import build_template_bank, generate_spec


@dataclasses.dataclass
class InferenceEngine:
    """The evaluator's model front end: prompts, frame dedup, decode."""

    model: object  # HandsOnVLM
    cfg: object  # HandsOnVLMConfig
    tokenizer: object
    conv_mode: str = "v1"
    temperature: float = 0.5
    top_p: float = 0.9
    max_new_tokens: int = 100
    pad_prompt_multiple: int = 32  # bucket prompt lengths
    spec_k: int = 0  # > 0: B = 1 requests decode speculatively, K-token drafts
    kv_quant: Optional[str] = None  # "int8": decode over the int8 cache

    @property
    def device(self):
        return self.model.llama.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.llama.embed_tokens.weight.dtype

    def build_prompt_ids(self, question: str, history=()) -> np.ndarray:
        """`history` holds past turns [(user, assistant), ...]; the <image>
        token goes on the first human turn only."""
        conv = conv_templates[self.conv_mode].copy()
        for j, (user, assistant) in enumerate(history):
            text = DEFAULT_IMAGE_TOKEN + "\n" + user if j == 0 else user
            conv.append_message(conv.roles[0], text)
            conv.append_message(conv.roles[1], assistant)
        q = question if history else DEFAULT_IMAGE_TOKEN + "\n" + question
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        return np.asarray(ids, np.int64)[None, :]

    @staticmethod
    def dedup_frames(images: np.ndarray):
        """(B,T,...) -> (unique images (B,U,...), frame_map) when frames
        repeat (the EK protocol tiles 10 unique frames x10); CLIP then runs
        U frames instead of T.

        B == 1 returns a shared (T,) map; B > 1 dedups per row and returns
        a (B,T) map (rows with fewer unique frames repeat their first one up
        to the batch's U; the map never points at the padding). Returns
        (images, None) when nothing repeats."""
        b, t = images.shape[:2]
        maps = np.empty((b, t), np.int32)
        uniqs = []
        for r in range(b):
            seen: dict = {}
            uniq = []
            for i in range(t):
                key = images[r, i].tobytes()
                if key not in seen:
                    seen[key] = len(uniq)
                    uniq.append(i)
                maps[r, i] = seen[key]
            uniqs.append(uniq)
        u_max = max(len(u) for u in uniqs)
        if u_max == t:
            return images, None
        out = np.empty((b, u_max) + images.shape[2:], images.dtype)
        for r, uniq in enumerate(uniqs):
            out[r, : len(uniq)] = images[r, uniq]
            out[r, len(uniq):] = images[r, uniq[0]]
        if b == 1:
            return out, maps[0]
        return out, maps

    def _pad_to_bucket(self, id_rows):
        """LEFT-pad rows to a shared bucket (a multiple of
        pad_prompt_multiple), so the last prompt position stays real
        content."""
        m = self.pad_prompt_multiple
        t_max = max(r.shape[0] for r in id_rows)
        bucket = ((t_max + m - 1) // m) * m
        b = len(id_rows)
        ids = np.full((b, bucket), self.tokenizer.pad_token_id, np.int64)
        attn = np.zeros((b, bucket), bool)
        for i, r in enumerate(id_rows):
            ids[i, bucket - r.shape[0]:] = r
            attn[i, bucket - r.shape[0]:] = True
        return ids, attn

    def infer(self, question: str, images: np.ndarray, generator, model=None, history=(), *,
              temperature=None, top_p=None, max_new_tokens=None, on_token=None,
              stop_strs=None):
        """question + (1, T, 3, H, W) frames -> (pred (1,2,4,2), valid,
        generated ids). `model` overrides self.model for this call;
        `temperature` / `top_p` / `max_new_tokens` override the defaults
        for this call only. `on_token` (token_id -> None) streams the
        tokens as they are sampled (in bursts under speculative decode);
        `stop_strs` finish the host decode at a stop string."""
        preds, valids, gen = self.infer_batch(
            [question], images, generator, model=model, histories=[history],
            temperature=temperature, top_p=top_p, max_new_tokens=max_new_tokens,
            on_token=on_token, stop_strs=stop_strs)
        return preds, valids, gen[0]

    def infer_batch(self, questions, images: np.ndarray, generator, model=None,
                    histories=None, *, temperature=None, top_p=None, max_new_tokens=None,
                    on_token=None, stop_strs=None):
        """B questions + (B, T, ...) frames -> (pred (B,2,4,2), valid (B,),
        [generated ids per row]); draws come from `generator` (on the
        model's device). `on_token` / `stop_strs` as in `infer` (row 0's
        tokens)."""
        histories = histories or [()] * len(questions)
        temperature = self.temperature if temperature is None else temperature
        top_p = self.top_p if top_p is None else top_p
        max_new_tokens = self.max_new_tokens if max_new_tokens is None else max_new_tokens
        rows = [self.build_prompt_ids(q, h)[0] for q, h in zip(questions, histories)]
        ids, attn = self._pad_to_bucket(rows)
        images, frame_map = self.dedup_frames(np.asarray(images))
        images = torch.as_tensor(images, device=self.device, dtype=self.dtype)
        model = self.model if model is None else model
        if self.spec_k > 0 and len(rows) == 1:
            out = self._infer_spec(model, ids, attn, images, frame_map, generator,
                                   temperature=temperature, top_p=top_p,
                                   max_new_tokens=max_new_tokens, on_token=on_token)
        else:
            out = generate_host(
                model, self.cfg, ids, images, generator, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, attn_mask=attn, frame_map=frame_map,
                on_token=on_token, stop_strs=stop_strs,
                tokenizer=self.tokenizer, kv_quant=self.kv_quant)
        pred, valid = clip_pred_hands(out.pred_hands, out.num_hands)
        gen_ids = [np.asarray(out.sequences[i, : int(out.num_tokens[i])])
                   for i in range(len(rows))]
        return pred, valid, gen_ids

    def _infer_spec(self, model, ids, attn, images, frame_map, generator, *, temperature,
                    top_p, max_new_tokens, on_token=None):
        """The B = 1 latency path: speculative decode with the template
        bank, tokenized once per engine."""
        if not hasattr(self, "_spec_bank"):
            self._spec_bank = build_template_bank(self.tokenizer, self.cfg)
        out, stats = generate_spec(
            model, self.cfg, ids, images, generator, max_new_tokens=max_new_tokens,
            k=self.spec_k, temperature=temperature, top_p=top_p, attn_mask=attn,
            frame_map=frame_map, bank_ids=self._spec_bank, on_token=on_token,
            kv_quant=self.kv_quant)
        self.spec_stats = stats  # the last request's, for callers that report yield
        return out

    def scheduler(self, slots: int, max_len: int, chunk: int):
        """The continuous-batching scheduler of this engine for (slots,
        max_len, chunk), made once and reused across evaluate calls (its
        cache is the size of a serving cache). The key holds everything the
        scheduler was built from: the model's identity and the decode
        settings too. A scheduler whose loop thread died is rebuilt."""
        from handsonvlm_torch.serve.scheduler import ContinuousScheduler

        key = (id(self.model), slots, max_len, chunk, self.temperature, self.top_p,
               self.kv_quant)
        scheds = self.__dict__.setdefault("_batched_scheds", {})
        sched = scheds.get(key)
        if sched is None or not sched.alive():
            if sched is not None:
                sched.stop()
            # admit_hold_s: a submit wave coalesces into full-width joins
            sched = scheds[key] = ContinuousScheduler(
                self.model, self.cfg, slots=slots, max_len=max_len, chunk=chunk,
                temperature=self.temperature, top_p=self.top_p, kv_quant=self.kv_quant,
                admit_hold_s=0.25)
        return sched


def _infer_all_batched(engine: InferenceEngine, dataset, n: int, num_samples: int, seed: int,
                       slots: int, max_len: int, chunk: int):
    """Run every (clip, sample) decode through the engine's scheduler.

    A producer thread prepares requests (prompt, frame dedup, one image
    upload per clip, shared by its samples) into a bounded queue; runner
    threads submit them. Returns {clip: ([(pred, valid)] * num_samples,
    generated ids of sample 0, tokens generated over the samples)}."""
    sched = engine.scheduler(slots, max_len, chunk)
    results: Dict = {}
    errors = []
    n_consumers = max(2 * slots, 4)
    prepared: queue.Queue = queue.Queue(maxsize=max(4 * slots, 8))

    def producer():
        try:
            for i in range(n):
                sample = dataset[i]
                ids = engine.build_prompt_ids(sample["prompt"])
                images, fmap = engine.dedup_frames(np.asarray(sample["image"])[None])
                images = torch.as_tensor(images, device=engine.device, dtype=engine.dtype)
                for s in range(num_samples):
                    prepared.put((i, s, ids, images, fmap))
        except Exception as e:  # noqa: BLE001 - reported after the join
            errors.append(("producer", -1, repr(e)))
        finally:
            for _ in range(n_consumers):
                prepared.put(None)

    def runner():
        while True:
            item = prepared.get()
            if item is None:
                return
            i, s, ids, images, fmap = item
            try:
                results[(i, s)] = sched.submit(
                    ids, images, seed=seed * 1_000_003 + i * num_samples + s,
                    max_new=engine.max_new_tokens, frame_map=fmap, timeout=3600)
            except Exception as e:  # noqa: BLE001 - reported after the join
                errors.append((i, s, repr(e)))

    threads = [threading.Thread(target=producer)] + [
        threading.Thread(target=runner) for _ in range(n_consumers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"batched eval failed on {errors[:3]} "
                           f"(+{max(0, len(errors) - 3)} more)")

    clip_outputs = {}
    for i in range(n):
        outs = [results[(i, s)] for s in range(num_samples)]
        sp = [clip_pred_hands(o.pred_hands, o.num_hands) for o in outs]
        n_tok = int(outs[0].num_tokens[0])
        clip_outputs[i] = (sp, np.asarray(outs[0].sequences[0, :n_tok]),
                           sum(int(o.num_tokens[0]) for o in outs))
    return clip_outputs


def evaluate_epic_kitchen_traj(
    engine: InferenceEngine,
    dataset,
    seed: int = 0,
    log_every: int = 50,
    limit: Optional[int] = None,
    num_samples: int = 1,
    batched: int = 0,
    batched_max_len: int = 4096,
    batched_chunk: int = 16,
) -> Dict:
    """Loop a deterministic conversation dataset, score stochastic ADE/FDE.

    `num_samples` > 1 decodes each clip several times and scores the
    min/mean-over-samples protocol. `batched` > 0 routes the decodes
    through the continuous-batching scheduler with that many slots.
    Returns {'ade', 'fde', 'wde', 'n', 'val_info'}; val_info[i] also holds
    the clip's generated ids of sample 0 ('gen_ids') and the tokens its
    samples generated ('num_tokens')."""
    generator = torch.Generator(device=engine.device).manual_seed(seed)
    preds, gts, valids = [], [], []
    val_info = {}
    n = len(dataset) if limit is None else min(limit, len(dataset))
    clip_outputs = None
    if batched > 0:
        clip_outputs = _infer_all_batched(engine, dataset, n, num_samples, seed, batched,
                                          batched_max_len, batched_chunk)
    for i in range(n):
        sample = dataset[i]
        if clip_outputs is not None:
            sample_preds, gen_ids, n_tok = clip_outputs[i]
        else:
            sample_preds, n_tok = [], 0
            for s in range(num_samples):
                pred_k, valid_k, ids_k = engine.infer(
                    sample["prompt"], np.asarray(sample["image"])[None], generator)
                sample_preds.append((pred_k, valid_k))
                n_tok += len(ids_k)
                if s == 0:
                    gen_ids = ids_k
        # a clip counts when every stochastic decode produced a trajectory
        valid = np.stack([v for _, v in sample_preds]).all(axis=0)
        pred = sample_preds[0][0]  # representative decode for val_info
        future_hands = np.asarray(sample["future_hands"])[None]  # (1,2,5,2)
        future_valid = np.asarray(sample["future_valid"])[None]  # (1,2)
        val_info[i] = {
            "pred_hand_trajectory": pred[None] if valid[0] else None,
            "pred_trajectory_is_valid": bool(valid[0]),
            "future_hands": future_hands,
            "future_valid": future_valid,
            "prompt": sample["prompt"],
            "text": (engine.tokenizer.decode(gen_ids)
                     if hasattr(engine.tokenizer, "decode") else None),
            "gen_ids": np.asarray(gen_ids),
            "num_tokens": n_tok,
        }
        if valid[0]:
            stacked = np.stack([p for p, _ in sample_preds], axis=1)  # (1,S,2,4,2)
            preds.append(stacked)
            gts.append(future_hands[:, :, 1:, :])  # drop the last observed point
            valids.append(future_valid)
        if log_every and (i + 1) % log_every == 0 and preds:
            ade, fde, wde = evaluate_traj_stochastic(
                np.concatenate(preds), np.concatenate(gts), np.concatenate(valids))
            print(f"[{i + 1}/{n}] ADE {ade:.4f} FDE {fde:.4f} WDE {wde:.4f}")

    if not preds:
        return {"ade": float("nan"), "fde": float("nan"), "wde": float("nan"), "n": 0,
                "val_info": val_info}
    ade, fde, wde = evaluate_traj_stochastic(
        np.concatenate(preds), np.concatenate(gts), np.concatenate(valids))
    return {"ade": ade, "fde": fde, "wde": wde, "n": len(preds), "val_info": val_info}
