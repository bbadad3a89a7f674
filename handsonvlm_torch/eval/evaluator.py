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

Draws: the serial mode takes every clip's draws from one generator seeded
with `seed`, clip after clip (the eval CLI's). A run given the `clips` to
decode gives sample s of clip i a generator of its own, seeded
`clip_seed(seed, i, num_samples, s)`, the seed the batched mode gives its
requests, and the dataset's draws for clip i's item (its question
template) generators seeded from (seed, i), so a clip's draws do not
depend on which clips a run decodes: the train CLI splits
`--eval-samples` over its data groups, each group decoding its clips on
its tensor-parallel shards (`InferenceEngine.tp`), and scores the union of
the groups' per-clip records (`score_clips`) in clip order.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from handsonvlm_torch.constants import DEFAULT_IMAGE_TOKEN
from handsonvlm_torch.data.conversation import conv_templates
from handsonvlm_torch.data.tokenization import tokenizer_image_token
from handsonvlm_torch.eval.traj_metrics import evaluate_traj_stochastic
from handsonvlm_torch.infer.sampler import clip_pred_hands, generate_host
from handsonvlm_torch.infer.speculative import build_template_bank, generate_spec
from handsonvlm_torch.parallel.tp import tp_size


def clip_seed(seed: int, clip: int, num_samples: int, sample: int) -> int:
    """The seed of sample `sample` of clip `clip`'s draws (per-clip draws
    and the batched mode's requests)."""
    return seed * 1_000_003 + clip * num_samples + sample


def clip_item(dataset, i: int, seed: Optional[int] = None):
    """Clip i of `dataset`. With a `seed`, a dataset that draws while it
    reads an item (an EPIC conversation dataset's question template)
    draws from generators seeded `clip_seed(seed, i, 1, 0)` (its
    `route_draws`), so the item does not depend on the items read before
    it."""
    if seed is not None and hasattr(dataset, "route_draws"):
        s = clip_seed(seed, i, 1, 0)
        dataset.route_draws(random.Random(s), np.random.default_rng(s))
    return dataset[i]


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
    # a parallel.tp.TPGroup: the model is this rank's shard of the group
    # (parallel.tp.shard_llama_tp), and every rank of the group makes the
    # same calls in lockstep
    tp: object = None

    def __post_init__(self):
        if self.spec_k > 0 and tp_size(self.tp) > 1:
            raise ValueError("spec_k > 0 with a tensor-parallel group: speculative decode "
                             "runs whole models on one rank (parallel/tp.py check_layout)")

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
                tokenizer=self.tokenizer, kv_quant=self.kv_quant, tp=self.tp)
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


def _infer_all_batched(engine: InferenceEngine, dataset, clips: Sequence[int], num_samples: int,
                       seed: int, slots: int, max_len: int, chunk: int,
                       item_seed: Optional[int] = None):
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
            for i in clips:
                sample = clip_item(dataset, i, item_seed)
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
                    ids, images, seed=clip_seed(seed, i, num_samples, s),
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
    for i in clips:
        outs = [results[(i, s)] for s in range(num_samples)]
        sp = [clip_pred_hands(o.pred_hands, o.num_hands) for o in outs]
        n_tok = int(outs[0].num_tokens[0])
        clip_outputs[i] = (sp, np.asarray(outs[0].sequences[0, :n_tok]),
                           sum(int(o.num_tokens[0]) for o in outs))
    return clip_outputs


def score_clips(val_info: Dict) -> Dict:
    """The stochastic ADE / FDE / WDE and `n` over the clips of `val_info`
    ({clip: record}, `evaluate_epic_kitchen_traj`'s, or the union of
    several runs' over disjoint clips) that have a trajectory, in clip
    order: NaN and n = 0 when none has."""
    scored = [val_info[i] for i in sorted(val_info) if val_info[i]["pred_trajectory_is_valid"]]
    if not scored:
        return {"ade": float("nan"), "fde": float("nan"), "wde": float("nan"), "n": 0}
    ade, fde, wde = evaluate_traj_stochastic(
        np.concatenate([v["pred_samples"] for v in scored]),
        # the ground truth without its first point, the last one observed
        np.concatenate([v["future_hands"][:, :, 1:, :] for v in scored]),
        np.concatenate([v["future_valid"] for v in scored]))
    return {"ade": ade, "fde": fde, "wde": wde, "n": len(scored)}


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
    clips: Optional[Sequence[int]] = None,
) -> Dict:
    """Loop a deterministic conversation dataset, score stochastic ADE/FDE.

    `num_samples` > 1 decodes each clip several times and scores the
    min/mean-over-samples protocol. `batched` > 0 routes the decodes
    through the continuous-batching scheduler with that many slots.
    `clips` decodes only those of the first `limit` clips, each (clip,
    sample) decode and each item's own draws seeded on their own
    (`clip_seed`, `clip_item`) instead of every clip drawing from one
    generator: passing `clips` selects the per-clip draws, so
    `clips=range(n)` and `clips=None` decode the same clips with other
    draws (the eval CLI passes None and keeps its serial draws).
    Returns {'ade', 'fde', 'wde', 'n', 'val_info'}; val_info[i] is clip i's
    record: its predictions ('pred_samples' (1, S, 2, 4, 2)), ground truth
    ('future_hands', 'future_valid'), whether every sample produced a
    trajectory ('pred_trajectory_is_valid'), the generated ids of sample 0
    ('gen_ids') and the tokens its samples generated ('num_tokens'), so
    that `score_clips` scores the union of several runs' records."""
    if batched > 0 and tp_size(engine.tp) > 1:
        raise ValueError("batched > 0 with a tensor-parallel group: the continuous-batching "
                         "scheduler runs a whole model on one rank")
    generator = torch.Generator(device=engine.device).manual_seed(seed)
    item_seed = None if clips is None else seed
    val_info = {}
    n = len(dataset) if limit is None else min(limit, len(dataset))
    clips = list(range(n)) if clips is None else [i for i in clips if i < n]
    clip_outputs = None
    if batched > 0:
        clip_outputs = _infer_all_batched(engine, dataset, clips, num_samples, seed, batched,
                                          batched_max_len, batched_chunk, item_seed)
    for done, i in enumerate(clips, 1):
        sample = clip_item(dataset, i, item_seed)
        if clip_outputs is not None:
            sample_preds, gen_ids, n_tok = clip_outputs[i]
        else:
            sample_preds, n_tok = [], 0
            for s in range(num_samples):
                if item_seed is not None:
                    generator = torch.Generator(device=engine.device).manual_seed(
                        clip_seed(seed, i, num_samples, s))
                pred_k, valid_k, ids_k = engine.infer(
                    sample["prompt"], np.asarray(sample["image"])[None], generator)
                sample_preds.append((pred_k, valid_k))
                n_tok += len(ids_k)
                if s == 0:
                    gen_ids = ids_k
        # a clip counts when every stochastic decode produced a trajectory
        valid = np.stack([v for _, v in sample_preds]).all(axis=0)
        pred = sample_preds[0][0]  # representative decode for val_info
        val_info[i] = {
            "pred_hand_trajectory": pred[None] if valid[0] else None,
            "pred_trajectory_is_valid": bool(valid[0]),
            "pred_samples": np.stack([p for p, _ in sample_preds], axis=1),  # (1,S,2,4,2)
            "future_hands": np.asarray(sample["future_hands"])[None],  # (1,2,5,2)
            "future_valid": np.asarray(sample["future_valid"])[None],  # (1,2)
            "prompt": sample["prompt"],
            "text": (engine.tokenizer.decode(gen_ids)
                     if hasattr(engine.tokenizer, "decode") else None),
            "gen_ids": np.asarray(gen_ids),
            "num_tokens": n_tok,
        }
        if log_every and done % log_every == 0:
            scores = score_clips(val_info)
            if scores["n"]:
                print(f"[{done}/{len(clips)}] ADE {scores['ade']:.4f} FDE {scores['fde']:.4f} "
                      f"WDE {scores['wde']:.4f}")
    return dict(score_clips(val_info), val_info=val_info)


def evaluate_sharded(model, cfg, tokenizer, dataset, mesh=None, *, seed: int = 0,
                     limit: Optional[int] = None, **engine) -> Dict:
    """`evaluate_epic_kitchen_traj` of a model sharded for training over
    `mesh` (`parallel.partition.shard_model`, after `tp.shard_for_training`
    on a model axis; every rank calls it), with per-clip draws. The clips go
    to the eval groups, clip i to group i mod G: the model groups of a
    ('data', 'model') mesh (row-major, as `create_mesh` lays out the
    ranks), each decoding its clips in lockstep on its ranks' slices, or
    every rank on its own (FSDP2 alone, a ('data', 'seq') mesh). Each rank
    decodes from `parallel.partition.eval_model`, its slices whole over
    `data`; the groups' records are gathered on every rank and scored once
    over their union in clip order. Returns {'ade', 'fde', 'wde', 'n',
    'val_info'} (val_info the union) on every rank. Without a mesh: this
    rank alone (a whole model), the same draws, nothing gathered. `engine`
    holds InferenceEngine's decode settings."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel.distributed import gather_records
    from handsonvlm_torch.parallel.mesh import model_group
    from handsonvlm_torch.parallel.partition import eval_model

    tp = model_group(mesh)
    world = 1 if mesh is None else dist.get_world_size()
    groups = world // tp_size(tp)
    group = dist.get_rank() // tp_size(tp) if world > 1 else 0
    eng = InferenceEngine(model=eval_model(model, cfg), cfg=cfg, tokenizer=tokenizer, tp=tp,
                          **engine)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    res = evaluate_epic_kitchen_traj(eng, dataset, seed=seed, log_every=0, limit=n,
                                     clips=range(group, n, groups))
    if mesh is None:
        return res
    # a model group's ranks decode the same clips: its first rank sends them
    records = gather_records(res["val_info"] if tp is None or tp.rank == 0 else {})
    return dict(score_clips(records), val_info=records)
