"""What the served cells share: the program's model and scheduler over the
seeded weights, the frame pool, spans and counters taken around the
engine's `join_many` and `step` from outside, the traced slice, and the
output check (a sample of the finished greedy and sampled requests
replayed through the fp32 reference)."""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hov_bench.core import work
from hov_bench.core.weights import derive, generator, load_program_model, make_weights
from hov_bench.reference.model import (
    Reference,
    dims_of,
    draw_gaps,
    draw_tokens,
    draws,
    nucleus_cdf,
)


class Served:
    """Subclasses set up the scheduler (`self.sched`) and run the window."""

    def __init__(self, run):
        self.run = run
        self.spec, self.mix = run.spec, run.mix
        self.cfg = run.spec.cfg
        self.records: List[dict] = []
        self.lock = threading.Lock()
        self.t0: Optional[float] = None
        self.t_end: Optional[float] = None
        self.slice_t0: Optional[float] = None
        self.slice_done = False

    # -- set-up ---------------------------------------------------------------

    def build_model(self):
        from handsonvlm_torch.eval.evaluator import InferenceEngine
        from handsonvlm_torch.infer.builder import load_tokenizer

        run = self.run
        w = make_weights(self.spec, run.seed, run.device, steer=bool(self.mix.get("steer", True)))
        self.model = load_program_model(self.spec, w)
        del w
        self.ie = InferenceEngine(model=self.model, cfg=self.cfg, tokenizer=load_tokenizer(None),
                                  temperature=float(self.mix["temperature"]),
                                  top_p=float(self.mix["top_p"]),
                                  kv_quant=self.spec.kv_quant)
        self.frames = self.frame_pool(run.device)
        u, t = self.mix["frames"]["unique"], self.cfg.num_frames
        tiled = np.tile(np.arange(u, dtype=np.float32), t // u)[None, :, None]
        self.fmap = self.ie.dedup_frames(tiled)[1]  # the eval path's dedup of a tiled clip

    def frame_pool(self, device) -> torch.Tensor:
        """(pool, unique, 3, H, W) seeded CLIP-normalised frames in the
        served dtype, made on the device."""
        f, size = self.mix["frames"], self.cfg.vision.image_size
        g = generator(self.run.seed, device, "frames")
        return torch.randn((f["pool"], f["unique"], 3, size, size), generator=g,
                           device=device).to(self.cfg.pdtype)

    def wrap_engine(self):
        """Spans and counters around the engine instance's `join_many` and
        `step`, and the traced slice started and stopped at step
        boundaries."""
        eng = self.sched.engine
        self.eng = eng
        run = self.run
        join, step = eng.join_many, eng.step
        nv = self.cfg.num_visual_tokens
        L = self.cfg.llama.num_layers
        kv_bytes = 1 + 4 / self.cfg.llama.head_dim_ if self.spec.kv_quant == "int8" else 2

        def in_window(t):
            return self.t0 is not None and self.t0 <= t < self.t_end

        def wrapped_join(requests):
            t = time.perf_counter()
            rows = [np.asarray(r["input_ids"]).shape[1] + nv - 1 for r in requests]
            out = join(requests)
            if in_window(t):
                run.spans.setdefault("join", []).append(time.perf_counter() - t)
                u = self.mix["frames"]["unique"]
                run.counters["flops"] = run.counters.get("flops", 0.0) + sum(
                    work.prefill_flops(self.cfg, r, u) for r in rows)
            if run.slice.running and self.spec.quantize == "int4":
                m = len(requests) * max(rows)
                for din, dout in work.int4_layer_shapes(self.cfg):
                    run.work.setdefault("int4_prefill", []).append(
                        (L, *work.int4_matmul_work(m, din, dout)))
            return out

        def wrapped_step():
            t = time.perf_counter()
            live = in_window(t)
            if (run.trace and live and not run.slice.running and not self.slice_done
                    and t >= self.t0 + (run.seconds - run.slice_s) / 2):
                run.slice.start()
                self.slice_t0 = t
            pos, chunk = eng.pos, eng.chunk
            base = eng.mask[:, :pos].sum(axis=1)
            if run.slice.running:
                for i in range(chunk):
                    valid = int(base.sum()) + (i + 1) * eng.b
                    run.work.setdefault("decode_attn", []).append(
                        (L, *work.decode_attention_work(self.cfg, valid, eng.b, kv_bytes)))
            if live:
                flops = 0.0
                per = 2.0 * (work.decoder_params(self.cfg) + work.head_params(self.cfg))
                for r, slot in enumerate(eng.slots):
                    if not slot.busy or slot.done:
                        continue
                    n = max(0, min(chunk, slot.max_new - len(slot.tokens)))
                    ctx = n * int(base[r]) + n * (n + 1) // 2
                    flops += n * per + work.attention_flops(self.cfg, 1, ctx)
                run.counters["flops"] = run.counters.get("flops", 0.0) + flops
            d0 = eng.decode_steps
            out = step()
            t1 = time.perf_counter()
            if live:
                run.spans.setdefault("step", []).append(t1 - t)
                run.counters["decode_steps"] = run.counters.get("decode_steps", 0) + (
                    eng.decode_steps - d0)
            if run.slice.running and (t1 >= self.slice_t0 + run.slice_s or t1 >= self.t_end):
                run.slice.stop()
                self.slice_done = True
            return out

        eng.join_many, eng.step = wrapped_join, wrapped_step

    def on_tokens_for(self, rec: dict):
        def cb(toks):
            t = time.perf_counter()
            with self.lock:
                if rec["t_first"] is None:
                    rec["t_first"] = t
                rec["n_tokens"] += len(toks)
                if self.t0 is not None and t <= self.t_end:
                    self.run.counters["tokens"] = self.run.counters.get("tokens", 0) + len(toks)
        return cb

    def submit(self, rec: dict) -> None:
        """One request through the scheduler's front door, blocking."""
        try:
            rec["output"] = self.sched.submit(
                rec["ids"], self.frames[rec["frame"]][None], seed=rec["seed"],
                max_new=rec["new_tokens"], temperature=0.0 if rec["greedy"] else None,
                frame_map=self.fmap, on_tokens=self.on_tokens_for(rec),
                timeout=float(self.mix.get("timeout_s", 120)))
        except Exception as e:  # noqa: BLE001 - a failed request counts as failed
            rec["error"] = repr(e)
        rec["t_done"] = time.perf_counter()

    def new_record(self, req, ids, frame: int) -> dict:
        return {"index": req.index, "ids": ids, "frame": frame, "seed": req.seed,
                "new_tokens": req.new_tokens, "greedy": req.greedy, "t_first": None,
                "t_done": None, "n_tokens": 0, "output": None, "error": None}

    def warm(self, recs: List[dict]) -> None:
        """Run warm-up requests through the scheduler, all at once."""
        threads = [threading.Thread(target=self.submit, args=(r,)) for r in recs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        bad = [r["error"] for r in recs if r["error"]]
        if bad:
            raise RuntimeError(f"warm-up failed: {bad[:2]}")

    def hand_share(self) -> float:
        outs = [r["output"] for r in self.records if r["output"] is not None]
        n = sum(int(o.num_tokens[0]) for o in outs)
        hands = sum(int((o.sequences[0, : int(o.num_tokens[0])] == self.cfg.hand_token_id).sum())
                    for o in outs)
        return hands / max(n, 1)

    def release(self) -> None:
        self.sched.stop()
        self.sched = self.eng = self.ie = self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the output check ------------------------------------------------------

    def sample(self) -> List[dict]:
        """Finished requests due in the window, drawn from the seed: of the
        greedy ones `check.requests` and of the sampled ones
        `check.sampled`, each kind's longest first."""
        rng = np.random.default_rng(derive(self.run.seed, "sample"))
        picked = []
        for greedy, key in ((True, "requests"), (False, "sampled")):
            done = [r for r in self.records if r["greedy"] == greedy
                    and r["output"] is not None and r["in_window"]]
            k = int(self.mix["check"].get(key, 0))
            if not done or not k:
                continue
            done.sort(key=lambda r: (-int(r["output"].num_tokens[0]), r["index"]))
            rest = [done[i] for i in rng.permutation(len(done) - 1) + 1][: k - 1]
            picked += [done[0]] + rest
        return picked

    def replay(self, reqs: List[dict], mode: str, conf: dict) -> List[dict]:
        """Each sampled request replayed through the reference in `mode`:
        its logits at every served token, its waypoints and its token
        draws."""
        run = self.run
        dims = dims_of(conf)
        w = make_weights(self.spec, run.seed, run.device, steer=bool(self.mix.get("steer", True)))
        frames = self.frame_pool(run.device)
        ref = Reference(w, dims, mode=mode, kv_int8=self.spec.kv_quant == "int8")
        out = []
        with torch.no_grad():
            for r in reqs:
                o = r["output"]
                toks = [int(x) for x in o.sequences[0, : int(o.num_tokens[0])]]
                vis = ref.visual_tokens(frames[r["frame"]], self.fmap)
                us, zs = draws(r["seed"], len(toks), dims["latent"], dims["z_scale"])
                logits, wps = ref.serve(r["ids"][0], vis, toks, zs.to(run.device),
                                        dims["hand_id"])
                out.append({"logits": logits, "wps": wps, "toks": toks, "us": us})
        del ref, w, frames
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def compare(self, reqs, ref, other=None) -> Dict[str, float]:
        """Of a greedy request, the widest gap by which a served token's
        reference logit lies below the reference's best; of a sampled one,
        the widest distance by which the step's uniform lies outside the
        CDF interval of the served token in the reference's top-p nucleus
        (`draw_gap`); of both, the widest waypoint gap of its <hand_traj>
        tokens. With `other` (the control's replay) the same read for the
        tokens the control puts first or draws, and its waypoints."""
        hand = self.cfg.hand_token_id
        temp, top_p = float(self.mix["temperature"]), float(self.mix["top_p"])
        gap = wgap = dgap = 0.0
        for r, a in zip(reqs, ref):
            lg = a["logits"]
            toks = torch.as_tensor(a["toks"], device=lg.device)
            o = other[reqs.index(r)] if other is not None else None
            if r["greedy"]:
                pick = toks if o is None else o["logits"].argmax(-1)
                best = lg.max(-1).values
                gap = max(gap, float((best - lg.gather(1, pick[:, None])[:, 0]).max()))
            else:
                cdf = nucleus_cdf(lg, temp, top_p)
                pick = toks if o is None else draw_tokens(
                    nucleus_cdf(o["logits"], temp, top_p), a["us"])
                dgap = max(dgap, float(draw_gaps(cdf, pick, a["us"]).max()))
            hands = [j for j, t in enumerate(a["toks"]) if t == hand][:10]
            if hands:
                if o is None:
                    out = r["output"]
                    mine = np.transpose(out.pred_hands[0, :, : len(hands)], (1, 0, 2))
                else:
                    mine = o["wps"][hands].cpu().numpy()
                theirs = a["wps"][hands].cpu().numpy()
                wgap = max(wgap, float(np.abs(mine - theirs).max()))
        nums = {"logit_gap": gap, "waypoint_gap": wgap}
        if any(not r["greedy"] for r in reqs):
            nums["draw_gap"] = dgap
        return nums
