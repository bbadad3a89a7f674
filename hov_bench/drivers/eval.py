"""The EK100 evaluation as the eval CLI's `--batched SLOTS` runs it: the
InferenceEngine's scheduler fed closed-loop by 2 x SLOTS client threads,
each request a clip's question (the EPIC prompt of `build_prompt_ids`)
with 10 seeded frames through the eval path's frame dedup, sampled at the
engine's temperature and top-p (a `greedy_share` of the clips greedy, so
the output check reads both kinds), and the finished clips scored by
`eval/traj_metrics`.

End to end: `gen_tok_s`, every token streamed inside the window over the
window's seconds."""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from hov_bench.core import prompts
from hov_bench.core.traffic import schedule
from hov_bench.drivers._served import Served


class Driver(Served):
    def setup(self):
        mix, run = self.mix, self.run
        self.build_model()
        self.sched = self.ie.scheduler(int(mix["slots"]), int(mix["max_len"]), int(mix["chunk"]))
        self.ie.max_new_tokens = int(mix["new_tokens"]["value"])
        self.wrap_engine()
        self.reqs = schedule(mix, run.seed)
        warm = []
        for j in range(int(mix["clients"])):
            r = self.reqs[-1 - j]
            rec = self.clip(r, len(self.reqs) + j)
            rec["new_tokens"] = int(mix["warm_tokens"])
            warm.append(rec)
        self.warm(warm)

    def clip(self, req, i: int) -> dict:
        rng = np.random.default_rng(req.seed)
        rec = self.new_record(req, prompts.first_turn(self.ie, rng),
                              i % int(self.mix["frames"]["pool"]))
        rec["gt"] = rng.uniform(size=(2, 5, 2)).astype(np.float32)
        return rec

    def window(self):
        run = self.run
        counter = itertools.count()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                i = next(counter)
                if i >= len(self.reqs):
                    return
                rec = self.clip(self.reqs[i], i)
                rec["in_window"] = True
                with self.lock:
                    self.records.append(rec)
                self.submit(rec)

        self.t0 = time.perf_counter()
        self.t_end = self.t0 + run.seconds
        threads = [threading.Thread(target=client) for _ in range(int(self.mix["clients"]))]
        for t in threads:
            t.start()
        time.sleep(max(0.0, self.t_end - time.perf_counter()))
        stop.set()
        run.window_closed = time.perf_counter()
        for t in threads:  # the requests in flight finish
            t.join(timeout=max(1.0, self.t_end + 60 - time.perf_counter()))
        run.attempted = len(self.records)
        run.failed = sum(1 for r in self.records if r["error"] or r["output"] is None)
        run.e2e["gen_tok_s"] = run.counters.get("tokens", 0) / run.seconds
        run.info["hand_share"] = self.hand_share()
        run.info["ade_fde_wde"] = self.score()
        run.info["compactions"] = self.eng.compactions
        # where the window's time went, for the spread between runs (PERF.md)
        run.info["decode_steps"] = run.counters.get("decode_steps", 0)
        run.info["joins"] = len(run.spans.get("join", []))
        run.info["step_s"] = sum(run.spans.get("step", []))
        run.info["join_s"] = sum(run.spans.get("join", []))
        run.info["truncated"] = sum(1 for r in self.records if r["output"] is not None
                                    and int(r["output"].num_tokens[0]) < r["new_tokens"])

    def score(self):
        """The finished clips scored as the eval CLI scores them."""
        from handsonvlm_torch.eval.traj_metrics import evaluate_traj_stochastic
        from handsonvlm_torch.infer.sampler import clip_pred_hands

        done = [r for r in self.records if r["output"] is not None]
        preds = [clip_pred_hands(r["output"].pred_hands, r["output"].num_hands) for r in done]
        ok = [(p[0][0], r) for p, r in zip(preds, done) if p[1][0]]
        if not ok:
            return None
        return list(evaluate_traj_stochastic(
            np.stack([p for p, _ in ok])[:, None], np.stack([r["gt"][:, 1:] for _, r in ok]),
            np.ones((len(ok), 2), np.float32)))

    def check(self, conf: dict, control: bool = False):
        reqs = self.sample()
        self.release()
        if not reqs:
            return {}
        ref = self.replay(reqs, "f32", conf)
        out = self.compare(reqs, ref)
        if control:
            c = self.compare(reqs, ref, self.replay(reqs, "fp8", conf))
            out.update({f"control.{k}": v for k, v in c.items()})
        return out
