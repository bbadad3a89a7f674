"""QLoRA fine-tuning on one card through the program's train step:
`make_train_step(cfg, opt, attn_impl="auto", remat=...)` on
`create_train_state`, the top-level modules the mix's `freeze` names
frozen (CLIP and the int4 decoder, as the train CLI's LoRA recipe freezes
them: the adapters, the projector and the CVAE head train), LoRA r on all
seven projections of every layer, AdamW clipped by the global norm.

Set-up builds the one state object, drives it through the first
`checked_steps` steps on the window's own call and feed (rows that all
differ), reads what the check compares (each checked step's loss, each
trained leaf's first gradient from AdamW's first moment after step 1, each
leaf's change after the last checked step), runs `warm_steps` more, and
hands the same object to the window. The mix checks the first step alone:
in bf16 the adapters' first updates (2e-5 a weight) are partly rounded away
where their small deltas meet the bf16 activations, so from the second
step on the program's losses and changes drift from the fp32 reference's
by rounding, not by a fault (PERF.md: the program in f32 follows the
reference through three steps, with its kernels or without).

End to end: `train_tok_s`, the spliced rows of every step completed in
the window over the time from the window's start to the last such step's
end."""

from __future__ import annotations

import gc
import time

import torch

from hov_bench.core import work
from hov_bench.core.batches import batch as make_batch
from hov_bench.core.batches import lora_start
from hov_bench.core.weights import load_program_model, make_weights
from hov_bench.reference.model import Reference, dims_of
from hov_bench.reference.train import qlora_steps


class Driver:
    def __init__(self, run):
        self.run = run
        self.spec, self.mix, self.cfg = run.spec, run.mix, run.spec.cfg
        self.conf = run.spec.raw

    def weights(self):
        """The seeded weights, steered only where the mix says so (a
        training cell draws nothing, so by default it is not)."""
        return make_weights(self.spec, self.run.seed, self.run.device,
                            steer=bool(self.mix.get("steer", False)))

    def batch(self, step: int):
        return make_batch(self.conf, self.mix, self.run.seed, step, self.run.device,
                          self.cfg.pdtype)

    def setup(self):
        from handsonvlm_torch.models.lora import init_lora
        from handsonvlm_torch.train.step import make_train_step
        from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

        run, mix, cfg = self.run, self.mix, self.cfg
        dev = run.device
        model = load_program_model(self.spec, self.weights())
        r = int(mix["lora_r"])
        lora = init_lora(torch.Generator(device=dev), cfg.llama, r, float(mix["lora_alpha"]),
                         device=dev)
        with torch.no_grad():
            for t, (a, b) in lora_start(self.conf, r, run.seed, dev).items():
                lora.adapters[t].a.copy_(a)
                lora.adapters[t].b.copy_(b)
        model.lora = lora
        freeze = tuple(mix["freeze"])
        self.opt = make_optimizer(model, float(mix["lr"]), freeze_top_keys=freeze,
                                  max_grad_norm=float(mix["max_grad_norm"]))
        self.step_fn = make_train_step(cfg, self.opt, attn_impl="auto", remat=mix["remat"])
        self.state = create_train_state(model, self.opt)
        self.leaves = {f"{t}.{ab}": getattr(ad, ab) for t, ad in lora.adapters.items()
                       for ab in "ab"}
        # the other trained weights (the projector and the CVAE head), by
        # their state-dict names
        dense = {f"{name}.{n}": p for name, child in model.named_children()
                 if name not in freeze and name != "lora" for n, p in child.named_parameters()}
        first = {n: p.detach().clone() for n, p in dense.items()}
        self.leaves.update(dense)
        self.losses, self.first_grad = [], {}
        b1 = self.opt.param_groups[0]["b1"]
        for k in range(int(mix["checked_steps"])):
            self.losses.append(self.one_step(k)["loss"])
            if k == 0:
                self.first_grad = {n: float(self.opt.state[p]["mu"].float().norm()) / (1 - b1)
                                   for n, p in self.leaves.items()}
        with torch.no_grad():
            start = lora_start(self.conf, r, run.seed, dev)
            self.change = {f"{t}.{ab}": float((self.leaves[f"{t}.{ab}"] - p).norm())
                           for t, pair in start.items() for ab, p in zip("ab", pair)}
            self.change.update({n: float((p.float() - first[n].float()).norm())
                                for n, p in dense.items()})
        self.next = int(mix["checked_steps"])
        for _ in range(int(mix.get("warm_steps", 0))):
            self.one_step(self.next)
            self.next += 1

    def one_step(self, k: int) -> dict:
        b, eps = self.batch(k)
        return self.step_fn(self.state, b, k, eps=eps)

    def window(self):
        run, mix, cfg = self.run, self.mix, self.cfg
        rows = int(mix["batch"]) * int(mix["rows"])
        per_step = work.qlora_step_flops(cfg, int(mix["batch"]), int(mix["rows"]),
                                         int(mix["lora_r"]), int(mix["frames"]["unique"]))
        L = cfg.llama.num_layers
        t0 = time.perf_counter()
        t_end = t0 + run.seconds
        done, last = 0, t0
        traced = 0
        mid = t0 + run.seconds / 2 - run.slice_s / 2
        while time.perf_counter() < t_end:
            tracing = run.trace and traced < int(mix["trace_steps"]) and (
                time.perf_counter() >= mid or run.slice.running)
            if tracing and not run.slice.running:
                run.slice.start()
            run.attempted += 1
            t = time.perf_counter()
            try:
                self.one_step(self.next)
            except Exception as e:  # noqa: BLE001 - a failed step counts as failed
                run.failed += 1
                run.info["error"] = repr(e)
                break
            end = time.perf_counter()
            run.spans.setdefault("step", []).append(end - t)
            self.next += 1
            if tracing:
                traced += 1
                for din, dout in work.int4_layer_shapes(cfg):
                    f, nb = work.int4_matmul_work(rows, din, dout)
                    run.work.setdefault("int4_prefill", []).append((2 * L, f, nb))
                    # every layer's dx: layer 0's reaches the trained projector
                    run.work.setdefault("int4_matmul_t", []).append((L, f, nb))
                run.counters["slice_steps"] = traced
                if traced == int(mix["trace_steps"]):
                    run.slice.stop()
            if end <= t_end:
                done, last = done + 1, end
        if run.slice.running:
            run.slice.stop()
        run.window_closed = time.perf_counter()
        if done:
            run.e2e["train_tok_s"] = done * rows / (last - t0)
            run.counters["flops"] = done * per_step
            run.counters["flops_seconds"] = last - t0

    def check(self, conf: dict, control: bool = False):
        run, mix = self.run, self.mix
        dev = run.device
        steps = int(mix["checked_steps"])
        prog = {"loss": self.losses, "first_grad": self.first_grad, "change": self.change}
        self.state = self.opt = self.step_fn = self.leaves = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        hv = conf["handsonvlm"]
        weights = {k: float(hv["loss"][k]) for k in ("lambda_traj", "lambda_traj_kl",
                                                     "hoi_lambda")}
        r = int(mix["lora_r"])
        out = {}
        modes = ["f32"] + (["fp8"] if control else [])
        for mode in modes:
            w = self.weights()
            trained = [k for k in w if k.split(".")[0] not in mix["freeze"]]
            ref = Reference(w, dims_of(conf), mode=mode, resident=False)
            ref_out = qlora_steps(ref, lora_start(conf, r, run.seed, dev),
                                  float(mix["lora_alpha"]) / r,
                                  [self.batch(k) for k in range(steps)], mix, weights, trained)
            del ref, w
            gc.collect()
            nums = compare(prog, ref_out)
            if mode == "f32":
                out.update(nums)
                base = ref_out
            else:
                out.update({f"control.{k}": v
                            for k, v in compare(_as_program(ref_out), base).items()})
        return out


def _as_program(ref_out: dict) -> dict:
    """A reference run's readings in the program's form (the control in
    the program's place)."""
    return {"loss": ref_out["loss"], "first_grad": ref_out["grad"][0],
            "change": ref_out["change"]}


def compare(prog: dict, ref: dict) -> dict:
    """The checked steps' losses by their widest relative gap; the first
    gradient and the change by the worst leaf: the gap between the two
    norms over the reference's norm of that leaf or of the median leaf,
    whichever is larger. A leaf whose reference gradient stays under a
    thousandth of the median leaf's at every step moves by round-off alone
    and is left out."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))

    def counted(grads: dict):
        med = sorted(grads.values())[len(grads) // 2]
        return {k for k, v in grads.items() if v >= 1e-3 * med and v > 0}

    keep1 = counted(ref["grad"][0])
    keep = set().union(*(counted(g) for g in ref["grad"]))

    def worst(a: dict, b: dict, names) -> float:
        names = sorted(names)
        if not names:
            return 0.0
        med = sorted(b[k] for k in names)[len(names) // 2]
        return max(abs(a[k] - b[k]) / max(b[k], med) for k in names)

    return {"loss_gap": loss_gap,
            "grad_gap": worst(prog["first_grad"], ref["grad"][0], keep1),
            "change_gap": worst(prog["change"], ref["change"], keep)}
