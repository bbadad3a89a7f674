"""Standalone hoi-forecast trainer.

Port of `handsonvlm_tpu/train/hoi_trainer.py` (the reference's
hoi_forecast/model/{trainer,optimizer,epoch_utils}.py): train steps over
the ObjectTransformer, the warmup-wrapped LR schedule, the weight-decay
exemption of the VAE heads, and the stochastic multi-sample evaluation
scored by the swap-preserving ADE / FDE / WDE.

`HoiOptimizer` follows the optax transforms the JAX package chains, not
torch.optim's, leaf for leaf:

- `adam`: add_decayed_weights(wd) then adam: the decay is an L2 term added
  to the gradient before the moments (as torch.optim.Adam's weight_decay);
- `adamw`: optax.adamw: the decay added to the Adam direction;
- `sgd`: add_decayed_weights(wd) then sgd with momentum 0.9 (optax's trace:
  t = g + 0.9 t);
- `rms`: add_decayed_weights(wd) then optax.rmsprop(decay=0.99), whose eps
  sits inside the square root: g / sqrt(nu + eps), where
  torch.optim.RMSprop divides by sqrt(nu) + eps.

The schedule reads optax's count, which starts at 0, so with
init_lr_ratio = 0 the first update runs at lr 0. Leaves under `hand_head`
and `object_head` (the JAX tree's `hand_head` and `obj_head`) and any
`cvae` take no weight decay (`_vae_mask`, optimizer.py:41-58). A
parameter without a gradient is updated as optax updates a zero gradient.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from handsonvlm_torch.eval.traj_metrics import evaluate_traj_stochastic
from handsonvlm_torch.models.object_transformer import (
    ObjectTransformer,
    ObjectTransformerConfig,
    hoi_forecast_loss,
    hoi_forecast_sample,
)
from handsonvlm_torch.train.step import step_generator
from handsonvlm_torch.train.train_state import CountedOptimizer, TrainState

Schedule = Callable[[int], float]
KINDS = ("adam", "adamw", "sgd", "rms")
# the JAX package's regex, with its `obj_head` the port's `object_head`
VAE_PATTERN = re.compile(r"(hand_head|object_head|cvae)")


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule in f32."""
    decay = np.float32(decay_steps)

    def sched(step: int) -> float:
        count = min(np.float32(step), decay)
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * count / decay))
        return float(np.float32(init_value) * ((np.float32(1) - np.float32(alpha)) * cosine
                                               + np.float32(alpha)))

    return sched


def warmup_schedule(base_lr: float, warmup_iters: int, after: Schedule,
                    init_lr_ratio: float = 0.0) -> Schedule:
    """hoi_forecast's Warmup wrapper (optimizer.py:4-34): a linear ramp from
    init_lr_ratio * lr over warmup_iters steps, then `after` from 0."""
    warmup_iters = max(warmup_iters, 1)

    def sched(step: int) -> float:
        if step < warmup_iters:
            ramp = np.float32(init_lr_ratio) + np.float32(1 - init_lr_ratio) * (
                np.float32(step) / np.float32(warmup_iters))
            return float(np.float32(base_lr) * ramp)
        return after(step - warmup_iters)

    return sched


def vae_exempt(name: str) -> bool:
    """True for a parameter that takes no weight decay."""
    return bool(VAE_PATTERN.search(name))


def _c(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class HoiOptimizer(CountedOptimizer):
    """The JAX package's `make_hoi_optimizer` chain over param groups that
    carry their own weight decay (see the module docstring)."""

    def __init__(self, groups, kind: str = "adam",
                 learning_rate: Union[float, Schedule] = 1e-4, momentum: float = 0.9,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, rms_decay: float = 0.99):
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r} (use {KINDS})")
        super().__init__(groups, dict(weight_decay=0.0))
        self.kind = kind
        self.learning_rate = learning_rate
        self.momentum, self.b1, self.b2, self.eps, self.rms_decay = momentum, b1, b2, eps, rms_decay
        self.count = 0  # optax's count, shared by the schedule and adam

    def lr(self) -> float:
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def _direction(self, p, g, st, wd, count):
        kind = self.kind
        if kind != "adamw" and wd:
            g = g + _c(wd, p) * p
        if kind in ("adam", "adamw"):
            if not st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            st["mu"] = _c(1 - self.b1, g) * g + _c(self.b1, g) * st["mu"]
            st["nu"] = _c(1 - self.b2, g) * (g * g) + _c(self.b2, g) * st["nu"]
            bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(count)
            bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(count)
            u = (st["mu"] / _c(bc1, g)) / (torch.sqrt(st["nu"] / _c(bc2, g)) + _c(self.eps, g))
            return u + _c(wd, p) * p if kind == "adamw" and wd else u
        if kind == "sgd":
            trace = st.get("trace", torch.zeros_like(p))
            st["trace"] = g + _c(self.momentum, g) * trace
            return st["trace"]
        if not st:
            st["nu"] = torch.zeros_like(p)
        st["nu"] = _c(1 - self.rms_decay, g) * (g * g) + _c(self.rms_decay, g) * st["nu"]
        return torch.rsqrt(st["nu"] + _c(self.eps, g)) * g  # eps inside the sqrt

    @torch.no_grad()
    def step(self, closure=None) -> None:
        count = self.count + 1
        step_size = -np.float32(self.lr())
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                u = self._direction(p, g, self.state[p], group["weight_decay"], count)
                p.add_(u * _c(step_size, u))
        self.count = count


def make_hoi_optimizer(model: nn.Module, kind: str = "adam", lr: float = 1e-4,
                       weight_decay: float = 0.0, momentum: float = 0.9,
                       schedule: Optional[Schedule] = None) -> HoiOptimizer:
    """Two param groups: the VAE heads without weight decay, the rest with
    `weight_decay`; the learning rate is `schedule` when given, else `lr`."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [{"name": "vae", "weight_decay": 0.0,
               "params": [p for n, p in named if vae_exempt(n)]},
              {"name": "decayed", "weight_decay": float(weight_decay),
               "params": [p for n, p in named if not vae_exempt(n)]}]
    return HoiOptimizer([g for g in groups if g["params"]], kind,
                        schedule if schedule is not None else lr, momentum)


def _on(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_hoi_train_step(cfg: ObjectTransformerConfig, optimizer: HoiOptimizer,
                        lambdas: Dict[str, float]):
    """Returns step(state, batch, rng, *, eps=None) -> the losses as floats:
    one optimizer step on `state` (in place; `state.step` advances). The
    draws come from a generator seeded from (rng, state.step), JAX's
    fold_in(rng, state.step); `eps` (as `object_transformer.
    teacher_forced_losses` takes it) replaces them."""

    def step(state: TrainState, batch: Dict, rng: int, *,
             eps: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
        model = state.model
        device = _device(model)
        generator = None if eps is not None else step_generator(rng, state.step, device)
        optimizer.zero_grad(set_to_none=True)
        loss, losses = hoi_forecast_loss(model, cfg, _on(batch, device), eps=eps,
                                         generator=generator, **lambdas)
        loss.backward()
        optimizer.step()
        state.step += 1
        return {k: float(v.detach()) for k, v in losses.items()}

    return step


def epoch_pass(loader: Iterable, state: TrainState, step_fn, rng: int
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One training epoch (trainer.py:11-92): the mean of each loss over
    the epoch's steps."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in loader:
        for k, v in step_fn(state, batch, rng).items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    return state, {k: v / max(n, 1) for k, v in sums.items()}


@torch.no_grad()
def epoch_evaluate(loader: Iterable, model: ObjectTransformer, cfg: ObjectTransformerConfig,
                   rng: int, num_samples: int = 5, pred_len: int = 4) -> Dict[str, float]:
    """Stochastic evaluation (trainer.py:95-170): `num_samples` rollouts a
    clip from a generator seeded from `rng`, scored by ADE / FDE / WDE."""
    device = _device(model)
    generator = step_generator(rng, 0, device)
    preds, gts, valids = [], [], []
    for batch in loader:
        hands, _ = hoi_forecast_sample(model, cfg, _on(batch, device), num_samples, pred_len,
                                       generator=generator)
        preds.append(hands.float().cpu().numpy())
        gts.append(np.asarray(batch["future_hands"])[:, :, 1:, :])
        valids.append(np.asarray(batch["future_valid"]))
    ade, fde, wde = evaluate_traj_stochastic(np.concatenate(preds), np.concatenate(gts),
                                             np.concatenate(valids))
    return {"ade": ade, "fde": fde, "wde": wde}
