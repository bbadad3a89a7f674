"""Train state, optimizer and LR schedule.

Port of `handsonvlm_tpu/train/train_state.py`. The recipe is the
reference's (scripts/finetune.sh): AdamW, lr 2e-5, weight decay 0, a cosine
schedule with 3% warmup, gradients clipped to a global norm of 1, the CLIP
tower frozen.

Freezing: the JAX package masks whole top-level trees out of its optax
chain (`multi_transform` with `set_to_zero`). Here a frozen top-level module
gets `requires_grad_(False)`, so no gradient is ever computed for it, and
the optimizer holds one param group per trainable module. `vision` is
frozen by default; LoRA freezes `vision` and `llama` (the adapters, the
projector and the trajectory head train); the projector-only recipe
freezes everything but `projector`. LoRA's alpha / r is a buffer and never
trains, as the JAX package's mask freezes it.

`AdamW` is optax's chain `clip_by_global_norm(max_grad_norm)` then
`adamw(...)`, step for step: the clip scales every gradient by
max_norm / norm when the norm (over the trainable leaves) is not below
max_norm, with no epsilon (unlike `torch.nn.utils.clip_grad_norm_`); the
moments are optax's (the first in `mu_dtype` when given, bf16 for
`--mu-bf16`, updated in f32), bias-corrected with (1 - b^count) in f32;
the weight decay is added to the Adam direction before the learning rate
scales it; and the schedule reads optax's count, which starts at 0, so the
first step of a warmup has lr 0. `torch.optim.AdamW` has no `mu_dtype` and
decays the weights apart from the update, hence this short optimizer.

Under FSDP2 (`parallel/partition.shard_model`) a parameter, its gradient
and its moments are DTensor shards: the update runs on each rank's local
shard (it is elementwise), the clip's norm sums the shards' squares over
the ranks, and `state_dict` / `load_state_dict` hold the whole moments, as
a one-rank run saves them (every rank calls them; the first rank keeps
them). Under tensor parallelism (`parallel/tp.shard_for_training`) a
parameter cut over the model axis is this rank's slice, and so are its
moments: the clip's norm sums the slices' squares over the model group
(the parameters the group holds whole are counted once), and the moments
are gathered to, and cut from, the whole ones as the parameter is
(`make_optimizer` records the cuts, `AdamW.tp_cuts`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from handsonvlm_torch.parallel.tp import gather_dim, slice_dim


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_ratio: float = 0.03) -> Callable[[int], float]:
    """HF's 'cosine' schedule with linear warmup, as optax's
    `join_schedules([linear 0 -> lr over w steps, cosine decay to 0 over
    the rest])` with w = max(int(total * warmup_ratio), 1), in f32."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps - warmup, 1)
    lr = np.float32(base_lr)

    def schedule(step: int) -> float:
        if step < warmup:
            return float(lr * np.float32(min(max(step, 0), warmup) / warmup))
        t = np.float32(min(step - warmup, decay)) / np.float32(decay)
        return float(lr * np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * t)))

    return schedule


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), a tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _square_sum(grads, groups=None) -> torch.Tensor:
    """The sum of the gradients' squares in f32; the shards of DTensor
    gradients summed over the ranks that hold them, and a gradient whose
    entry of `groups` is a TPGroup (a model slice) summed over that group
    as well."""
    groups = groups or [None] * len(grads)
    total = _fsdp_square_sum([g for g, tp in zip(grads, groups) if tp is None])
    for tp in dict.fromkeys(tp for tp in groups if tp is not None):  # in order on every rank
        part = _fsdp_square_sum([g for g, t in zip(grads, groups) if t == tp])
        part = torch.as_tensor(part, dtype=torch.float32, device=grads[0].device)
        dist.all_reduce(part, group=tp.group)
        total = total + part
    return total


def _fsdp_square_sum(grads):
    plain = [g for g in grads if not isinstance(g, DTensor)]
    total = sum(g.float().square().sum() for g in plain)
    sharded = [g for g in grads if isinstance(g, DTensor)]
    if sharded:
        mesh, placements = sharded[0].device_mesh, sharded[0].placements
        local = sum(g.to_local().float().square().sum() for g in sharded)
        for dim, pl in enumerate(placements):
            if isinstance(pl, Shard):
                dist.all_reduce(local, group=mesh.get_group(dim))
        total = total + local
    return total


def _c(value, like: torch.Tensor) -> torch.Tensor:
    """A constant in `like`'s dtype, as JAX casts a Python scalar to the
    array it meets (a bf16 moment times b1 rounds b1 to bf16 first)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class CountedOptimizer(torch.optim.Optimizer):
    """An optimizer whose state is optax's: a step count (`self.count`, which
    the schedule reads) and each parameter's moments."""

    tp_cuts: dict = {}  # parameter index -> (dimension, TPGroup) of a model slice

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        """The count and each parameter's moments (by its index over the
        param groups), in their own dtypes, whole. A DTensor moment or the
        moment of a model slice (`tp_cuts`) is gathered one at a time and
        kept, on the CPU, by the first rank alone (every rank calls this;
        the others get no such moment), so that no card holds more than
        one whole moment at once."""
        main = not dist.is_initialized() or dist.get_rank() == 0
        state = {}
        for i, p in enumerate(self._params()):
            if not self.state[p]:
                continue
            state[i] = {}
            for k, v in self.state[p].items():
                if isinstance(v, DTensor) or i in self.tp_cuts:
                    v = v.full_tensor() if isinstance(v, DTensor) else v
                    if i in self.tp_cuts:
                        v = gather_dim(v, self.tp_cuts[i][1], self.tp_cuts[i][0])
                    if not main:
                        continue
                    v = v.cpu()
                state[i][k] = v
        return {"count": self.count, "state": state}

    def load_state_dict(self, state_dict: dict) -> None:
        """The inverse of `state_dict` into an optimizer over the same
        parameters: the moments copied to each parameter's device, their
        dtypes kept (torch's own loader would cast a bf16 first moment to
        the parameter's dtype)."""
        params = self._params()
        for i, st in state_dict["state"].items():
            p = params[int(i)]
            if int(i) in self.tp_cuts:  # this rank's slice of each whole moment
                dim, tp = self.tp_cuts[int(i)]
                st = {k: slice_dim(v, tp, dim) for k, v in st.items()}
            if any(v.shape != p.shape for v in st.values()):
                raise ValueError(f"optimizer state {i}: shapes {[tuple(v.shape) for v in st.values()]} "
                                 f"do not fit the parameter {tuple(p.shape)}")
            if isinstance(p, DTensor):  # this rank's shard of each whole moment
                self.state[p] = {k: distribute_tensor(v.to(p.device), p.device_mesh,
                                                      p.placements) for k, v in st.items()}
            else:
                self.state[p] = {k: v.to(p.device, copy=True) for k, v in st.items()}
        self.count = int(state_dict["count"])


class AdamW(CountedOptimizer):
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(...)) over the
    param groups; `step()` returns the global norm of the gradients it
    clipped (the trainable leaves')."""

    def __init__(self, groups, learning_rate: Union[float, Callable[[int], float]] = 2e-5,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0, mu_dtype=None):
        super().__init__(groups, dict(weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = mu_dtype
        self.count = 0  # optax's adam and schedule count

    def lr(self) -> float:
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        pairs = [(p, g) for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not pairs:
            raise RuntimeError("no parameter has a gradient")
        index = {id(p): i for i, p in enumerate(self._params())}
        groups = [self.tp_cuts.get(index[id(p)], (None, None))[1] for p, _ in pairs]
        norm = torch.sqrt(_square_sum([p.grad for p, _ in pairs], groups))
        clip = self.max_grad_norm is not None and bool(norm >= self.max_grad_norm)
        count = self.count + 1
        step_size = -np.float32(self.lr())
        for p, group in pairs:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            g = _local(p.grad)
            if clip:
                g = (g / norm.to(g.dtype)) * _c(self.max_grad_norm, g)
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                st["nu"] = torch.zeros_like(p)
            w, mu0, nu0 = _local(p), _local(st["mu"]), _local(st["nu"])
            mu = _c(1 - b1, g) * g + _c(b1, mu0) * mu0
            nu = _c(1 - b2, g) * (g * g) + _c(b2, nu0) * nu0
            bc1 = np.float32(1) - np.float32(b1) ** np.float32(count)
            bc2 = np.float32(1) - np.float32(b2) ** np.float32(count)
            u = (mu / _c(bc1, mu)) / (torch.sqrt(nu / _c(bc2, nu)) + _c(eps, nu))
            if wd:
                u = u + _c(wd, w) * w
            w.copy_(w + u * _c(step_size, u))
            mu0.copy_(mu)
            nu0.copy_(nu)
        self.count = count
        return norm


def make_optimizer(
    model: nn.Module,
    learning_rate: Union[float, Callable[[int], float]] = 2e-5,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    freeze_top_keys: Sequence[str] = ("vision",),
    mu_dtype=None,
) -> AdamW:
    """Freeze the top-level modules named in `freeze_top_keys`
    (`requires_grad_(False)`), make the rest trainable, and return an
    `AdamW` with one param group per trainable module. `mu_dtype`
    (torch.bfloat16) stores the first moment in bf16. The model slices of
    a tensor-parallel model (`parallel.tp.model_cuts`) are recorded in
    `AdamW.tp_cuts` by their index."""
    from handsonvlm_torch.parallel.tp import model_cuts

    cuts = model_cuts(model)
    groups, tp_cuts = [], {}
    for name, child in model.named_children():
        if child is None:
            continue
        frozen = name in freeze_top_keys
        child.requires_grad_(not frozen)
        named = [(f"{name}.{n}", p) for n, p in child.named_parameters() if p.requires_grad]
        start = sum(len(g["params"]) for g in groups)
        tp_cuts.update({start + j: cuts[n] for j, (n, _) in enumerate(named) if n in cuts})
        if named:
            groups.append({"name": name, "params": [p for _, p in named]})
    opt = AdamW(groups, learning_rate, weight_decay, b1, b2, eps, max_grad_norm, mu_dtype)
    opt.tp_cuts = tp_cuts
    return opt


@dataclasses.dataclass
class TrainState:
    """The step count, the model (the parameters) and its optimizer (the
    optimizer state)."""

    step: int
    model: nn.Module
    optimizer: AdamW


def create_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
