"""The SFT train step: loss, gradients, clipped AdamW update, metrics.

Port of `handsonvlm_tpu/train/step.py` on one device: the JAX package jits
(state, batch, rng) -> (state, metrics) with the loss differentiated
through the decoder under remat; here `step(state, batch, rng)` runs the
teacher-forced forward (models/handsonvlm.forward, the decoder layers
checkpointed per `remat`), `backward()`, and the optimizer, updates the
state in place and returns the metrics as floats.

The step's randomness (the CVAE draws of the trajectory loss) comes from a
`torch.Generator` seeded from (rng, state.step), the counterpart of JAX's
`fold_in(rng, state.step)`; the two give different numbers, so a test
passes JAX's draws in as `eps`.

With a `mesh` (`parallel.mesh.create_mesh`, the model sharded by
`parallel.partition.shard_model`) the step is data parallel, and with a
'seq' axis also sequence parallel (`seq_mesh`, the JAX package's name):
every rank receives the same global batch, keeps its rows as the JAX
package's `P('data')` does, draws the global batch's CVAE noise and keeps
its rows' part, and returns its share of the loss (`forward`'s
`data_parallel`); the
shares' gradients are summed over the ranks (FSDP2 averages, so the share
is scaled by the rank count before the backward), the optimizer steps
each rank's shards, and the metrics are the global batch's, summed over
the ranks. A mesh with a 'model' axis above 1 (the model cut by
`parallel.tp.shard_for_training` before `shard_model`) also makes the step
tensor parallel: the ranks of a model group take the same rows and run
their slices of the decoder (`forward`'s `tp`), so the share is scaled by
the data axis's size alone, the counts and the metrics are summed over the
data axis, and `grad_norm` sums the slices' squares over the model group.

Spans (utils/profiling.py, kept while the tracer is on): `train.step`
(rid: `state.step`) over `train.to_device`, `train.forward`,
`train.backward`, `train.optimizer` and `train.readout` (the metrics and
`grad_norm` read back).

`grad_norm` is the global norm of the trainable parameters' gradients, the
norm the clip reads. Under LoRA it differs from the value the JAX package
logs: JAX differentiates every leaf and its logged `grad_norm` leaves out
only the integer (float0) leaves, so it also counts the frozen decoder's
float gradients, which its optimizer mask then zeroes; the port computes
no gradient for frozen weights. With full SFT (the CLIP tower's gradient
is zero behind its stop_gradient) the two agree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.models.handsonvlm import NUM_HAND_TOKENS
from handsonvlm_torch.train.train_state import TrainState
from handsonvlm_torch.utils import profiling

METRICS = ("loss", "text_loss", "traj_loss", "traj_kl_loss")


def step_generator(rng: int, step: int, device) -> torch.Generator:
    """The step's generator, seeded from (rng, step) as JAX folds the step
    into its key."""
    seed = (int(rng) * 1_000_003 + int(step)) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _on(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_fn(model, cfg: HandsOnVLMConfig, batch: Dict, *, eps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, attn_impl: str = "auto",
            remat=True, data_parallel: bool = False, seq=None, tp=None, data_group=None):
    """(loss, metrics) of the teacher-forced forward on `batch` (input_ids,
    attn_mask, image, labels, future_hands, future_valid; optionally
    frame_map, when `image` holds only the unique frames); with
    `data_parallel` (and `seq`, `tp`), this rank's share of them, the
    counts summed over `data_group`."""
    out = model(cfg, input_ids=batch["input_ids"], attn_mask=batch["attn_mask"],
                images=batch["image"], labels=batch["labels"],
                future_hands=batch["future_hands"], future_valid=batch["future_valid"],
                eps=eps, generator=generator, attn_impl=attn_impl, remat=remat,
                frame_map=batch.get("frame_map"), data_parallel=data_parallel, seq=seq,
                tp=tp, data_group=data_group)
    return out["loss"], {k: out[k] for k in METRICS}


def draw_eps(model, cfg: HandsOnVLMConfig, batch_size: int, generator) -> torch.Tensor:
    """The CVAE noise of a batch of `batch_size` rows, the draw
    `models.traj_cvae.cvae_forward` makes for it: (B*2*4, latent) rows in
    batch order, in the CVAE head's dtype."""
    w = model.traj.linear_means.weight
    return torch.randn((batch_size * 2 * NUM_HAND_TOKENS, cfg.traj.latent_dim),
                       generator=generator, device=generator.device, dtype=w.dtype)


def _local_rows(batch: Dict, eps: torch.Tensor, mesh):
    """This data rank's rows of the global batch and of its CVAE noise, as
    `P('data')` cuts a batch (contiguous blocks, rank-major)."""
    from handsonvlm_torch.parallel.mesh import axis_rank, mesh_shape

    n = mesh_shape(mesh).get("data", 1)
    b = batch["input_ids"].shape[0]
    if b % n:
        raise ValueError(f"global batch {b} is not divisible by the {n} ranks of the "
                         "'data' axis")
    r, bl = axis_rank(mesh, "data"), b // n
    rows = {k: v if k == "frame_map" and v.dim() == 1 else v[r * bl:(r + 1) * bl]
            for k, v in batch.items()}
    per = eps.shape[0] // b
    return rows, eps[r * bl * per:(r + 1) * bl * per]


def make_train_step(cfg: HandsOnVLMConfig, optimizer, attn_impl: str = "auto", remat=True,
                    seq_mesh=None, mesh=None):
    """Returns step(state, batch, rng, *, eps=None) -> metrics: one
    optimizer step on `state` (in place; `state.step` advances). `rng` is
    an int seed; `eps` (B*2*4, latent) replaces the CVAE draws of the
    (global) batch. `mesh` makes the step data parallel over its 'data'
    axis, and tensor parallel over its 'model' axis; `seq_mesh` (a mesh
    with a 'seq' axis, which then is the mesh) runs the decoder's
    attention as ring attention over 'seq'."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel.mesh import data_group, model_group
    from handsonvlm_torch.parallel.partition import is_sharded, sync_replicated_grads
    from handsonvlm_torch.parallel.tp import tp_size

    mesh = seq_mesh if seq_mesh is not None else mesh
    tp, group = model_group(mesh), data_group(mesh)

    def step(state: TrainState, batch: Dict, rng: int, *,
             eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        with profiling.span("train.step", state.step):
            return _step(state, batch, rng, eps)

    def _step(state: TrainState, batch: Dict, rng: int, eps) -> Dict[str, float]:
        model = state.model
        device = model.llama.embed_tokens.weight.device
        with profiling.span("train.to_device"):
            batch = _on(batch, device)
        generator = None if eps is not None else step_generator(rng, state.step, device)
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            with profiling.span("train.forward"):
                loss, metrics = loss_fn(model, cfg, batch, eps=eps, generator=generator,
                                        attn_impl=attn_impl, remat=remat)
            with profiling.span("train.backward"):
                loss.backward()
        else:
            world = dist.get_world_size()
            if world > 1 and not is_sharded(model):
                raise ValueError("a data / sequence parallel step needs the model sharded "
                                 "by parallel.partition.shard_model")
            with profiling.span("train.forward"):
                if eps is None:
                    eps = draw_eps(model, cfg, batch["input_ids"].shape[0], generator)
                rows, eps = _local_rows(batch, torch.as_tensor(eps, device=device), mesh)
                loss, metrics = loss_fn(model, cfg, rows, eps=eps, attn_impl=attn_impl,
                                        remat=remat, data_parallel=True, seq=seq_mesh, tp=tp,
                                        data_group=group)
            with profiling.span("train.backward"):
                (loss * (world // tp_size(tp))).backward()
                sync_replicated_grads(model)
                total = torch.stack([metrics[k].detach().float() for k in METRICS])
                dist.all_reduce(total, group=group)
                metrics = dict(zip(METRICS, total))
        with profiling.span("train.optimizer"):
            grad_norm = optimizer.step()
        state.step += 1
        with profiling.span("train.readout"):
            out = {k: float(v.detach()) for k, v in metrics.items()}
            out["grad_norm"] = float(grad_norm)
        return out

    return step


def make_eval_step(cfg: HandsOnVLMConfig, attn_impl: str = "auto"):
    """Returns eval_step(model, batch, rng, *, eps=None) -> metrics: the
    teacher-forced losses without gradients or an update."""

    @torch.no_grad()
    def eval_step(model, batch: Dict, rng: int, *,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        device = model.llama.embed_tokens.weight.device
        generator = None if eps is not None else step_generator(rng, 0, device)
        _, metrics = loss_fn(model, cfg, _on(batch, device), eps=eps, generator=generator,
                             attn_impl=attn_impl, remat=False)
        return {k: float(v) for k, v in metrics.items()}

    return eval_step
