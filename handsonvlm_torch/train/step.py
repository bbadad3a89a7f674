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
from handsonvlm_torch.models.handsonvlm import forward
from handsonvlm_torch.train.train_state import TrainState

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
            remat=True):
    """(loss, metrics) of the teacher-forced forward on `batch` (input_ids,
    attn_mask, image, labels, future_hands, future_valid; optionally
    frame_map, when `image` holds only the unique frames)."""
    out = forward(model, cfg, input_ids=batch["input_ids"], attn_mask=batch["attn_mask"],
                  images=batch["image"], labels=batch["labels"],
                  future_hands=batch["future_hands"], future_valid=batch["future_valid"],
                  eps=eps, generator=generator, attn_impl=attn_impl, remat=remat,
                  frame_map=batch.get("frame_map"))
    return out["loss"], {k: out[k] for k in METRICS}


def make_train_step(cfg: HandsOnVLMConfig, optimizer, attn_impl: str = "auto", remat=True):
    """Returns step(state, batch, rng, *, eps=None) -> metrics: one
    optimizer step on `state` (in place; `state.step` advances). `rng` is
    an int seed; `eps` (B*2*4, latent) replaces the CVAE draws."""

    def step(state: TrainState, batch: Dict, rng: int, *,
             eps: Optional[torch.Tensor] = None) -> Dict[str, float]:
        model = state.model
        device = model.llama.embed_tokens.weight.device
        batch = _on(batch, device)
        generator = None if eps is not None else step_generator(rng, state.step, device)
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, cfg, batch, eps=eps, generator=generator,
                                attn_impl=attn_impl, remat=remat)
        loss.backward()
        grad_norm = optimizer.step()
        state.step += 1
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
