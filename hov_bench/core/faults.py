"""Faults planted in the program underneath a run, for the readings that
show the output check catches them (`calibrate.py --fault NAME` on the
card, `tests/test_hov_bench_faults.py` on the CPU). Each takes `patch(obj,
name, value)`, a setattr that the caller may undo."""

from __future__ import annotations

import torch


def altered_tokens(patch) -> None:
    """Every token replaced where it is drawn, by the one its logits rank
    last."""
    import handsonvlm_torch.serve.continuous as cont

    patch(cont, "sample_rows", lambda logits, *a, **k: logits.argmin(-1))


def shifted_draws(patch) -> None:
    """Every sampled row drawn with its uniform moved by a half: greedy
    rows keep their tokens, so only the sampled requests show it."""
    import handsonvlm_torch.serve.continuous as cont

    real = cont.sample_rows
    patch(cont, "sample_rows",
          lambda logits, temps, top_ps, u: real(logits, temps, top_ps, (u + 0.5) % 1.0))


def altered_answers(patch) -> None:
    """Every waypoint moved by 0.25 where it is decoded."""
    import handsonvlm_torch.serve.continuous as cont

    real = cont.decode_hand_waypoint
    patch(cont, "decode_hand_waypoint", lambda *a, **k: real(*a, **k) + 0.25)


def unchanged_state(patch) -> None:
    """The optimizer computes its step and puts the parameters back."""
    from handsonvlm_torch.train import train_state

    real = train_state.AdamW.step

    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        keep = [p.detach().clone() for p in params]
        norm = real(self)
        with torch.no_grad():
            for p, k in zip(params, keep):
                p.copy_(k)
        return norm

    patch(train_state.AdamW, "step", step)


def half_batch(patch) -> None:
    """The loss of the first half of the batch alone, its mean over those
    rows: the other half left out."""
    from handsonvlm_torch.train import step as train_step

    real = train_step.loss_fn

    def loss_fn(model, cfg, batch, *, eps=None, **k):
        half = batch["input_ids"].shape[0] // 2
        rows = {n: (v if n == "frame_map" else v[:half]) for n, v in batch.items()}
        return real(model, cfg, rows, eps=None if eps is None else eps[: eps.shape[0] // 2], **k)

    patch(train_step, "loss_fn", loss_fn)


FAULTS = {"altered_tokens": altered_tokens, "shifted_draws": shifted_draws,
          "altered_answers": altered_answers,
          "unchanged_state": unchanged_state, "half_batch": half_batch}
