"""Standalone hoi-forecast training CLI.

Port of `handsonvlm_tpu/train/hoi_train.py` with every flag and default,
plus `--device` (default cuda):

  HANDSONVLM_DATA_ROOT=/data python -m handsonvlm_torch.train.hoi_train \\
      --output-dir runs/hoi --epochs 35 --batch-size 128 --lr 1e-4

Each epoch draws `len(train) // batch_size` batches (at least one) of
`batch_size` clips with replacement from a numpy generator seeded with the
epoch, prints one JSON line of mean losses (and the mean step time, the
reference trainer's batch-time meter, and the epoch's wall time), every
`--eval-every` epochs one line of validation ADE / FDE / WDE, and saves
the train state under `<output-dir>/ckpt/<step>/`. A run over an existing
checkpoint restores the latest step and, as the JAX CLI does, runs its
epoch loop from epoch 0 again with the restored step count and optimizer
state.
"""

from __future__ import annotations

import argparse
import json
import os
import time

HOI_KEYS = ("feat", "bbox_feat", "valid_mask", "future_hands", "contact_point", "future_valid")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # nets opts (netsopts.py)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--coord-dim", type=int, default=64)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--enc-depth", type=int, default=6)
    p.add_argument("--dec-depth", type=int, default=4)
    p.add_argument("--hidden-dim", type=int, default=512)
    p.add_argument("--latent-dim", type=int, default=256)
    p.add_argument("--lambda-obj", type=float, default=0.1)
    p.add_argument("--lambda-traj", type=float, default=1.0)
    p.add_argument("--lambda-obj-kl", type=float, default=1e-3)
    p.add_argument("--lambda-traj-kl", type=float, default=1e-3)
    p.add_argument("--lambda-last-hand", type=float, default=1e-3)
    p.add_argument("--global-only", action="store_true")
    # train opts (expopts.py)
    p.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "sgd", "rms"])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--epochs", type=int, default=35)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--ek-version", default="ek100")
    p.add_argument("--eval-every", type=int, default=5, help="epochs")
    p.add_argument("--num-samples", type=int, default=5)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from handsonvlm_torch.core.checkpoint import restore_train_state, save_train_state
    from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
    from handsonvlm_torch.models.object_transformer import (
        ObjectTransformer,
        ObjectTransformerConfig,
    )
    from handsonvlm_torch.train.hoi_trainer import (
        cosine_decay_schedule,
        epoch_evaluate,
        epoch_pass,
        make_hoi_optimizer,
        make_hoi_train_step,
        warmup_schedule,
    )
    from handsonvlm_torch.train.train_state import create_train_state

    device = torch.device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = ObjectTransformerConfig(
        token_dim=args.embed_dim, coord_dim=args.coord_dim,
        num_heads=args.num_heads, enc_depth=args.enc_depth,
        dec_depth=args.dec_depth, hidden_dim=args.hidden_dim,
        latent_dim=args.latent_dim,
        num_patches=1 if args.global_only else 5, global_only=args.global_only,
    )
    lambdas = dict(
        lambda_obj=args.lambda_obj, lambda_traj=args.lambda_traj,
        lambda_obj_kl=args.lambda_obj_kl, lambda_traj_kl=args.lambda_traj_kl,
        lambda_last_hand=args.lambda_last_hand,
    )

    train_ds = get_epic_hoi_dataset_by_name(args.ek_version, "train", load_images=False)
    val_ds = get_epic_hoi_dataset_by_name(args.ek_version, "validation", load_images=False)
    if len(train_ds) == 0 or len(val_ds) == 0:
        raise SystemExit(f"{args.ek_version}: the train ({len(train_ds)}) or validation "
                         f"({len(val_ds)}) split holds no labelled clip")
    iters_per_epoch = max(len(train_ds) // args.batch_size, 1)

    model = ObjectTransformer(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    sched = warmup_schedule(
        args.lr, args.warmup_epochs * iters_per_epoch,
        cosine_decay_schedule(args.lr, args.epochs * iters_per_epoch),
    )
    opt = make_hoi_optimizer(model, args.optimizer, schedule=sched,
                             weight_decay=args.weight_decay)
    state = create_train_state(model, opt)
    ckpt = os.path.join(args.output_dir, "ckpt")
    if restore_train_state(ckpt, state) is not None:
        print(json.dumps({"restored_step": state.step}), flush=True)

    step_fn = make_hoi_train_step(cfg, opt, lambdas)

    def batches(ds, n_steps, seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_steps):
            idxs = rng.integers(0, len(ds), size=args.batch_size)
            samples = [ds[int(i)][0] for i in idxs]
            yield {k: np.stack([np.asarray(s[k], np.float32) for s in samples]) for k in HOI_KEYS}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for epoch in range(args.epochs):
        step_times = []

        def timed(state, batch, rng):
            sync()
            t0 = time.perf_counter()
            out = step_fn(state, batch, rng)
            sync()
            step_times.append(time.perf_counter() - t0)
            return out

        t0 = time.perf_counter()
        state, means = epoch_pass(batches(train_ds, iters_per_epoch, epoch), state, timed, epoch)
        print(json.dumps({"epoch": epoch, **means,
                          "step_ms": 1e3 * sum(step_times) / len(step_times),
                          "sec": time.perf_counter() - t0}), flush=True)
        if (epoch + 1) % args.eval_every == 0:
            t0 = time.perf_counter()
            metrics = epoch_evaluate(
                batches(val_ds, max(len(val_ds) // args.batch_size, 1), 10_000 + epoch),
                state.model, cfg, 999 + epoch, num_samples=args.num_samples,
            )
            print(json.dumps({"epoch": epoch, **{f"val/{k}": v for k, v in metrics.items()},
                              "sec": time.perf_counter() - t0}), flush=True)
        save_train_state(ckpt, state, int(state.step))


if __name__ == "__main__":
    main()
