"""A multi-rank dry run of the parallel paths at a small, complete preset.

Counterpart of the JAX package's `dryrun_multichip` (its driver entry
point): N ranks on this machine (NCCL on the cards, gloo on the CPU) run

- one FSDP2 train step over a ('data',) mesh of the N ranks, full SFT on a
  batch of max(2N, 2) rows (`parallel/partition.shard_model`);
- a 4-token greedy decode of an int4 model at tp = N
  (`parallel/tp.shard_llama_tp`, `infer/sampler.generate_host(tp=)`);
- ring attention over the N ranks against plain attention, its max error;

and rank 0 prints one line in the JAX line's form. The preset is the JAX
entry's "graft" config (4 layers of 256, CLIP 56 px), kept here as a copy.
`--kind tp-train` runs instead one full-SFT step tensor parallel inside
training: a ('data', 'model') mesh of N/2 x 2, the decoder cut for each
rank (`parallel/tp.shard_for_training`), FSDP2 over 'data'.

  python -m handsonvlm_torch.parallel.dryrun --devices 4 [--device cpu] [--kind tp-train]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from handsonvlm_torch.config import (
    ClipVisionConfig,
    HandsOnVLMConfig,
    LlamaConfig,
    TrajDecoderConfig,
)
from handsonvlm_torch.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX


def graft_config() -> HandsOnVLMConfig:
    """Architecture-complete and small: the JAX entry's "graft" preset."""
    return HandsOnVLMConfig(
        llama=LlamaConfig(vocab_size=32101, hidden_size=256, intermediate_size=512,
                          num_layers=4, num_heads=8),
        vision=ClipVisionConfig(hidden_size=128, intermediate_size=256, num_layers=4,
                                num_heads=4, image_size=56, patch_size=14),
        traj=TrajDecoderConfig(hidden_dim=64, latent_dim=32, coord_dim=16),
        num_frames=16,
        mm_hidden_size=128,
    )


def example_batch(cfg: HandsOnVLMConfig, b: int = 2, t: int = 24, seed: int = 0) -> dict:
    """The JAX entry's example batch: the image sentinel at 1, four hand
    tokens, labels from position 15 (numpy)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(b, t))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[:, [16, 18, 20, 22]] = HAND_TOKEN_ID
    labels = np.full((b, t), IGNORE_INDEX)
    labels[:, 15:] = ids[:, 15:]
    size = cfg.vision.image_size
    return {
        "input_ids": ids,
        "attn_mask": np.ones((b, t), bool),
        "image": rng.normal(size=(b, cfg.num_frames, 3, size, size)).astype(np.float32),
        "labels": labels,
        "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
        "future_valid": np.ones((b, 2), np.float32),
    }


def _model(cfg, seed: int, device):
    from handsonvlm_torch.models.handsonvlm import HandsOnVLM

    model = HandsOnVLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def tp_train_main(rank: int, world: int, kind: str) -> dict:
    """One rank's tensor-parallel training step on a (world / 2, 2) mesh
    (one rank: 1 x 1); returns its numbers."""
    from handsonvlm_torch.parallel.mesh import create_mesh, model_group
    from handsonvlm_torch.parallel.partition import shard_model
    from handsonvlm_torch.parallel.tp import shard_for_training
    from handsonvlm_torch.train.step import make_train_step
    from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

    device = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else \
        torch.device("cpu")
    cfg = graft_config()
    model_axis = 2 if world % 2 == 0 else 1
    mesh = create_mesh(model=model_axis, device=kind)
    model = _model(cfg, 0, device)
    if model_axis > 1:
        shard_for_training(model, cfg, model_group(mesh))
    shard_model(model, mesh)
    opt = make_optimizer(model, learning_rate=1e-4)
    step = make_train_step(cfg, opt, attn_impl="xla", mesh=mesh)
    metrics = step(create_train_state(model, opt),
                   example_batch(cfg, b=max(2 * (world // model_axis), 2)), 3)
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"]), metrics
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "mesh": (world // model_axis, model_axis)}


def rank_main(rank: int, world: int, kind: str) -> dict:
    """One rank's part of the dry run; returns its numbers."""
    import torch.distributed as dist

    from handsonvlm_torch.infer.sampler import generate_host
    from handsonvlm_torch.models.llama import quantize_llama_int4
    from handsonvlm_torch.ops.attention import attention_xla
    from handsonvlm_torch.parallel.mesh import create_mesh
    from handsonvlm_torch.parallel.partition import shard_model
    from handsonvlm_torch.parallel.ring_attention import ring_attention, shard_sequence
    from handsonvlm_torch.parallel.tp import TPGroup, shard_llama_tp
    from handsonvlm_torch.train.step import make_train_step
    from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

    device = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else \
        torch.device("cpu")
    cfg = graft_config()

    # one FSDP2 train step over every rank
    mesh = create_mesh(device=kind)
    model = shard_model(_model(cfg, 0, device), mesh)
    opt = make_optimizer(model, learning_rate=1e-4)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="xla", mesh=mesh)
    metrics = step(state, example_batch(cfg, b=max(2 * world, 2)), 3)
    assert np.isfinite(metrics["loss"]), metrics

    # a greedy int4 decode, tensor parallel over every rank
    qmodel = _model(cfg, 7, device)
    quantize_llama_int4(qmodel.llama, cfg.llama)
    shard_llama_tp(qmodel.llama, cfg.llama, rank, world)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(1, 8))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    size = cfg.vision.image_size
    images = rng.normal(size=(1, cfg.num_frames, 3, size, size)).astype(np.float32)
    out = generate_host(qmodel, cfg, ids, images, torch.Generator(device=device).manual_seed(9),
                        max_new_tokens=4, temperature=0.0,
                        tp=TPGroup.world() if world > 1 else None)
    n_tok = int(out.num_tokens[0])
    assert n_tok >= 1 and np.isfinite(out.pred_hands).all()

    # ring attention over every rank against plain attention
    seq = create_mesh(seq=world, device=kind) if world > 1 else None
    t_ring = 8 * world
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((2, t_ring, 4, 16), generator=g).to(device) for _ in range(3))
    want = attention_xla(q, k, v, causal=True)
    if seq is None:
        got, ref = want, want
    else:
        got = ring_attention(*(shard_sequence(x, seq) for x in (q, k, v)), mesh=seq,
                             causal=True)
        ref = shard_sequence(want, seq)
    err = (got - ref).abs().max().reshape(1)
    if dist.is_initialized():
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
    ring_err = float(err)
    assert ring_err < 1e-4, ring_err
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "tokens": n_tok,
            "ring_err": ring_err}


def dryrun(n_devices: int, device: str = "cuda", kind: str = "all") -> str:
    """Run the dry run (`kind` "all" or "tp-train") over `n_devices` ranks;
    returns (and prints) its line."""
    from handsonvlm_torch.parallel.distributed import spawn

    if kind == "tp-train":
        r = spawn(tp_train_main, n_devices, device, device=device)[0]
        line = (f"dryrun_multichip tp-train ok: mesh={r['mesh']} loss={r['loss']:.4f} "
                f"grad_norm={r['grad_norm']:.4f}")
        print(line, flush=True)
        return line
    r = spawn(rank_main, n_devices, device, device=device)[0]
    line = (f"dryrun_multichip ok: mesh=({n_devices},1) loss={r['loss']:.4f} "
            f"grad_norm={r['grad_norm']:.4f} tp_decode_tokens={r['tokens']} "
            f"ring_attn_err={r['ring_err']:.2e}")
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0: every card, on the CPU 2)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--kind", default="all", choices=("all", "tp-train"),
                   help="all: the FSDP step, the TP decode and the ring; tp-train: one "
                        "step tensor parallel inside training on a (N/2, 2) mesh")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no card here (pass --device cpu)")
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if args.device == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--devices {n}: this machine has {torch.cuda.device_count()} cards")
    dryrun(n, args.device, args.kind)


if __name__ == "__main__":
    main()
