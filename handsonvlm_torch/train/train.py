"""SFT / LoRA / QLoRA training entry point.

Port of `handsonvlm_tpu/train/train.py` (the reference's
`handsonvlm/train/train.py` + `handsonvlm_trainer.py`) on one device: the
model from the builder, adapters and freezing as the JAX CLI sets them up,
the cosine schedule and clipped AdamW of `train/train_state.py`, the train
step of `train/step.py`, the prefetching loader, checkpoints with
auto-resume, the adapter artifacts the builder loads, one JSON metrics line
per logged step and `metrics.jsonl` (utils/metrics_writer.py).

Usage (recipe defaults mirror scripts/finetune.sh):
  python -m handsonvlm_torch.train.train --model-path random:7b --preset 7b \\
      --qlora int8_fused --lora-r 128 --output-dir ./runs/h7b --synthetic 4 \\
      --samples-per-epoch 4 --batch-size 1 --max-steps 2

Every JAX flag is here. Without `--synthetic` the data is the `--tasks`
mixture read from disk: the EPIC conversation group (`epic_kitchen`,
`reasoning`, `vanilla`) from the EK layout under $HANDSONVLM_DATA_ROOT, the
LITA tasks and `pretrain` from `--data-path`. `--eval-every N` scores
`--eval-samples` EK validation clips (ADE/FDE/WDE through
eval/evaluator.py) every N steps, each clip with draws of its own (seeded
from the step and the clip), so a state scores the same whatever the
launch. Each dataset of the mixture draws from
generators of its own, seeded from `--seed`, its place in the mixture and
the step the run starts from (data/draws.py): one seed gives one stream of
items, and a resumed run draws new ones. `--device` (default cuda) picks the
device.

Launched by torchrun (`torchrun --nproc-per-node N -m
handsonvlm_torch.train.train ...`) the run is data parallel over the N
ranks, as the JAX CLI's mesh is (data = every device): the model is
sharded by FSDP2 (`parallel/partition.shard_model`), every rank draws the
same global batch of `--batch-size` and keeps its rows (N must divide it),
rank 0 logs the metrics and writes the checkpoints and artifacts, the
whole state dicts a one-rank run writes, so either run resumes the other's.
`--seq-parallel P` cuts the sequence over P ranks with ring attention
(`parallel/ring_attention.py`), the remaining N / P ranks forming the data
axis. `--model-axis M` makes the mesh ('data', 'model') of N / M x M, as
the JAX CLI's: each rank holds its Megatron cut of the decoder (dense or
the QLoRA base) and of the adapters (`parallel/tp.shard_for_training`),
FSDP2 shards those slices over the data axis, the M ranks of a model group
take the same rows, and the checkpoints and adapter artifacts stay the
whole one-rank state dicts. `--model-axis` with `--seq-parallel` above 1
is refused, as the JAX mesh refuses it.

Under torchrun `--eval-every` splits the clips over the eval groups, clip
i to group i mod G: with `--model-axis M` the N / M model groups, each
decoding its clips in lockstep on its ranks' Megatron slices (the
sampler's `tp`); otherwise (FSDP2 alone, `--seq-parallel`) every rank on
the whole model. Each rank decodes from `parallel/partition.eval_model`, a
plain copy of its slices made whole over the data axis, so that no decode
step waits on another data group, and the training model, its optimizer
and the data draws are left as a run without evaluation has them. Every
rank gathers the groups' per-clip records and scores their union in clip
order; rank 0 alone prints and logs the `eval/*` line.

  torchrun --nproc-per-node 4 -m handsonvlm_torch.train.train --model-path random:7b \\
      --preset 7b --model-axis 2 --qlora int8_fused --lora-r 128 --synthetic 4 \\
      --samples-per-epoch 4 --batch-size 2 --max-steps 2 --output-dir ./runs/tp \\
      [--eval-every 1 --eval-samples 4]     # with the EK layout under $HANDSONVLM_DATA_ROOT
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-path", default="random:tiny",
                   help="HF init checkpoint dir, a directory of this trainer, or "
                        "random:<preset>")
    p.add_argument("--preset", default="7b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-frames", type=int, default=0,
                   help="override the preset's video frame slots (0 = preset)")
    p.add_argument("--max-len", type=int, default=0,
                   help="context length budget (0 = preset, 2048 like the reference's "
                        "model_max_length); RoPE is computed from positions, so more works")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--ek-version", default="ek100")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--samples-per-epoch", type=int, default=48296)
    p.add_argument("--batch-size", type=int, default=128, help="global batch")
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--model-axis", type=int, default=1,
                   help="tensor-parallel axis size (Megatron cuts of the decoder over a "
                        "('data','model') mesh of the torchrun ranks)")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence-parallel axis size (ring attention over a "
                        "('data','seq') mesh of the torchrun ranks)")
    p.add_argument("--lora-r", type=int, default=0,
                   help="enable LoRA with this rank (reference: 128)")
    p.add_argument("--lora-alpha", type=float, default=256.0)
    p.add_argument("--lora-bf16", action="store_true",
                   help="run the adapter matmuls in bf16 (f32 master weights and "
                        "optimizer unchanged)")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "dots", "dots_nobatch", "save_lora"],
                   help="what each decoder layer's recompute keeps: full = nothing "
                        "(least memory, the reference recipe), dots = the matmul "
                        "outputs, save_lora = the LoRA first-stage outputs")
    p.add_argument("--mu-bf16", action="store_true",
                   help="bf16 Adam first moment (halves its memory)")
    p.add_argument("--qlora", choices=["int8", "int8_fused", "int4"], default=None,
                   help="quantize the frozen decoder base (requires --lora-r): int8 "
                        "(kernel B9, plain backward), int8_fused (the fused int8 + "
                        "LoRA-epilogue kernels B10a / B10b) or int4 (tiled, B5b / B7b)")
    p.add_argument("--tune-mm-mlp-adapter", action="store_true",
                   help="train only the mm_projector and save adapter-only artifacts "
                        "(reference train.py:104-122 mm_projector.bin)")
    p.add_argument("--rephrase-rate", type=float, default=0.3)
    p.add_argument("--use-percentage", type=float, default=1.0)
    p.add_argument("--save-every", type=int, default=0, help="steps; 0 = per epoch")
    p.add_argument("--eval-every", type=int, default=0,
                   help="steps between generate+ADE/FDE evals (0 = off); "
                        "replaces HandsOnVLMTrainer.evaluation_loop")
    p.add_argument("--eval-samples", type=int, default=64,
                   help="EK validation clips per in-training eval")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=0, help="0 = epochs*spe/bs")
    p.add_argument("--tasks", default="epic_kitchen",
                   help="|| separated: epic_kitchen, reasoning, pretrain, "
                        "dvc, event_loc, imgqa, vidqa, temporal_reasoning "
                        "(the reference's task mixture, arguments.py "
                        "DataArguments.tasks + llava pretrain stage)")
    p.add_argument("--data-path", default=None,
                   help="root of the LITA/LLaVA task data (defaults to "
                        "$HANDSONVLM_DATA_ROOT)")
    p.add_argument("--task-sample-rates", default=None,
                   help="comma list, one rate per dataset group in --tasks order; "
                        "epic variants (epic_kitchen/reasoning/vanilla) share "
                        "ONE group at the first epic position (default uniform)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples (smoke runs without EK data)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the --tasks data draws, each dataset's own, derived "
                        "with its place in the mixture and the step the run starts "
                        "from (data/draws.py), and of --synthetic's items, each drawn "
                        "from (seed, its step and place in the global batch)")
    return p.parse_args(argv)


def _require_ek_layout(args, what: str) -> None:
    """Refuse before any work when the EK annotations `what` reads are not
    on disk."""
    from handsonvlm_torch.data.epic_constants import annotation_dir

    adir = annotation_dir(args.ek_version)
    if not os.path.isdir(adir):
        raise SystemExit(f"{what} reads the {args.ek_version} EK layout, but {adir} is "
                         "missing: set HANDSONVLM_DATA_ROOT to the data root")


def _check_flags(args, world: int = 1) -> None:
    if args.model_axis > 1 and args.seq_parallel > 1:
        raise SystemExit("seq and model axes are mutually exclusive")
    for flag, n in (("--model-axis", args.model_axis), ("--seq-parallel", args.seq_parallel)):
        if n < 1 or world % n:
            raise SystemExit(f"{flag} {n} does not divide the {world} ranks of the launch")
    data = world // (args.seq_parallel * args.model_axis)
    if args.batch_size % data:
        raise SystemExit(f"--batch-size {args.batch_size} is not divisible by the {data} "
                         "ranks of the 'data' axis")
    if args.qlora and not args.lora_r:
        raise SystemExit("--qlora requires --lora-r (the base is frozen)")
    if args.tune_mm_mlp_adapter and args.lora_r:
        raise SystemExit("--tune-mm-mlp-adapter is exclusive with --lora-r")
    if args.eval_every:
        _require_ek_layout(args, "--eval-every (the EK validation set)")


def task_datasets(args, tokenizer):
    """The `--tasks` mixture (JAX train.py:213-290): one dataset group per
    task in `--tasks` order, the epic variants sharing one group at the
    first epic position, and the groups' sample rates."""
    from handsonvlm_torch.data.epic_constants import data_root
    from handsonvlm_torch.data.epic_dataset import (
        EpicConversationDataset,
        EpicMultiturnConversationDataset,
        EpicReasoningConversationDataset,
    )
    from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
    from handsonvlm_torch.data.lita_datasets import LITA_DATASET_REGISTRY, LlavaPretrainDataset

    data_path = args.data_path or data_root()
    tasks = args.tasks.split("||")
    epic_names = {"epic_kitchen", "reasoning", "vanilla"}

    def epic_group():
        _require_ek_layout(args, f"--tasks {args.tasks}")
        hoi = get_epic_hoi_dataset_by_name(
            args.ek_version, "train", load_images=True, rephrase_rate=args.rephrase_rate,
            use_percentage=args.use_percentage)
        group = []
        if "epic_kitchen" in tasks:
            group.append(EpicMultiturnConversationDataset(tokenizer, hoi))
        if "reasoning" in tasks:
            group.append(EpicReasoningConversationDataset(tokenizer, hoi))
        return group or [EpicConversationDataset(tokenizer, hoi)]

    groups, names = [], []
    for t in tasks:
        if t in epic_names:
            if "epic" not in names:
                groups.append(epic_group())
                names.append("epic")
        elif t == "pretrain":
            # projector-pretraining stage (llava/train/train.py
            # LazySupervisedDataset + plain template); pair with
            # --tune-mm-mlp-adapter for the reference recipe
            groups.append([LlavaPretrainDataset(data_path, tokenizer)])
            names.append(t)
        elif t in LITA_DATASET_REGISTRY:
            groups.append([cls(data_path, tokenizer)
                           for cls in LITA_DATASET_REGISTRY[t].values()])
            names.append(t)
    if not groups:  # no task recognized: default EK SFT
        groups.append(epic_group())
        names.append("epic")
    if not args.task_sample_rates:
        return groups, [1.0] * len(groups)
    rates = [float(x) for x in args.task_sample_rates.split(",")]
    if len(rates) != len(groups):
        raise SystemExit(
            f"--task-sample-rates has {len(rates)} entries but --tasks resolves to "
            f"{len(groups)} dataset groups {names} (epic variants share one group)")
    return groups, rates


def main(argv=None):
    """Run the CLI; returns the final TrainState (tests read it)."""
    args = parse_args(argv)

    import torch

    from handsonvlm_torch.parallel import distributed

    distributed.initialize(device=args.device)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    _check_flags(args, world)
    main_rank = distributed.is_main_process()

    from handsonvlm_torch.core.checkpoint import (
        latest_step,
        restore_train_state,
        save_artifact,
        save_train_state,
    )
    from handsonvlm_torch.data.draws import seed_mixture
    from handsonvlm_torch.data.hybrid_dataset import Collator, HybridDataset
    from handsonvlm_torch.data.synthetic import SyntheticConversationDataset
    from handsonvlm_torch.infer.builder import load_pretrained_model
    from handsonvlm_torch.models import lora as lora_mod
    from handsonvlm_torch.parallel.mesh import create_mesh, model_group
    from handsonvlm_torch.parallel.partition import full_state_dict, shard_model
    from handsonvlm_torch.parallel.tp import shard_for_training
    from handsonvlm_torch.train.loader import PrefetchLoader
    from handsonvlm_torch.train.step import make_train_step
    from handsonvlm_torch.train.train_state import (
        cosine_schedule,
        create_train_state,
        make_optimizer,
    )
    from handsonvlm_torch.utils.metrics_writer import MetricsWriter

    os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    model, cfg, tokenizer = load_pretrained_model(args.model_path, args.preset, device,
                                                  quantize=args.qlora)
    if args.num_frames:
        cfg = dataclasses.replace(cfg, num_frames=args.num_frames)
    if args.max_len:
        cfg = dataclasses.replace(cfg, max_length=args.max_len, llama=dataclasses.replace(
            cfg.llama, max_position_embeddings=max(args.max_len,
                                                   cfg.llama.max_position_embeddings)))
        tokenizer.model_max_length = args.max_len
    freeze = ("vision",)
    if args.lora_r:
        if args.lora_bf16:
            lora_mod.LORA_COMPUTE_BF16 = True
        model.lora = lora_mod.init_lora(torch.Generator(device=device).manual_seed(42),
                                        cfg.llama, r=args.lora_r, alpha=args.lora_alpha,
                                        device=device)
        freeze = ("vision", "llama")  # adapters + projector + traj head train
    if args.tune_mm_mlp_adapter:
        freeze = tuple(name for name, child in model.named_children()
                       if child is not None and name != "projector")
    mesh = None
    if world > 1:
        mesh = create_mesh(model=args.model_axis, seq=args.seq_parallel, device=device.type)
        if args.model_axis > 1:
            shard_for_training(model, cfg, model_group(mesh))
        shard_model(model, mesh)
        if main_rank:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over {world} "
                  "ranks", flush=True)

    def save_adapters(model):
        """Adapter-only artifacts beside the checkpoints: the builder's
        adapter path loads them (whole tensors, written by rank 0)."""
        if args.tune_mm_mlp_adapter:
            projector = full_state_dict(model.projector)
            if main_rank:
                save_artifact(args.output_dir, "mm_projector", projector,
                              meta={"base": args.model_path, "preset": args.preset})
        if args.lora_r:
            lora, projector, traj = (full_state_dict(m) for m in (
                model.lora, model.projector, model.traj))
            if main_rank:
                save_artifact(args.output_dir, "lora", lora,
                              meta={"base": args.model_path, "preset": args.preset,
                                    "r": args.lora_r, "alpha": args.lora_alpha,
                                    "qlora": args.qlora})
                save_artifact(args.output_dir, "non_lora_trainables",
                              {"projector": projector, "traj": traj})

    steps_per_epoch = max(args.samples_per_epoch // args.batch_size, 1)
    total_steps = args.max_steps or args.epochs * steps_per_epoch
    sched = cosine_schedule(args.learning_rate, total_steps, args.warmup_ratio)
    opt = make_optimizer(model, sched, weight_decay=args.weight_decay, freeze_top_keys=freeze,
                         mu_dtype=torch.bfloat16 if args.mu_bf16 else None)
    state = create_train_state(model, opt)

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    t0 = time.perf_counter()
    if restore_train_state(ckpt_dir, state) is not None and main_rank:
        print(f"resumed from step {state.step} (restored in "
              f"{time.perf_counter() - t0:.3f} s)", flush=True)

    mixture_seed = None
    if args.synthetic:
        groups = [[SyntheticConversationDataset(tokenizer, cfg, n=args.synthetic,
                                                seed=args.seed)]]
        rates = [1.0]
    else:
        groups, rates = task_datasets(args, tokenizer)
        groups, mixture_seed = seed_mixture(groups, args.seed, state.step)
    hybrid = HybridDataset(task_datasets=groups, task_sample_rate=rates,
                           samples_per_epoch=args.samples_per_epoch, seed=mixture_seed)
    collate = Collator(pad_token_id=tokenizer.pad_token_id, model_max_length=cfg.max_length,
                       num_frames=cfg.num_frames, seq_multiple=args.seq_parallel,
                       splice_extra=cfg.num_visual_tokens - 1)
    # every rank draws the global batch; the step keeps this rank's rows
    loader = PrefetchLoader(hybrid, collate, args.batch_size,
                            num_steps=max(total_steps - state.step, 0), device=device,
                            process_index=0, process_count=1, first_step=state.step)
    step_fn = make_train_step(cfg, opt, remat=args.remat_policy, mesh=mesh,
                              seq_mesh=mesh if args.seq_parallel > 1 else None)
    save_every = args.save_every or steps_per_epoch
    writer = MetricsWriter(args.output_dir) if main_rank else None

    # optional generate+score eval during training
    # (HandsOnVLMTrainer.evaluation_loop equivalent, handsonvlm_trainer.py:110-322)
    eval_dataset = None
    if args.eval_every:
        from handsonvlm_torch.data.epic_dataset import EpicConversationDataset
        from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
        from handsonvlm_torch.eval.evaluator import evaluate_sharded

        eval_hoi = get_epic_hoi_dataset_by_name(
            args.ek_version, "validation", load_images=True, rephrase_rate=0.0,
            use_percentage=1.0)
        eval_dataset = EpicConversationDataset(tokenizer, eval_hoi, deterministic=True)

    def run_eval(model, step):
        """The evaluation at `step` (every rank calls it and gets the scores)."""
        res = evaluate_sharded(model, cfg, tokenizer, eval_dataset, mesh, seed=step,
                               limit=args.eval_samples)
        return {f"eval/{k}": res[k] for k in ("ade", "fde", "wde", "n")}

    def save(step):
        t = time.perf_counter()
        nbytes = save_train_state(ckpt_dir, state, step)
        save_adapters(state.model)
        if main_rank:
            print(f"saved checkpoint at step {step} ({nbytes} bytes in "
                  f"{time.perf_counter() - t:.3f} s)", flush=True)

    t0 = time.time()
    for batch in loader:
        metrics = step_fn(state, batch, 0)
        step = state.step
        if eval_dataset is not None and step % args.eval_every == 0:
            em = run_eval(state.model, step)
            if main_rank:
                print(json.dumps(dict(em, step=step)), flush=True)
                writer.log(em, step)
        if step % args.log_every == 0:
            m = dict(metrics, lr=sched(step),
                     sec_per_step=(time.time() - t0) / max(args.log_every, 1))
            t0 = time.time()
            if main_rank:
                print(json.dumps(dict(m, step=step)), flush=True)
                writer.log(m, step)
        if step % save_every == 0 or step >= total_steps:
            save(step)
        if step >= total_steps:
            break
    if latest_step(ckpt_dir) != state.step:
        save(state.step)
    if main_rank:
        writer.close()
        print("training complete", flush=True)
    return state


if __name__ == "__main__":
    main()
