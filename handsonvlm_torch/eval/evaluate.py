"""EK100 evaluation CLI (reference: handsonvlm/evaluation/evaluate.py).

Port of `handsonvlm_tpu/eval/evaluate.py`: the model from the builder, the
EPIC conversation dataset (vanilla, or the reasoning questions with
`--use-reason`) read from the on-disk layout under $HANDSONVLM_DATA_ROOT
(data/epic_constants.py), the stochastic ADE/FDE/WDE of
eval/evaluator.py, printed and written as `{"ade", "fde", "wde", "n"}`.

Usage:
  python -m handsonvlm_torch.eval.evaluate --model-path /ckpts/handsonvlm-7b \\
      [--use-reason] [--ek-version ek100] [--split validation] [--limit N] \\
      [--int8 | --int4] [--kv-int8] [--spec K] [--batched SLOTS] [--device cuda]

`--seed` seeds both the decode draws and the dataset's template and
narration draws (a `random.Random`), so a run is reproducible.
"""

from __future__ import annotations

import argparse
import json
import random
from typing import Optional, Sequence

from handsonvlm_torch.data.epic_dataset import (
    EpicConversationDataset,
    EpicReasoningConversationDataset,
)
from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
from handsonvlm_torch.eval.evaluator import InferenceEngine, evaluate_epic_kitchen_traj
from handsonvlm_torch.infer.builder import load_pretrained_model


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-path", required=True)
    p.add_argument("--preset", default="7b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ek-version", default="ek100")
    p.add_argument("--split", default="validation")
    p.add_argument("--use-reason", action="store_true")
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--max-new-tokens", type=int, default=100)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--kv-int8", action="store_true",
                   help="int8-quantized decode cache")
    p.add_argument("--num-samples", type=int, default=1,
                   help="stochastic decodes per clip (min/mean-over-samples)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decoder (memory; slight accuracy cost)")
    p.add_argument("--int4", action="store_true",
                   help="int4 group-wise weight-only decoder (more memory, more error)")
    p.add_argument("--out", default=None, help="json results path")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decode (distribution-exact; B=1 eval "
                        "is the protocol, so metrics are unchanged)")
    p.add_argument("--batched", type=int, default=0, metavar="SLOTS",
                   help="route decodes through the continuous-batching "
                        "engine with SLOTS shared-decode slots (aggregate "
                        "throughput; per-sample streams are composition-"
                        "independent so scoring is unchanged)")
    p.add_argument("--batched-max-len", type=int, default=4096)
    p.add_argument("--batched-chunk", type=int, default=16)
    return p.parse_args(argv)


def build_dataset(args: argparse.Namespace, tokenizer):
    """The evaluated conversation dataset (evaluate.py:50-64), its draws
    from `random.Random(args.seed)`."""
    hoi = get_epic_hoi_dataset_by_name(
        args.ek_version, args.split, load_images=True,
        rephrase_rate=1.0 if args.use_reason else 0.0, use_wrong_narration=False,
        use_percentage=1.0, rng=random.Random(args.seed),
    )
    ds_cls = EpicReasoningConversationDataset if args.use_reason else EpicConversationDataset
    return ds_cls(tokenizer, hoi, deterministic=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the evaluator's result (the summary's keys and
    `val_info`, which holds each clip's generated tokens)."""
    args = parse_args(argv)
    model, cfg, tokenizer = load_pretrained_model(
        args.model_path, args.preset, args.device,
        quantize="int8" if args.int8 else ("int4" if args.int4 else None))
    dataset = build_dataset(args, tokenizer)
    engine = InferenceEngine(
        model=model, cfg=cfg, tokenizer=tokenizer,
        temperature=args.temperature, top_p=args.top_p,
        max_new_tokens=args.max_new_tokens, spec_k=args.spec,
        kv_quant="int8" if args.kv_int8 else None,
    )
    try:
        result = evaluate_epic_kitchen_traj(
            engine, dataset, seed=args.seed, limit=args.limit,
            num_samples=args.num_samples, batched=args.batched,
            batched_max_len=args.batched_max_len, batched_chunk=args.batched_chunk,
        )
    finally:
        for sched in engine.__dict__.get("_batched_scheds", {}).values():
            sched.stop()
    summary = {k: result[k] for k in ("ade", "fde", "wde", "n")}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return result


if __name__ == "__main__":
    main()
