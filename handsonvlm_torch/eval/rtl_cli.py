"""RTL evaluation CLI (reference: lita/eval/eval_model_rtl.py).

Port of `handsonvlm_tpu/eval/rtl_cli.py`: loops a question file ({id,
video, question, duration, timestamps}), renders LITA-style prompts,
generates with the cached sampler, converts generated time tokens back to
seconds, and scores IoU / Precision@0.5. Frames are read through
data/native_loader.py (libjpeg where it builds, else PIL). Every request
draws from one `torch.Generator` seeded from `--seed`.

Usage:
  python -m handsonvlm_torch.eval.rtl_cli --model-path /ckpts/lita-7b \\
      --question-file rtl_val.json --video-frames-root /data/activitynet_frames \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from handsonvlm_torch.data.native_loader import load_frames
from handsonvlm_torch.eval.evaluator import InferenceEngine
from handsonvlm_torch.eval.rtl import parse_start_end_timestamps, score_rtl, time_token_to_seconds
from handsonvlm_torch.infer.builder import load_pretrained_model


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-path", required=True)
    p.add_argument("--preset", default="7b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--question-file", required=True)
    p.add_argument("--video-frames-root", required=True)
    p.add_argument("--ext", default=".jpg")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {"scores", "predictions"}."""
    args = parse_args(argv)
    model, cfg, tokenizer = load_pretrained_model(args.model_path, args.preset, args.device)
    engine = InferenceEngine(
        model=model, cfg=cfg, tokenizer=tokenizer,
        temperature=args.temperature, top_p=args.top_p,
        max_new_tokens=args.max_new_tokens,
    )
    time_token_ids = getattr(
        tokenizer, "time_token_ids", list(range(32000, 32100))
    )
    id_to_index = {tid: i for i, tid in enumerate(time_token_ids)}

    with open(args.question_file) as f:
        questions = json.load(f)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    predictions = []
    for line in questions:
        vid = line["id"] if "id" in line else line["video"]
        duration = float(line["duration"])
        frames = sorted(
            glob.glob(os.path.join(args.video_frames_root, vid, "*" + args.ext))
        )
        idx = np.round(np.linspace(0, len(frames) - 1, cfg.num_frames)).astype(int)
        images = load_frames([frames[i] for i in idx])[None]

        _, _, gen_ids = engine.infer(line["question"], images, generator)
        # decode: time tokens -> "<sec>" strings, then parse first two
        pieces = []
        for tid in gen_ids:
            tid = int(tid)
            if tid in id_to_index:
                sec = time_token_to_seconds(id_to_index[tid], duration)
                pieces.append(f"<{sec:.2f}>")
            else:
                pieces.append(tokenizer.decode([tid]))
        text = " ".join(pieces)
        _, seg = parse_start_end_timestamps(text, duration)
        predictions.append(
            {"id": vid, "pred": seg, "gt": line["timestamps"], "text": text}
        )
        print(json.dumps(predictions[-1]))

    scores = score_rtl(predictions)
    print(json.dumps(scores))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"scores": scores, "predictions": predictions}, f)
    return {"scores": scores, "predictions": predictions}


if __name__ == "__main__":
    main()
