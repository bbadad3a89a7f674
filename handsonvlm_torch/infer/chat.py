"""Interactive chat CLI with hand-trajectory decoding.

Port of `handsonvlm_tpu/infer/chat.py`: load an image or mp4, chat until
the model emits <hand_traj> tokens, then render the predicted trajectory.

Usage:
  python -m handsonvlm_torch.infer.chat --model-path random:7b --preset 7b \
      --path frame.jpg --device cuda [--int8 | --int4] [--kv-int8] [--spec K]

`--int8` runs the decoder with int8 weights (one scale per output column)
and `--int4` with int4 weights (group 128), both with an int8 head; `--int8`
wins when both are given, as in the JAX package. `--kv-int8` decodes over
the int8 cache; `--spec K` decodes speculatively with K-token n-gram drafts
from the answer-template bank (infer/speculative.py), alone or with the
quantized modes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from handsonvlm_torch.constants import DEFAULT_IMAGE_TOKEN
from handsonvlm_torch.data.conversation import conv_templates
from handsonvlm_torch.data.tokenization import tokenizer_image_token
from handsonvlm_torch.data.video_io import load_image, load_video
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.infer.sampler import SampleOutput, clip_pred_hands, generate_host
from handsonvlm_torch.infer.speculative import build_template_bank, generate_spec
from handsonvlm_torch.infer.viz import create_trajectory_video

def load_frames(path: str, cfg):
    """Image or mp4 -> (video (1, U, 3, S, S) float32, frame_map, frame_paths).

    Up to 10 unique frames, tiled through `frame_map` to fill the
    `num_frames` interface (only the unique frames go through CLIP)."""
    size = cfg.vision.image_size
    n_unique = min(10, cfg.num_frames)
    if path.endswith((".png", ".jpg", ".jpeg")):
        frame = load_image(path, cache_dir=None, size=size)
        frames = np.tile(frame[None], (n_unique, 1, 1, 1))
        frame_paths = [path] * n_unique
    elif path.endswith(".mp4"):
        frames = load_video(path, num_frames=n_unique, size=size)
        frame_paths = [path]
    else:
        raise ValueError(f"unsupported input {path}")
    return (frames[None].astype(np.float32), frame_map_for(frames.shape[0], cfg.num_frames),
            frame_paths)


def frame_map_for(n_unique: int, num_frames: int) -> np.ndarray:
    """Video slot -> unique frame: tiled when n_unique divides num_frames,
    else evenly spread."""
    if num_frames % n_unique:
        return np.round(np.linspace(0, n_unique - 1, num_frames)).astype(np.int64)
    return np.tile(np.arange(n_unique, dtype=np.int64), num_frames // n_unique)


def new_conversation():
    """An empty Vicuna v1 conversation, the template the chat CLI uses."""
    return conv_templates["v1"].copy()


def prompt_ids(conv, tokenizer, user_input: str) -> np.ndarray:
    """Append a user turn (with the image token on the first turn) and an
    open assistant turn to `conv`; return the prompt's ids (1, T) int64."""
    if not conv.messages:
        user_input = DEFAULT_IMAGE_TOKEN + "\n" + user_input
    conv.append_message(conv.roles[0], user_input)
    conv.append_message(conv.roles[1], None)
    return np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)[None]


def chat_turn(model, cfg, tokenizer, conv, user_input: str, video, frame_map,
              generator, *, max_new_tokens: int, temperature: float, top_p: float,
              on_token=None, kv_quant=None, spec_k: int = 0, bank_ids=None,
              gate_tok_per_fwd: float = 1.2, spec_stats=None) -> SampleOutput:
    """One user turn: append it, generate the reply and record it in `conv`.

    `spec_k` > 0 decodes speculatively with `spec_k`-token drafts; the
    draft bank is `bank_ids`, or when None the answer templates filled with
    this turn's text. `spec_stats`, a dict, receives that run's stats."""
    ids = prompt_ids(conv, tokenizer, user_input)
    if spec_k > 0:
        if bank_ids is None:
            bank_ids = build_template_bank(tokenizer, cfg, (user_input,))
        out, stats = generate_spec(
            model, cfg, ids, video, generator, max_new_tokens=max_new_tokens, k=spec_k,
            temperature=temperature, top_p=top_p, frame_map=frame_map, bank_ids=bank_ids,
            on_token=on_token, kv_quant=kv_quant, gate_tok_per_fwd=gate_tok_per_fwd)
        if spec_stats is not None:
            spec_stats.update(stats)
    else:
        # stop on the conv separator like the reference cli's KeywordsStoppingCriteria
        stop_str = conv.sep2 if conv.sep2 else conv.sep
        out = generate_host(
            model, cfg, ids, video, generator, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p, frame_map=frame_map,
            on_token=on_token, stop_strs=[stop_str] if stop_str else None,
            tokenizer=tokenizer, kv_quant=kv_quant)
    n = int(out.num_tokens[0])
    conv.messages[-1][1] = tokenizer.decode(out.sequences[0, :n])
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--preset", default="7b")
    p.add_argument("--path", required=True, help="image (.jpg/.png) or video (.mp4)")
    p.add_argument("--output-video", default="./trajectory.mp4")
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--max-new-tokens", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--int8", action="store_true", help="int8 weight-only decoder")
    p.add_argument("--int4", action="store_true", help="int4 (group-128) weight-only decoder")
    p.add_argument("--kv-int8", action="store_true", help="int8-quantized decode cache")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decode with K-token n-gram drafts")
    args = p.parse_args()

    model, cfg, tokenizer = load_pretrained_model(
        args.model_path, args.preset, args.device,
        quantize="int8" if args.int8 else ("int4" if args.int4 else None))
    kv_quant = "int8" if args.kv_int8 else None
    video, frame_map, frame_paths = load_frames(args.path, cfg)
    conv = new_conversation()
    generator = torch.Generator(device=args.device).manual_seed(0)
    while True:
        try:
            user_input = input(f"{conv.roles[0]}: ")
        except EOFError:
            user_input = ""
        if not user_input:
            print("exit...")
            return
        print(f"{conv.roles[1]}: ", end="", flush=True)

        def stream(tok_id):
            print(tokenizer.decode([tok_id]), end=" ", flush=True)

        stats = {}
        out = chat_turn(model, cfg, tokenizer, conv, user_input, video, frame_map,
                        generator, max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, top_p=args.top_p,
                        on_token=None if args.spec else stream, kv_quant=kv_quant,
                        spec_k=args.spec, spec_stats=stats)
        if args.spec:  # the speculative reply is printed whole, with its yield
            print(conv.messages[-1][1], f"  [{stats['tokens']} tok / {stats['iters']} fwd]",
                  end="")
        print()
        pred, valid = clip_pred_hands(out.pred_hands, out.num_hands)
        if valid[0]:
            if frame_paths[0].endswith(".mp4"):
                print("trajectory predicted; video overlay requires frame input")
            else:
                path = create_trajectory_video(frame_paths, pred[0], args.output_video)
                print(f"trajectory video written to {path}")
            return


if __name__ == "__main__":
    main()
