"""Where a chat turn's time goes: torch.profiler over one prefill and a
window of decode steps, after a warm-up turn.

    python -m handsonvlm_torch.infer.profile [--quantize int4|int8|int8_fused] [--kv-int8] \
        [--preset 7b] [--device cuda] [--steps 16] [--spec K] [--prompt-rows N]

For each part it prints the host (wall) ms of a run without the profiler,
the device ms of a traced run (the sum of the kernels' own device time, so
no work is counted twice as an op and as its kernel), the device's busy
share (device over the untraced wall), the launches, and the kernels that
take the most device time; then one JSON line with the same numbers.
Random weights from the builder's seed, 10 distinct frames tiled into the
clip, the chat CLI's prompt. `--prompt-rows N` profiles a prompt of N rows
after the splice instead (random token ids around the image sentinel), so a
prefill of 2048 rows or more, which goes through the flash kernel, can be
traced. `--spec K` adds a third part: speculative verify forwards of K + 1
positions (every draft rejected, one token kept per forward, the cache
index set back each time), beside the one-token decode step they replace.
`--train` profiles a LoRA train step instead (r=128, alpha=256, remat
"full", batch 1, one synthetic sample of --prompt-rows rows, 2048 by
default; with --quantize the frozen base is int4, int8 or int8_fused (the
fused int8 + LoRA-epilogue kernels): QLoRA), after a warm-up step. `--device cpu` runs the same control flow on the CPU (no
device numbers) to rehearse it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from handsonvlm_torch.constants import IGNORE_INDEX
from handsonvlm_torch.infer import sampler
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.infer.chat import frame_map_for, new_conversation, prompt_ids
from handsonvlm_torch.infer.speculative import spec_verify
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.llama import apply_llama, lm_logits

TOP = 8  # kernels listed per part


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def random_video(cfg, seed: int = 0):
    """10 distinct CLIP-normalised frames (1, 10, 3, H, W) and the slot map
    that tiles them x10 into the 100-frame interface (the chat CLI's rule)."""
    rng = np.random.default_rng(seed)
    n_unique = min(10, cfg.num_frames)
    size = cfg.vision.image_size
    video = rng.normal(size=(1, n_unique, 3, size, size)).astype(np.float32)
    return video, frame_map_for(n_unique, cfg.num_frames)


def _measure(fn, device, activities, steps: int) -> dict:
    """Per step: the wall ms of fn() untraced, and from a traced fn() the
    device ms, busy share, launches and the top kernels (None off the card)."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if device.type != "cuda":
        return {"wall_ms": wall_ms, "device_ms": None, "busy": None, "launches": None,
                "top": []}
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "busy": device_ms / wall_ms,
        "launches": sum(e.count for e in kernels) / steps,
        "top": [(e.key[:60], e.count / steps, e.self_device_time_total / 1e3 / steps)
                for e in kernels[:TOP]],
    }


def train_batch(cfg, rows: int = 2048, seed: int = 0) -> dict:
    """One synthetic SFT sample of `rows` rows after the splice, laid out as
    the JAX package's train tests lay their batch out: the image sentinel
    at 1, <hand_traj> at 8, 10, 12 and 14, labels from position 7; 10
    unique frames and the slot map that tiles them into the video."""
    t = rows - cfg.num_visual_tokens + 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(1, t))
    ids[:, 1] = cfg.image_token_index
    ids[:, [8, 10, 12, 14]] = cfg.hand_token_id
    labels = np.where(np.arange(t) >= 7, ids, IGNORE_INDEX)
    video, frame_map = random_video(cfg, seed)
    return {"input_ids": ids, "attn_mask": np.ones((1, t), bool), "image": video,
            "frame_map": frame_map, "labels": labels,
            "future_hands": rng.uniform(size=(1, 2, 5, 2)).astype(np.float32),
            "future_valid": np.ones((1, 2), np.float32)}


def profile_train(model, cfg, device, rows: int, quantize) -> None:
    """One LoRA train step (the frozen base as loaded), traced after a
    warm-up step: wall and device ms, busy share, launches, top kernels and
    peak device memory."""
    from handsonvlm_torch.models.lora import init_lora
    from handsonvlm_torch.train.step import make_train_step
    from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

    batch = train_batch(cfg, rows)
    model.lora = init_lora(torch.Generator(device=device).manual_seed(1), cfg.llama, 128,
                           256.0, device=device)
    opt = make_optimizer(model, 2e-5, freeze_top_keys=("vision", "llama"))
    step = make_train_step(cfg, opt, attn_impl="auto", remat="full")
    state = create_train_state(model, opt)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    step(state, batch, 0)  # warm-up
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    s = _measure(lambda: step(state, batch, 0), device, activities, 1)
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    dev = (f"device {s['device_ms']:.3f} ms, busy {100 * s['busy']:.1f}%, "
           f"{s['launches']:.0f} launches, peak {peak:.3f} GiB" if on_card
           else "device not measured")
    print(f"train step (LoRA r=128, remat full, base quantize={quantize}) on {name}, "
          f"{rows} rows: wall {s['wall_ms']:.3f} ms, {rows / s['wall_ms'] * 1e3:.1f} "
          f"tokens/s, {dev}")
    for key, count, ms in s["top"]:
        print(f"    {ms:9.4f} ms  x{count:g}  {key}")
    print(json.dumps({"device": name, "quantize": quantize, "rows": rows,
                      "train_step": s, "peak_gib": peak}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="7b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", choices=["int4", "int8", "int8_fused"], default=None)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--steps", type=int, default=16, help="decode steps traced")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="also trace verify forwards of K + 1 positions")
    ap.add_argument("--prompt-rows", type=int, default=0, metavar="N",
                    help="rows of the prompt after the splice (0: the chat prompt)")
    ap.add_argument("--train", action="store_true",
                    help="profile a LoRA / QLoRA train step instead")
    args = ap.parse_args()
    device = torch.device(args.device)
    kv_quant = "int8" if args.kv_int8 else None

    model, cfg, tokenizer = load_pretrained_model(f"random:{args.preset}", args.preset,
                                                  device, quantize=args.quantize)
    if args.train:
        profile_train(model, cfg, device, args.prompt_rows or 2048, args.quantize)
        return
    video, frame_map = random_video(cfg)
    images = torch.as_tensor(video, device=device)
    if args.prompt_rows:
        n_text = args.prompt_rows - cfg.num_visual_tokens + 1
        if n_text < 2:
            raise ValueError(f"--prompt-rows must be at least {cfg.num_visual_tokens + 1}")
        ids_np = np.random.default_rng(0).integers(3, 1000, size=(1, n_text))
        ids_np[0, 1] = cfg.image_token_index
        ids = torch.as_tensor(ids_np, device=device)
    else:
        ids = torch.as_tensor(prompt_ids(new_conversation(), tokenizer,
                                         "What is the person doing in this video?"),
                              device=device)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + 2 * args.steps + 4 + args.spec
    gen = torch.Generator(device=device).manual_seed(0)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])

    def run_prefill():
        return sampler.prefill(model, cfg, ids, images, max_len, frame_map=frame_map,
                               kv_quant=kv_quant)

    def run_decode(steps):
        """A function that runs the next `steps` decode steps over one
        fresh prefill's cache (the prefill runs here, before any clock)."""
        _, cache, mask = run_prefill()
        token = torch.zeros((1,), dtype=torch.long, device=device)
        waypoint = torch.zeros((1, 2, 2), device=device)

        def steps_fn():
            nonlocal token, waypoint, cache
            for _ in range(steps):
                token, waypoint, cache = sampler.decode_step(
                    model, cfg, cache, mask, token, waypoint, gen, temperature=0.5,
                    top_p=0.9)
        return steps_fn

    def run_verify(steps):
        """As run_decode, for verify forwards of --spec + 1 positions whose
        drafts are all rejected: what generate_spec runs per forward."""
        _, cache, mask = run_prefill()
        token = torch.zeros((1,), dtype=torch.long, device=device)
        waypoint = torch.zeros((1, 2, 2), device=device)
        draft = torch.zeros((args.spec,), dtype=torch.long, device=device)

        def steps_fn():
            nonlocal token, waypoint, cache
            for _ in range(steps):
                e0 = embed_next_token(model, cfg, token, waypoint)
                embs = torch.cat([e0, model.llama.embed_tokens(draft)])[None]
                index = cache.index
                hidden, cache = apply_llama(model.llama, cfg.llama, inputs_embeds=embs,
                                            attn_mask=mask, kv_cache=cache)
                logits = lm_logits(model.llama, cfg.llama, hidden)[0]
                emitted, _ = spec_verify(logits, draft, 0.5, 0.9, cfg.hand_token_id,
                                         sampler.EOS_TOKEN_ID, generator=gen)
                cache.index = index + 1
                waypoint = decode_hand_waypoint(model, cfg, hidden[0, :1], generator=gen)
                token = torch.as_tensor(emitted[:1], device=device).long()
        return steps_fn

    with torch.inference_mode():
        run_decode(4)()  # warm-up: the first use of every kernel and library call
        prefill = _measure(run_prefill, device, activities, 1)
        # two windows of steps from one prefill: untraced, then traced
        decode = _measure(run_decode(args.steps), device, activities, args.steps)
        verify = None
        if args.spec:
            run_verify(2)()
            verify = _measure(run_verify(args.steps), device, activities, args.steps)

    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    print(f"{args.preset} quantize={args.quantize} kv_quant={kv_quant} on {name}, "
          f"prompt {ids.shape[1] + cfg.num_visual_tokens - 1} rows after the splice")
    parts = [("prefill (CLIP + decoder)", prefill), ("decode step", decode)]
    if verify is not None:
        parts.append((f"verify forward (k={args.spec})", verify))
    for part, s in parts:
        dev = (f"device {s['device_ms']:.3f} ms, busy {100 * s['busy']:.1f}%, "
               f"{s['launches']:.0f} launches" if on_card else "device not measured")
        print(f"{part}: wall {s['wall_ms']:.3f} ms, {dev}")
        for key, count, ms in s["top"]:
            print(f"    {ms:9.4f} ms  x{count:g}  {key}")
    print(json.dumps({"device": name, "preset": args.preset, "quantize": args.quantize,
                      "kv_quant": kv_quant, "prefill": prefill, "decode_step": decode,
                      "verify_forward": verify}))


if __name__ == "__main__":
    main()
