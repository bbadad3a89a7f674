"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its lines; the last line is the JSON status):

1. the card (`nvidia-smi` name and power limit) and the kernels' build:
   every `handsonvlm_torch/csrc/*.cu` compiled by nvcc for sm_90a;
2. each hand-written kernel against its plain PyTorch version at the main
   path's shapes, in bf16 and fp32, with kernel and plain times from CUDA
   events after warm-up;
3. the chat path: the 7B bf16 model from `random:7b` on the card, three
   chat requests through the chat CLI's own turn function (prefill +
   generate_host, 32 new tokens each; one turn forces a `<hand_traj>`
   input through the waypoint hook), with the kernels' launch counts
   checked against 32 x decode steps and 23 x CLIP calls;
4. the kernel path against the plain path at 7B: a greedy prefill and 4
   decode steps with attn_impl="auto" (kernels) and "xla" (plain), the
   same tokens fed to every run. The reference is the plain path with the
   weights cast to fp32. In bf16 the kernel path's final hidden states may
   lie at most 1.2x as far from that reference as the bf16 plain path's;
   in fp32 the kernel path lies within relative L2 1e-4 of it.

It exits non-zero, printing no result, when there is no CUDA device or
nvcc, and when any check fails: no phase catches its own failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from handsonvlm_torch.infer import sampler
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.infer.chat import chat_turn, frame_map_for, new_conversation, prompt_ids
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.llama import apply_llama, lm_logits
from handsonvlm_torch.ops import _build
from handsonvlm_torch.ops.decode_attention import (
    decode_attention_stacked,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref

# kernel vs plain version, max abs error (bf16 rounds p and the output;
# fp32 differs only in summation order)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# final hidden at 7B, relative L2 from the fp32 plain path: the fp32 kernel
# path at most FP32_REL_L2, the bf16 kernel path at most BF16_VS_PLAIN x
# the bf16 plain path's distance
FP32_REL_L2 = 1e-4
BF16_VS_PLAIN = 1.2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device_and_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    log(f"kernels built/loaded in {seconds:.2f} s: {lib._name}")
    log(_build.library_path().with_suffix(".log").read_text().strip())


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, dtype, rows):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    ok = finite and err <= TOL[dtype]
    rows.append(err)
    log(f"  {name} {str(dtype).split('.')[-1]}: max_abs_err={err:.3e} "
        f"(tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")


def check_decode_attention() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    L, B, S, H, K, D = 2, 1, 520, 32, 32, 128
    errs = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        ck = _rand(gen, (L, B, S, K, D), dtype)
        cv = _rand(gen, (L, B, S, K, D), dtype)
        q1 = _rand(gen, (B, 1, H, D), dtype)
        for length in (1, 31, 32, 33, 256, 450, 520):
            got = decode_attention_stacked(q1, ck, cv, 1, length)
            want = decode_attention_stacked_ref(q1, ck, cv, 1, length)
            _check(f"B1 T=1 len={length}", got, want, dtype, errs[dtype])
        # leading pad, an interior hole, a fully masked second row
        mask = torch.ones((2, S), dtype=torch.bool, device="cuda")
        mask[:, :7] = False
        mask[:, 100:140] = False
        mask[1] = False
        ck2 = _rand(gen, (L, 2, S, K, D), dtype)
        cv2 = _rand(gen, (L, 2, S, K, D), dtype)
        q2 = _rand(gen, (2, 1, H, D), dtype)
        got = decode_attention_stacked(q2, ck2, cv2, 0, 450, key_mask=mask)
        want = decode_attention_stacked_ref(q2, ck2, cv2, 0, 450, key_mask=mask)
        _check("B1 T=1 masked", got, want, dtype, errs[dtype])
        if bool(got[1].any()):
            raise AssertionError("B1: a row with no valid key must give 0")
        q4 = _rand(gen, (B, 4, H, D), dtype)
        got = decode_attention_stacked(q4, ck, cv, 1, 300, key_mask=mask[:1].clone())
        want = decode_attention_stacked_ref(q4, ck, cv, 1, 300, key_mask=mask[:1])
        _check("B1 T=4 masked", got, want, dtype, errs[dtype])
        # grouped-query heads
        ckg = _rand(gen, (L, B, S, 8, D), dtype)
        cvg = _rand(gen, (L, B, S, 8, D), dtype)
        got = decode_attention_stacked(q4, ckg, cvg, 0, 333)
        want = decode_attention_stacked_ref(q4, ckg, cvg, 0, 333)
        _check("B1 T=4 GQA H=32 K=8", got, want, dtype, errs[dtype])

    # time at the 7B decode shape: one layer, one query, length 450
    ck = _rand(gen, (L, B, S, K, D), torch.bfloat16)
    cv = _rand(gen, (L, B, S, K, D), torch.bfloat16)
    q1 = _rand(gen, (B, 1, H, D), torch.bfloat16)
    ms = cuda_time_ms(lambda: decode_attention_stacked(q1, ck, cv, 1, 450))
    plain_ms = cuda_time_ms(lambda: decode_attention_stacked_ref(q1, ck, cv, 1, 450))
    log(f"  B1 time (B=1 H=K=32 D=128 S=520 len=450 bf16): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return {
        "name": "decode_attention_stacked", "route": "cuda",
        "source": "handsonvlm_torch/csrc/decode_attention.cu",
        "replaces": "handsonvlm_tpu/ops/decode_attention.py:341",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms,
    }


def check_vit_attention() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (10, 257, 16, 64)
    errs = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (_rand(gen, shape, dtype) for _ in range(3))
        _check("B2 (10,257,16,64)", vit_attention(q, k, v), vit_attention_ref(q, k, v),
               dtype, errs[dtype])
        q, k, v = (_rand(gen, (3, 50, 4, 64), dtype) for _ in range(3))
        _check("B2 (3,50,4,64)", vit_attention(q, k, v), vit_attention_ref(q, k, v),
               dtype, errs[dtype])
    q, k, v = (_rand(gen, shape, torch.bfloat16) for _ in range(3))
    ms = cuda_time_ms(lambda: vit_attention(q, k, v))
    plain_ms = cuda_time_ms(lambda: vit_attention_ref(q, k, v))
    log(f"  B2 time ((10,257,16,64) bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {
        "name": "vit_attention", "route": "cuda",
        "source": "handsonvlm_torch/csrc/vit_attention.cu",
        "replaces": "handsonvlm_tpu/ops/vit_attention.py:83",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms,
    }


def phase_kernels() -> list:
    log("phase 2: kernels against their plain versions")
    return [check_decode_attention(), check_vit_attention()]


def _frames(cfg, seed: int = 0):
    """10 distinct CLIP-normalised 224 px frames and the slot map that tiles
    them x10 into the 100-frame interface (the chat CLI's rule)."""
    rng = np.random.default_rng(seed)
    n_unique = min(10, cfg.num_frames)
    size = cfg.vision.image_size
    video = rng.normal(size=(1, n_unique, 3, size, size)).astype(np.float32)
    return video, frame_map_for(n_unique, cfg.num_frames)


def phase_chat(model, cfg, tokenizer, video, frame_map) -> dict:
    """Three chat turns at 32 new tokens, temperature 0.5, top-p 0.9.

    Turns 1-2 run the chat CLI's turn function (prefill + generate_host).
    Turn 3 runs the same prefill and decode_step with <hand_traj> forced as
    the first token, so the waypoint hook (decode_hand_waypoint, then
    embed_next_token on the fed-back token) runs at 7B."""
    log("phase 3: 7B bf16 chat on the card")
    dev = next(model.parameters()).device
    new_tokens = 32
    conv = new_conversation()
    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {"prefill_ms": [], "decode_tok_s": []}
    decode_steps = clip_calls = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention_stacked.LAUNCHES = 0
    vit_attention.LAUNCHES = 0

    for text in ("What is the person doing in this video?",
                 "Where will the right hand move next?"):
        stamps = []
        t0 = time.perf_counter()
        out = chat_turn(model, cfg, tokenizer, conv, text, video, frame_map, gen,
                        max_new_tokens=new_tokens, temperature=0.5, top_p=0.9,
                        on_token=lambda _tok: stamps.append(time.perf_counter()))
        n = int(out.num_tokens[0])
        decode_steps += n - 1
        clip_calls += 1
        toks = out.sequences[0, :n]
        if n < 1 or toks.min() < 0 or toks.max() >= cfg.llama.vocab_size:
            raise AssertionError(f"turn produced bad tokens {toks}")
        stats["prefill_ms"].append((stamps[0] - t0) * 1e3)
        if len(stamps) > 1:
            stats["decode_tok_s"].append((len(stamps) - 1) / (stamps[-1] - stamps[0]))
        log(f"  turn {clip_calls}: {n} tokens, first-token {stats['prefill_ms'][-1]:.1f} ms: "
            f"{tokenizer.decode(toks)[:120]!r}")

    # turn 3: <hand_traj> forced into the cache
    ids = torch.as_tensor(
        prompt_ids(conv, tokenizer, "Predict the future trajectory of the hands."), device=dev)
    images = torch.as_tensor(video, device=dev)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + new_tokens + 1
    t0 = time.perf_counter()
    last_hidden, cache, cache_mask = sampler.prefill(
        model, cfg, ids, images, max_len, frame_map=frame_map)
    clip_calls += 1
    with torch.inference_mode():
        waypoint = decode_hand_waypoint(model, cfg, last_hidden, generator=gen)
    token = torch.full((1,), cfg.hand_token_id, dtype=torch.long, device=dev)
    waypoints = [waypoint.float().cpu().numpy()]
    stats["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    t1 = time.perf_counter()
    for _ in range(new_tokens - 1):
        token, waypoint, cache = sampler.decode_step(
            model, cfg, cache, cache_mask, token, waypoint, gen, temperature=0.5, top_p=0.9)
        decode_steps += 1
        if int(token[0]) == cfg.hand_token_id:
            waypoints.append(waypoint.float().cpu().numpy())
    torch.cuda.synchronize()
    stats["decode_tok_s"].append((new_tokens - 1) / (time.perf_counter() - t1))
    if not all(np.isfinite(w).all() for w in waypoints):
        raise AssertionError("non-finite waypoint from the hand hook")
    log(f"  turn 3: <hand_traj> forced, waypoint {waypoints[0].round(4).tolist()}, "
        f"{len(waypoints) - 1} more hand tokens sampled")

    launches = {"decode_attention_stacked": decode_attention_stacked.LAUNCHES,
                "vit_attention": vit_attention.LAUNCHES}
    n_layers, n_clip = cfg.llama.num_layers, cfg.vision.num_layers + cfg.vision.select_layer + 1
    log(f"  launches: decode_attention_stacked {launches['decode_attention_stacked']} "
        f"(expect {n_layers} x {decode_steps} decode steps), vit_attention "
        f"{launches['vit_attention']} (expect {n_clip} x {clip_calls} CLIP calls)")
    if launches["decode_attention_stacked"] != n_layers * decode_steps:
        raise AssertionError("decode attention kernel did not serve every layer of every step")
    if launches["vit_attention"] != n_clip * clip_calls:
        raise AssertionError("vit attention kernel did not serve every CLIP layer")
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill (first-token) ms per turn: {[round(x, 2) for x in stats['prefill_ms']]}")
    log(f"  decode tok/s per turn: {[round(x, 2) for x in stats['decode_tok_s']]}")
    log(f"  peak memory allocated: {peak / 2**30:.3f} GiB")
    return launches


def _greedy_decode(model, cfg, ids, images, frame_map, max_len, impl, fed=None):
    """Greedy prefill + 4 decode steps with attention `impl`; `fed` feeds
    another run's tokens instead of this run's own argmax. Returns (final
    hidden fp32, this run's own 5 greedy tokens)."""
    hidden, cache, mask = sampler.prefill(model, cfg, ids, images, max_len,
                                          attn_impl=impl, frame_map=frame_map)
    no_waypoint = torch.zeros((1, 2, 2), device=ids.device)
    greedy = []
    for step in range(5):
        tok = lm_logits(model.llama, cfg.llama, hidden).argmax(dim=-1)
        greedy.append(int(tok[0]))
        if step == 4:
            break
        feed = tok if fed is None else torch.tensor([fed[step]], device=ids.device)
        emb = embed_next_token(model, cfg, feed, no_waypoint)
        out, cache = apply_llama(model.llama, cfg.llama, inputs_embeds=emb[:, None],
                                 attn_mask=mask, kv_cache=cache, attn_impl=impl)
        hidden = out[:, 0]
    return hidden.float(), greedy


def phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map) -> None:
    """Greedy prefill + 4 decode steps with the kernels ("auto") and the
    plain versions ("xla") in the model's dtype, then with the same weights
    cast to fp32; every run is fed the first run's tokens.

    The fp32 plain path is the reference. A random-weight bf16 7B amplifies
    one rounding step many times over (on an H100 the bf16 kernel and plain
    paths end 3.6e-2 apart in relative L2), so the bf16 kernel path is held
    to the bf16 plain path's own distance from the reference, and the fp32
    kernel path to FP32_REL_L2."""
    log("phase 4: kernel path against plain path at 7B")
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    ids = torch.as_tensor(prompt_ids(new_conversation(), tokenizer, "What happens next?"),
                          device=dev)
    images = torch.as_tensor(video, device=dev)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + 8

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    name = str(dtype).split(".")[-1]
    with torch.inference_mode():
        args = (model, cfg, ids, images, frame_map, max_len)
        h_k, tok_k = _greedy_decode(*args, "auto")
        h_p, tok_p = _greedy_decode(*args, "xla", fed=tok_k)
        model.float()
        h_ref, tok_ref = _greedy_decode(*args, "xla", fed=tok_k)
        h_k32, tok_k32 = _greedy_decode(*args, "auto", fed=tok_k)
    d_k, d_p, d_32 = rel(h_k, h_ref), rel(h_p, h_ref), rel(h_k32, h_ref)
    log(f"  greedy tokens: {name} kernels {tok_k[:4]}, {name} plain {tok_p[:4]}, "
        f"fp32 plain {tok_ref[:4]}, fp32 kernels {tok_k32[:4]}")
    log(f"  {name} final hidden relative L2, kernels vs plain: {rel(h_k, h_p):.3e}")
    log(f"  final hidden relative L2 from the fp32 plain path: {name} kernels {d_k:.3e}, "
        f"{name} plain {d_p:.3e} (limit {BF16_VS_PLAIN} x that), fp32 kernels "
        f"{d_32:.3e} (limit {FP32_REL_L2:.0e})")
    if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
        raise AssertionError(f"{name} kernel path lies further from the fp32 reference "
                             f"than the {name} plain path")
    if not (np.isfinite(d_32) and d_32 <= FP32_REL_L2):
        raise AssertionError("fp32 kernel path disagrees with the fp32 plain path at 7B")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 1: card and build")
    phase_device_and_build()
    kernels = phase_kernels()

    t0 = time.perf_counter()
    model, cfg, tokenizer = load_pretrained_model("random:7b", "7b", "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"7B model (random:7b, seed 0) built on the card in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e9:.3f} B params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    video, frame_map = _frames(cfg)
    launches = phase_chat(model, cfg, tokenizer, video, frame_map)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
