"""Run the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its lines; the last line is the JSON status):

1. the card (`nvidia-smi` name and power limit) and the kernels' build:
   every `handsonvlm_torch/csrc/*.cu` compiled by nvcc for sm_90a;
2. each hand-written kernel against its plain PyTorch version at the main
   paths' shapes, with kernel, plain and library times from CUDA events
   after warm-up, and the least time the card could take (`bound_ms`);
3. the bf16 chat path: the 7B bf16 model from `random:7b` on the card, three
   chat requests through the chat CLI's own turn function (prefill +
   generate_host, 32 new tokens each; one turn forces a `<hand_traj>`
   input through the waypoint hook), with the kernels' launch counts
   checked against the decode steps and CLIP calls;
4. the bf16 kernel path against the plain path at 7B: a greedy prefill and
   4 decode steps with attn_impl="auto" (kernels) and "xla" (plain), the
   same tokens fed to every run. The reference is the plain path with the
   weights cast to fp32. In bf16 the kernel path's final hidden states may
   lie at most 1.2x as far from that reference as the bf16 plain path's;
   in fp32 the kernel path lies within relative L2 1e-4 of it;
5. the quantized chat path: `random:7b` with int4 weights and an int8 head
   (quantize="int4") and the int8 KV cache (kv_quant="int8"), the same
   three requests, with the launch counts of the int4 GEMV, the int4
   prefill matmul and int8-cache decode attention checked exactly;
6. the quantized kernel path against the quantized plain path at 7B, fed
   phase 4's tokens. The reference is the plain path with the int4 weights
   dequantized to fp32 in an fp32 model, over the int8 cache; the bf16
   kernel path may lie at most 1.2x as far from it as the bf16 plain path.

It exits non-zero, printing no result, when there is no CUDA device or
nvcc, and when any check fails: no phase catches its own failure.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from handsonvlm_torch.infer import sampler
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.config import get_config
from handsonvlm_torch.infer.chat import chat_turn, new_conversation, prompt_ids
from handsonvlm_torch.infer.profile import random_video
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.llama import (
    _quantize_kv_rows,
    apply_llama,
    dequantize_llama_int4,
    int4_projection_shapes,
    lm_logits,
)
from handsonvlm_torch.ops import _build
from handsonvlm_torch.ops.decode_attention import (
    decode_attention_stacked,
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.ops.int8_matmul import (
    dequantize_tiled,
    int4_gemv_tiled,
    int4_gemv_tiled_ref,
    int4_matmul_prefill_tiled,
    int4_matmul_prefill_tiled_ref,
    quantize_int4,
    tile_int4_stacked,
)
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref

# kernel vs plain version, max abs error for attention (bf16 rounds p and
# the output; fp32 differs only in summation order)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the int4 matmuls: a share of max|y|, plus in bf16 one rounding step of the
# element (both sides round f32 sums taken in another order to bf16)
INT4_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# final hidden at 7B, relative L2 from the fp32 plain path: the fp32 kernel
# path at most FP32_REL_L2, the bf16 kernel path at most BF16_VS_PLAIN x
# the bf16 plain path's distance
FP32_REL_L2 = 1e-4
BF16_VS_PLAIN = 1.2
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
# the 7B chat prompt after the splice (turn 1 of phase 3 in earlier runs)
PREFILL_ROWS = 391
DECODE_LEN = 450  # cache positions attended by a mid-answer decode step
TIMING_LAYERS = 4  # weights cycled while timing, so each launch finds L2 cold
SPIN_CYCLES = 200_000_000  # ~0.1 s of the card's clock ahead of a timed loop

# every kernel wrapper by the name chip_smoke reports it under
WRAPPERS = {"decode_attention_stacked": decode_attention_stacked,
            "vit_attention": vit_attention, "int4_gemv_tiled": int4_gemv_tiled,
            "int4_matmul_prefill_tiled": int4_matmul_prefill_tiled,
            "decode_attention_stacked_q": decode_attention_stacked_q}


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms of fn(i) over `iters` calls, by CUDA events after
    warm-up. The card first spins for a while (torch.cuda._sleep), so the
    host has queued every call before the start event runs: the time is the
    device's, not the host's launch rate."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the (bf16) operations over the tensor cores' peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _check_int4(name, got, want, dtype, rows):
    got, want = got.float(), want.float()
    ymax = float(want.abs().max())
    err = (got - want).abs()
    limit = INT4_TOL[dtype] * ymax
    if dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * want.abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    rows.append(float(err.max()))
    log(f"  {name} {str(dtype).split('.')[-1]}: max_abs_err={rows[-1]:.3e} "
        f"= {rows[-1] / ymax:.2e} x max|y| (tol {INT4_TOL[dtype]:.0e} x max|y|"
        f"{' + one bf16 step' if dtype == torch.bfloat16 else ''}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")


def _sdpa(q, k, v):
    """scaled_dot_product_attention on (B, T, H, D) layouts (views)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2))


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

    # time at the 7B decode shape: one query, length 450, the layers cycled
    # (16 x 8.5 MB of cache: each launch finds its layer outside L2)
    Lt, n = 16, DECODE_LEN
    ck = _rand(gen, (Lt, B, S, K, D), torch.bfloat16)
    cv = _rand(gen, (Lt, B, S, K, D), torch.bfloat16)
    q1 = _rand(gen, (B, 1, H, D), torch.bfloat16)
    ms = cuda_time_ms(lambda i: decode_attention_stacked(q1, ck, cv, i % Lt, n))
    plain_ms = cuda_time_ms(lambda i: decode_attention_stacked_ref(q1, ck, cv, i % Lt, n),
                            iters=20)
    library_ms = cuda_time_ms(
        lambda i: _sdpa(q1, ck[i % Lt, :, :n], cv[i % Lt, :, :n]))
    bound_ms, bound_by = bound(2 * n * K * D * 2 + 2 * H * D * 2, 4 * n * H * D)
    log(f"  B1 time (B=1 H=K=32 D=128 S=520 len={n} bf16, {Lt} layers cycled): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "decode_attention_stacked", "route": "cuda",
        "source": "handsonvlm_torch/csrc/decode_attention.cu",
        "replaces": "handsonvlm_tpu/ops/decode_attention.py:341",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
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
    ms = cuda_time_ms(lambda i: vit_attention(q, k, v))
    plain_ms = cuda_time_ms(lambda i: vit_attention_ref(q, k, v), iters=20)
    library_ms = cuda_time_ms(lambda i: _sdpa(q, k, v))
    b, t, h, d = shape
    bound_ms, bound_by = bound(4 * b * t * h * d * 2, 4 * b * h * t * t * d)
    log(f"  B2 time ((10,257,16,64) bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "vit_attention", "route": "cuda",
        "source": "handsonvlm_torch/csrc/vit_attention.cu",
        "replaces": "handsonvlm_tpu/ops/vit_attention.py:83",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_decode_attention_q() -> dict:
    """B6 over an int8 cache made by the decoder's own row quantizer."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    L, B, S, H, K, D = 2, 1, 520, 32, 32, 128

    def cache(b, k, layers=L):
        k8, ks = _quantize_kv_rows(_rand(gen, (layers, b, S, k, D), torch.bfloat16))
        v8, vs = _quantize_kv_rows(_rand(gen, (layers, b, S, k, D), torch.bfloat16))
        return k8, v8, ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()

    errs = {torch.bfloat16: [], torch.float32: []}
    c1, c2, cg = cache(B, K), cache(2, K), cache(B, 8)
    mask = torch.ones((2, S), dtype=torch.bool, device="cuda")
    mask[:, :7] = False
    mask[:, 100:140] = False
    mask[1] = False
    for dtype in (torch.bfloat16, torch.float32):
        q1 = _rand(gen, (B, 1, H, D), dtype)
        for length in (1, 33, 450, 520):
            got = decode_attention_stacked_q(q1, *c1, 1, length)
            want = decode_attention_stacked_q_ref(q1, *c1, 1, length)
            _check(f"B6 T=1 len={length}", got, want, dtype, errs[dtype])
        q2 = _rand(gen, (2, 1, H, D), dtype)
        got = decode_attention_stacked_q(q2, *c2, 0, 450, key_mask=mask)
        want = decode_attention_stacked_q_ref(q2, *c2, 0, 450, key_mask=mask)
        _check("B6 T=1 masked", got, want, dtype, errs[dtype])
        if bool(got[1].any()):
            raise AssertionError("B6: a row with no valid key must give 0")
        q4 = _rand(gen, (B, 4, H, D), dtype)
        got = decode_attention_stacked_q(q4, *c1, 1, 300, key_mask=mask[:1].clone())
        want = decode_attention_stacked_q_ref(q4, *c1, 1, 300, key_mask=mask[:1])
        _check("B6 T=4 masked", got, want, dtype, errs[dtype])
        got = decode_attention_stacked_q(q4, *cg, 0, 333)
        want = decode_attention_stacked_q_ref(q4, *cg, 0, 333)
        _check("B6 T=4 GQA H=32 K=8", got, want, dtype, errs[dtype])

    Lt, n = 16, DECODE_LEN
    ct = cache(B, K, Lt)
    q1 = _rand(gen, (B, 1, H, D), torch.bfloat16)
    ms = cuda_time_ms(lambda i: decode_attention_stacked_q(q1, *ct, i % Lt, n))
    plain_ms = cuda_time_ms(lambda i: decode_attention_stacked_q_ref(q1, *ct, i % Lt, n),
                            iters=20)
    bound_ms, bound_by = bound(2 * n * K * D + 2 * n * K * 4 + 2 * H * D * 2, 4 * n * H * D)
    log(f"  B6 time (B=1 H=K=32 D=128 S=520 len={n}, int8 cache, bf16 q, {Lt} layers "
        f"cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "decode_attention_stacked_q", "route": "cuda",
        "source": "handsonvlm_torch/csrc/decode_attention.cu",
        "replaces": "handsonvlm_tpu/ops/decode_attention.py:341",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def _int4_stack(din, dout, layers, gen):
    """Random weights at the 7B init scale, quantized and tiled as
    quantize_llama_int4 does: (w4t, gst) stacked over `layers`."""
    packed = [quantize_int4(0.02 * torch.randn((din, dout), generator=gen, device="cuda"))
              for _ in range(layers)]
    return tile_int4_stacked(torch.stack([p[0] for p in packed]),
                             torch.stack([p[1] for p in packed]))


def _int4_kernel(name, wrapper, ref, rows_checked, rows_timed, seed) -> dict:
    """Check `wrapper` against `ref` at the four 7B projections for each m
    in rows_checked (bf16 and fp32), then time kernel, plain and a bf16
    torch.mm over the dequantized weight (another function: the weight is
    not int4) at m = rows_timed, cycling over TIMING_LAYERS layers."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = int4_projection_shapes(get_config("7b").llama)
    errs = {torch.bfloat16: [], torch.float32: []}
    ms = plain_ms = mm_ms = bound_bytes = flops = 0.0
    for proj, (din, dout) in shapes.items():
        w4t, gst = _int4_stack(din, dout, TIMING_LAYERS, gen)
        for dtype in (torch.bfloat16, torch.float32):
            for m in rows_checked:
                x = _rand(gen, (1, m, din), dtype)
                _check_int4(f"{name} {proj} {din}->{dout} m={m}",
                            wrapper(x, w4t, gst, m % TIMING_LAYERS),
                            ref(x, w4t, gst, m % TIMING_LAYERS), dtype, errs[dtype])
        m, Lt = rows_timed, TIMING_LAYERS
        x = _rand(gen, (1, m, din), torch.bfloat16)
        w_dense = [dequantize_tiled(w4t, gst, i).to(torch.bfloat16) for i in range(Lt)]
        t_k = cuda_time_ms(lambda i: wrapper(x, w4t, gst, i % Lt))
        t_p = cuda_time_ms(lambda i: ref(x, w4t, gst, i % Lt), iters=10, warmup=2)
        t_mm = cuda_time_ms(lambda i: torch.mm(x[0], w_dense[i % Lt]))
        nbytes = w4t[0].numel() + gst[0].numel() * 4 + m * (din + dout) * 2
        log(f"  {name} time {proj} ({din}->{dout}, m={m}, bf16, {Lt} layers cycled): "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{bound(nbytes, 2 * m * din * dout)[0]:.4f} ms; "
            f"torch.mm over the bf16 dequantized weight (a different function) {t_mm:.4f} ms")
        ms, plain_ms, mm_ms = ms + t_k, plain_ms + t_p, mm_ms + t_mm
        bound_bytes += nbytes
        flops += 2 * m * din * dout
        del w4t, gst, w_dense
    bound_ms, bound_by = bound(bound_bytes, flops)
    log(f"  {name}: the four projections of one layer at m={rows_timed}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms ({bound_by}); "
        f"bf16 torch.mm (different function) {mm_ms:.4f} ms")
    return {"max_abs_err": max(errs[torch.bfloat16]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_int4_gemv() -> dict:
    row = _int4_kernel("B4b", int4_gemv_tiled, int4_gemv_tiled_ref, (1, 8, 127), 1, 4)
    return {"name": "int4_gemv_tiled", "route": "cuda",
            "source": "handsonvlm_torch/csrc/int4_gemv.cu",
            "replaces": "handsonvlm_tpu/ops/int8_matmul.py:469", **row}


def check_int4_prefill() -> dict:
    row = _int4_kernel("B5b", int4_matmul_prefill_tiled, int4_matmul_prefill_tiled_ref,
                       (128, PREFILL_ROWS, 500), PREFILL_ROWS, 5)
    return {"name": "int4_matmul_prefill_tiled", "route": "cuda",
            "source": "handsonvlm_torch/csrc/int4_prefill.cu",
            "replaces": "handsonvlm_tpu/ops/int8_matmul.py:704", **row}


def phase_kernels() -> list:
    log("phase 2: kernels against their plain versions")
    return [check_decode_attention(), check_vit_attention(), check_int4_gemv(),
            check_int4_prefill(), check_decode_attention_q()]


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.LAUNCHES = 0


def read_launches() -> dict:
    return {name: fn.LAUNCHES for name, fn in WRAPPERS.items()}


def phase_chat(model, cfg, tokenizer, video, frame_map, kv_quant=None, new_tokens=32) -> dict:
    """Three chat turns, temperature 0.5, top-p 0.9; `kv_quant="int8"`
    decodes over the int8 cache.

    Turns 1-2 run the chat CLI's turn function (prefill + generate_host).
    Turn 3 runs the same prefill and decode_step with <hand_traj> forced as
    the first token, so the waypoint hook (decode_hand_waypoint, then
    embed_next_token on the fed-back token) runs. Every kernel's launch
    count is set to 0 before the turns and read after them. Returns the
    counts with the decode steps, prefills and CLIP calls run."""
    dev = model.llama.embed_tokens.weight.device
    conv = new_conversation()
    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {"prefill_ms": [], "decode_tok_s": []}
    decode_steps = prefills = 0

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()

    for text in ("What is the person doing in this video?",
                 "Where will the right hand move next?"):
        stamps = []
        t0 = time.perf_counter()
        out = chat_turn(model, cfg, tokenizer, conv, text, video, frame_map, gen,
                        max_new_tokens=new_tokens, temperature=0.5, top_p=0.9,
                        on_token=lambda _tok: stamps.append(time.perf_counter()),
                        kv_quant=kv_quant)
        n = int(out.num_tokens[0])
        decode_steps += n - 1
        prefills += 1
        toks = out.sequences[0, :n]
        if n < 1 or toks.min() < 0 or toks.max() >= cfg.llama.vocab_size:
            raise AssertionError(f"turn produced bad tokens {toks}")
        stats["prefill_ms"].append((stamps[0] - t0) * 1e3)
        if len(stamps) > 1:
            stats["decode_tok_s"].append((len(stamps) - 1) / (stamps[-1] - stamps[0]))
        log(f"  turn {prefills}: {n} tokens, first-token {stats['prefill_ms'][-1]:.1f} ms: "
            f"{tokenizer.decode(toks)[:120]!r}")

    # turn 3: <hand_traj> forced into the cache
    ids = torch.as_tensor(
        prompt_ids(conv, tokenizer, "Predict the future trajectory of the hands."), device=dev)
    images = torch.as_tensor(video, device=dev)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + new_tokens + 1
    t0 = time.perf_counter()
    last_hidden, cache, cache_mask = sampler.prefill(
        model, cfg, ids, images, max_len, frame_map=frame_map, kv_quant=kv_quant)
    prefills += 1
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
    _sync(dev)
    stats["decode_tok_s"].append((new_tokens - 1) / (time.perf_counter() - t1))
    if not all(np.isfinite(w).all() for w in waypoints):
        raise AssertionError("non-finite waypoint from the hand hook")
    log(f"  turn 3: <hand_traj> forced, waypoint {waypoints[0].round(4).tolist()}, "
        f"{len(waypoints) - 1} more hand tokens sampled")

    counts = read_launches()
    log(f"  prefill (first-token) ms per turn: {[round(x, 2) for x in stats['prefill_ms']]}")
    log(f"  decode tok/s per turn: {[round(x, 2) for x in stats['decode_tok_s']]}")
    if dev.type == "cuda":
        log(f"  peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"launches": counts, "decode_steps": decode_steps, "prefills": prefills,
            "clip_calls": prefills}


def check_launches(run: dict, expect_per: dict) -> None:
    """Every kernel's count from a chat phase against its expectation:
    expect_per maps a kernel to (launches per unit, unit name)."""
    for name in WRAPPERS:
        per, unit = expect_per.get(name, (0, "decode_steps"))
        want = per * run[unit]
        got = run["launches"][name]
        log(f"  launches {name}: {got} (expect {per} x {run[unit]} {unit})")
        if got != want:
            raise AssertionError(f"{name} launched {got} times, expected {want}")


def _greedy_decode(model, cfg, ids, images, frame_map, max_len, impl, fed=None,
                   kv_quant=None):
    """Greedy prefill + 4 decode steps with attention `impl`; `fed` feeds
    another run's tokens instead of this run's own argmax. Returns (final
    hidden fp32, this run's own 5 greedy tokens)."""
    hidden, cache, mask = sampler.prefill(model, cfg, ids, images, max_len,
                                          attn_impl=impl, frame_map=frame_map,
                                          kv_quant=kv_quant)
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


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _greedy_args(model, cfg, tokenizer, video, frame_map):
    dev = model.llama.embed_tokens.weight.device
    ids = torch.as_tensor(prompt_ids(new_conversation(), tokenizer, "What happens next?"),
                          device=dev)
    images = torch.as_tensor(video, device=dev)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + 8
    return model, cfg, ids, images, frame_map, max_len


def phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map):
    """Greedy prefill + 4 decode steps with the kernels ("auto") and the
    plain versions ("xla") in the model's dtype, then with the same weights
    cast to fp32; every run is fed the first run's tokens. Leaves the model
    in fp32. Returns (the kernel path's final hidden, its greedy tokens).

    The fp32 plain path is the reference. A random-weight bf16 7B amplifies
    one rounding step many times over (on an H100 the bf16 kernel and plain
    paths end 3.6e-2 apart in relative L2), so the bf16 kernel path is held
    to the bf16 plain path's own distance from the reference, and the fp32
    kernel path to FP32_REL_L2."""
    dtype = model.llama.embed_tokens.weight.dtype
    name = str(dtype).split(".")[-1]
    with torch.inference_mode():
        args = _greedy_args(model, cfg, tokenizer, video, frame_map)
        h_k, tok_k = _greedy_decode(*args, "auto")
        h_p, tok_p = _greedy_decode(*args, "xla", fed=tok_k)
        model.float()
        h_ref, tok_ref = _greedy_decode(*args, "xla", fed=tok_k)
        h_k32, tok_k32 = _greedy_decode(*args, "auto", fed=tok_k)
    d_k, d_p, d_32 = _rel(h_k, h_ref), _rel(h_p, h_ref), _rel(h_k32, h_ref)
    log(f"  greedy tokens: {name} kernels {tok_k[:4]}, {name} plain {tok_p[:4]}, "
        f"fp32 plain {tok_ref[:4]}, fp32 kernels {tok_k32[:4]}")
    log(f"  {name} final hidden relative L2, kernels vs plain: {_rel(h_k, h_p):.3e}")
    log(f"  final hidden relative L2 from the fp32 plain path: {name} kernels {d_k:.3e}, "
        f"{name} plain {d_p:.3e} (limit {BF16_VS_PLAIN} x that), fp32 kernels "
        f"{d_32:.3e} (limit {FP32_REL_L2:.0e})")
    if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
        raise AssertionError(f"{name} kernel path lies further from the fp32 reference "
                             f"than the {name} plain path")
    if not (np.isfinite(d_32) and d_32 <= FP32_REL_L2):
        raise AssertionError("fp32 kernel path disagrees with the fp32 plain path")
    return h_k, tok_k


def phase_quant_kernel_vs_plain(model, cfg, tokenizer, video, frame_map, fed=None,
                                h_dense=None) -> None:
    """The int4 + int8-cache path: greedy prefill + 4 decode steps with the
    kernels ("auto") and the plain versions ("xla") in the model's dtype,
    then with the int4 weights dequantized into an fp32 model (plain path,
    the reference). All runs decode over the int8 cache and are fed `fed`
    (else the first run's own tokens). The kernel path may lie at most
    BF16_VS_PLAIN x as far from the reference as the plain path. `h_dense`,
    the dense model's final hidden for the same tokens, is compared for
    information only. Leaves the model dense fp32."""
    dtype = model.llama.embed_tokens.weight.dtype
    name = str(dtype).split(".")[-1]
    with torch.inference_mode():
        args = _greedy_args(model, cfg, tokenizer, video, frame_map)
        h_k, tok_k = _greedy_decode(*args, "auto", fed=fed, kv_quant="int8")
        fed = tok_k if fed is None else fed
        h_p, tok_p = _greedy_decode(*args, "xla", fed=fed, kv_quant="int8")
        dequantize_llama_int4(model.llama, cfg.llama, torch.float32)
        model.float()
        h_ref, tok_ref = _greedy_decode(*args, "xla", fed=fed, kv_quant="int8")
    d_k, d_p = _rel(h_k, h_ref), _rel(h_p, h_ref)
    log(f"  greedy tokens: int4+kv8 {name} kernels {tok_k[:4]}, plain {tok_p[:4]}, "
        f"dequantized fp32 plain {tok_ref[:4]}")
    log(f"  {name} final hidden relative L2, kernels vs plain: {_rel(h_k, h_p):.3e}")
    log(f"  final hidden relative L2 from the dequantized fp32 plain path: {name} kernels "
        f"{d_k:.3e}, {name} plain {d_p:.3e} (limit {BF16_VS_PLAIN} x that)")
    if h_dense is not None:
        log(f"  int4+kv8 kernel path vs the dense {name} kernel path, final hidden "
            f"relative L2 (information): {_rel(h_k, h_dense):.3e}")
    if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
        raise AssertionError("int4+kv8 kernel path lies further from the fp32 reference "
                             "than the plain path")


def model_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 1: card and build")
    phase_device_and_build()
    kernels = phase_kernels()
    launches = {}

    t0 = time.perf_counter()
    model, cfg, tokenizer = load_pretrained_model("random:7b", "7b", "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"7B model (random:7b, seed 0) built on the card in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e9:.3f} B params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    video, frame_map = random_video(cfg)
    n_layers = cfg.llama.num_layers
    n_clip = cfg.vision.num_layers + cfg.vision.select_layer + 1
    log("phase 3: 7B bf16 chat on the card")
    run = phase_chat(model, cfg, tokenizer, video, frame_map)
    check_launches(run, {"decode_attention_stacked": (n_layers, "decode_steps"),
                         "vit_attention": (n_clip, "clip_calls")})
    launches.update({k: run["launches"][k] for k in ("decode_attention_stacked",
                                                     "vit_attention")})
    log("phase 4: bf16 kernel path against plain path at 7B")
    h_dense, tok_dense = phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, cfg, tokenizer = load_pretrained_model("random:7b", "7b", "cuda", quantize="int4")
    torch.cuda.synchronize()
    log(f"7B int4 model (random:7b, seed 0, quantized on the card) built in "
        f"{time.perf_counter() - t0:.2f} s: {model_bytes(model) / 2**30:.3f} GiB on the card "
        f"(decoder int4 projections {model_bytes(model.llama.int4) / 2**30:.3f} GiB, "
        f"int8 head {model_bytes(model.llama.lm_head) / 2**30:.3f} GiB)")
    log("phase 5: 7B int4 weights + int8 KV chat on the card")
    run = phase_chat(model, cfg, tokenizer, video, frame_map, kv_quant="int8")
    check_launches(run, {"int4_gemv_tiled": (4 * n_layers, "decode_steps"),
                         "int4_matmul_prefill_tiled": (4 * n_layers, "prefills"),
                         "decode_attention_stacked_q": (n_layers, "decode_steps"),
                         "vit_attention": (n_clip, "clip_calls")})
    launches.update({k: run["launches"][k] for k in ("int4_gemv_tiled",
                                                     "int4_matmul_prefill_tiled",
                                                     "decode_attention_stacked_q")})
    log("phase 6: int4 + kv8 kernel path against plain path at 7B")
    phase_quant_kernel_vs_plain(model, cfg, tokenizer, video, frame_map, fed=tok_dense,
                                h_dense=h_dense)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
