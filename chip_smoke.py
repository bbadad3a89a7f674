"""Run the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its lines; the last line is the JSON status):

1. the card (`nvidia-smi` name and power limit) and the kernels' build:
   every `handsonvlm_torch/csrc/*.cu` (and their shared headers: `mma.cuh`,
   `weight_gemm.cuh`, `gemv.cuh`, `int8_tc.cuh`, `transpose_tc.cuh`)
   compiled by nvcc for sm_90a;
2. each hand-written kernel against its plain PyTorch version at the main
   paths' shapes, with kernel, plain and library times from CUDA events
   after warm-up, and the least time the card could take (`bound_ms`); B9
   (int8 matmul) at the seven 7B projections and m = 1, 5, 8, 391, 2048,
   2379, the rows of its 5- and 8-row windows bit-equal to single rows and
   its GEMV / tensor-core crossover; B4b and B4c (the int4 GEMV, tiled and
   flat) timed at m = 1 and 5, B4c and B5a (the flat int4 layout) bit-equal
   to B4b and B5b on the same weights, B4b's, B4c's and B4a's window rows
   (5 and 9 rows) bit-equal to single rows, B5b and B5a also timed at m =
   2048 beside torch.mm, B2 and the int4 products with their share of the
   bound and their ratio to the library call; B4a (one flat matrix) at m =
   1 and 391; B10a /
   B10b (the fused QLoRA matmuls) through their autograd fronts at the
   seven 7B projections, m = 16 and 2048, r = 0, 5 and 128, bf16 and fp32
   inputs, two calls bit-equal at 16 rows (split-K, the LoRA term a split
   of its own), timed with and without the term; B11 (the fused decode
   MLP, two launches a call) at a 7B int4 layer's MLP half, B = 1, 5 and
   8, the 8-row call's rows bit-equal to each alone and two calls
   bit-equal, timed against the port's unfused chain and with each of its
   two kernels alone;
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
   kernel path may lie at most 1.2x as far from it as the bf16 plain path;
7. compaction at 7B (bf16, then int4 + int8 cache, kernels on): two
   continuous-batching engines (2 slots, 1024 positions, chunks of 4) run
   one request out behind a live one; engine A compacts its cache (kernel
   B8) and engine B does not. The live request's tokens and waypoints must
   be bit-equal, and every kernel's launches exact;
8. EK100 evaluation at 7B, int4 + int8 cache: 16 in-memory clips (10 unique
   224 px frames tiled x10, an EK-style prompt, future hands from a seed),
   32 new tokens at temperature 0.5 / top-p 0.9. Serial evaluation of 2
   clips, batched evaluation (8 slots, 4096 positions, chunks of 16) of
   all 16, and a staggered burst of 24 requests through the scheduler (4
   slots, 2048 positions) that runs the cursor out, so it compacts. Every
   clip is scored, nothing is truncated, launches are exact; a greedy pass
   of 2 clips gives each clip the same first token serially and batched;
9. a long prompt at 7B (bf16, then int4 + int8 cache): one chat turn whose
   prompt is about 2300 rows after the splice, 16 new tokens. The prefill
   goes through the flash kernel (one launch per layer), the decode steps
   through the stacked decode kernel. Phases 4 and 6 then repeat their
   comparison at that prompt: the flash prefill + 4 decode steps against
   the plain path from the fp32 reference, and in phase 4 also 4 steps
   with attn_impl="decode" (the per-layer decode kernel, one launch per
   layer and step);
10. speculative chat at 7B (bf16, then int4 + int8 cache), k = 4, greedy,
   the gate off, 32 new tokens: run A with an empty bank (drafts come
   from prompt n-grams at most) and run B whose bank is run A's stream.
   Run B must take fewer forwards than tokens; in both, every verify
   forward launches the stacked decode kernel once per layer (and the
   int4 GEMV four times, m = 5), and after every forward the cache index
   stands at its value before plus the tokens emitted. The hidden rows of
   one T = 5 window are held against the same five positions decoded one
   at a time. A sampled run (temperature 0.5, top-p 0.9, the gate on, the
   template bank) prints its stats.

11. the int8 decoder at 7B (`random:7b`, quantize="int8", kernel B9 on
   every projection): (a) three chat turns over the bf16 cache, B9's
   launches exact (7 per layer and forward); (b) speculative chat over the
   int8 cache, phase 10's checks, and a T = 5 window's rows bit-equal to
   single steps; (c) batched evaluation of 8 in-memory clips on 8 slots,
   chunks of 8: every clip scored, none truncated, launches exact;
12. the int8 kernel path against the plain path, phase 4's rule (the fp32
   plain path on the same int8 weights is the reference);
13. the flat int4 layouts from the int4 model: (a) the fused projections
   in the flat stacked layout (B4c decode, B5a prefill): a greedy prefill
   and 4 steps give tokens and final hidden states bit-equal to the tiled
   model's (B4b, B5b); (b) the seven per-projection flat leaves, sliced by
   columns from the fused flat buffers (B4a on every projection): exact
   launches and phase 6's rule, run inside phase 6 against the same fp32
   reference;
14. training at 7B (`train/`: `make_train_step`, `make_optimizer`), batch
   1, one synthetic sample of 2048 rows after the splice (10 unique
   frames), launches exact per step, wall ms, tokens/s and peak memory per
   step: (a) LoRA r=128 alpha=256 over the bf16 base, remat "full", three
   steps (B3 forward and recompute, B3b): the loss finite, the base, CLIP
   and norms bit-identical, the adapters moved; (e) one step's adapter
   gradients through the kernels against the plain route, phase 4's rule
   (the fp32 plain route on an fp32 copy is the reference); (b) QLoRA int4,
   the base quantized to tiled int4, three steps through B5b and B7b, the
   packed weights bit-identical; (c) the same weights in the flat layout,
   one step through B5a and B7a; (d) QLoRA int8 on the int8 model, one step
   through B9 and its plain backward; (f) QLoRA int8_fused over the same
   int8 weights, three steps through B10a and B10b (B9 never), its step
   time beside (d)'s as a ratio, then 14e over that route;
15. the training CLI at 7B (`handsonvlm_torch.train.train --qlora
   int8_fused --lora-r 128 --synthetic 4`): two steps in this process, the
   checkpoint restored bit-equal into a fresh template, the same command
   with one more step in its own process resuming from it, the LoRA
   artifact merged by the builder answering a chat turn; the checkpoint's
   bytes and save / restore seconds.

Phase 13c runs B11 over the int4 model's 32 layers for one token (the JAX
package's `tools/perf_fused_mlp.py` chain; no decoder takes B11), its
launches counted and the chain held by phase 4's rule against the plain
chain in f32, then timed against the unfused chain.

Phase 2 also checks B3b (the flash backward) at T = S = 2048 and 4096 and
B7a / B7b (the int4 transpose products) at the four fused 7B projections,
m = 16 and 2048. Phase 14 a-c runs right after phase 2 on its own
`random:7b` model, 14d and 14f on the int8 model before phase 11, phase 15
last. Phases 7 to 10 and 13a, 13c run before phases 4 and 6 (which convert
the model), on the model each chat phase loaded.

It exits non-zero, printing no result, when there is no CUDA device or
nvcc, and when any check fails: no phase catches its own failure.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from handsonvlm_torch.infer import sampler
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.config import get_config
from handsonvlm_torch.constants import ACTION_QUESTION_TEMPLATES, IMAGE_TOKEN_INDEX
from handsonvlm_torch.core.checkpoint import restore_train_state
from handsonvlm_torch.eval.evaluator import InferenceEngine, evaluate_epic_kitchen_traj
from handsonvlm_torch.infer.chat import chat_turn, new_conversation, prompt_ids
from handsonvlm_torch.infer.profile import random_video, train_batch
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.llama import (
    Int4Weight,
    Int8Weight,
    _quantize_kv_rows,
    apply_llama,
    dequantize_llama,
    int4_projection_shapes,
    lm_logits,
    projection_shapes,
    quantize_llama_int4,
    rms_norm,
)
from handsonvlm_torch.models.lora import LoRA, init_lora
from handsonvlm_torch.ops import _build
from handsonvlm_torch.ops.cache_ops import gather_cache_blocks, gather_cache_blocks_ref
from handsonvlm_torch.ops.attention import FLASH_MIN_T, attention_xla
from handsonvlm_torch.ops.decode_attention import (
    block_list,
    decode_attention,
    decode_attention_ref,
    decode_attention_stacked,
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_part,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from handsonvlm_torch.ops.int8_matmul import (
    INT8_TC_MIN_M,
    _launch_int8,
    dequantize_int4,
    dequantize_tiled,
    int4_gemv_flat,
    int4_gemv_flat_ref,
    int4_gemv_tiled,
    int4_gemv_tiled_ref,
    int4_matmul,
    int4_matmul_prefill,
    int4_matmul_prefill_ref,
    int4_matmul_prefill_tiled,
    int4_matmul_prefill_tiled_ref,
    int4_matmul_ref,
    int4_matmul_T_flat,
    int4_matmul_T_flat_ref,
    int4_matmul_T_tiled,
    int4_matmul_T_tiled_ref,
    int8_matmul,
    int8_matmul_ref,
    quantize_int4,
    quantize_stacked_int8,
    tile_int4_stacked,
    untile_int4_stacked,
)
from handsonvlm_torch.ops.fused_decode import (
    ROWS as ROWS_MAX,
    fused_mlp_ok,
    fused_mlp_part,
    fused_mlp_stacked,
    fused_mlp_stacked_ref,
    split_wgu_tiled,
)
from handsonvlm_torch.ops.qlora_fused import (
    int8_lora_matmul_stacked,
    int8_matmul_stacked,
    int8_stacked_bwd,
    int8_stacked_bwd_ref,
    int8_stacked_fwd,
    int8_stacked_fwd_ref,
    mm_f32,
)
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.serve.scheduler import ContinuousScheduler
from handsonvlm_torch.train import train as train_cli
from handsonvlm_torch.train.step import loss_fn, make_train_step
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

# kernel vs plain version, max abs error for attention (bf16 rounds p and
# the output; fp32 differs only in summation order)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the int4 matmuls: a share of max|y|, plus in bf16 one rounding step of the
# element (both sides round f32 sums taken in another order to bf16)
INT4_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# B11 rounds xn and act to bf16 in both versions whatever h's dtype: an fp32
# row differs where an act element's f32 sum, taken in another order, lands
# on the other side of a rounding boundary (1.1e-4 x max|y| at 7B, B = 8, on
# an H100 with the FMA kernel; 1.8e-4 with the tensor-core one, whose act is
# as close to f64 sums as the plain version's); 3e-4 x max|y| with no
# per-element term fails a kernel that rounds the residual h to bf16 (2^-9 x
# |h|)
B11_TOL = {torch.bfloat16: INT4_TOL[torch.bfloat16], torch.float32: 3e-4}
# final hidden at 7B, relative L2 from the fp32 plain path: the fp32 kernel
# path at most FP32_REL_L2, the bf16 kernel path at most BF16_VS_PLAIN x
# the bf16 plain path's distance
FP32_REL_L2 = 1e-4
BF16_VS_PLAIN = 1.2
# gradients (B3b) per element: |got - want| <= GRAD_RTOL x (|want| + the rms
# of want's (token, head) row) + GRAD_FLOOR x the rms of its block of
# GRAD_BLOCK tokens; in bf16 two rounding steps of the element (both round
# p and ds alike, and their f32 sums, taken in another order, once; now and
# then a ds lands one step apart, 1.15 steps read at 4096 keys) plus two of
# the row's typical entry (an entry that cancels); the floor holds a row
# that cancels whole to f32 noise (a causal first query row: p = 1 on its
# one key, so dp = delta but for the sums' order)
GRAD_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
GRAD_FLOOR, GRAD_BLOCK = 2.0 ** -12, 64
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
# and f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
# the 7B chat prompt after the splice (turn 1 of phase 3 in earlier runs)
PREFILL_ROWS = 391
DECODE_LEN = 450  # cache positions attended by a mid-answer decode step
LONG_ROWS = 2304  # rows of the long prompt after the splice (the flash prefill)
LONG_PROMPT_ROWS = 2379  # the long chat prompt phase 9 builds, after the splice
SPEC_K = 4  # drafted tokens per verify forward: windows of SPEC_K + 1 rows
TIMING_LAYERS = 4  # weights cycled while timing, so each launch finds L2 cold
# the 7B serving cache of batched evaluation: 8 slots of 4096 positions
SERVE_SLOTS, SERVE_LEN = 8, 4096
FRAG_LEN = 4000  # valid positions of the fragmented serving cache
SPIN_CYCLES = 200_000_000  # ~0.1 s of the card's clock ahead of a timed loop
# one training sample: 2048 rows after the splice, the reference's
# model_max_length and the first row count at which "auto" takes B3 / B3b
TRAIN_ROWS = 2048
LORA_R, LORA_ALPHA = 128, 256.0  # the reference's --lora_enable recipe
TRAIN_LR = 2e-5  # the reference recipe's (scripts/finetune.sh)
TRAIN_T = (2048, 4096)  # B3b's checked lengths (T = S, causal)
T_ROWS = (16, 2048)  # B7a / B7b's checked row counts
QLORA_ROWS = (16, 2048)  # B10a / B10b's checked row counts
QLORA_RANKS = (0, 5, 128)  # no adapter (no epilogue), an odd small rank, the recipe's
MLP_ROWS = (1, 5, 8)  # B11's checked and timed decode rows

# every kernel wrapper by the name chip_smoke reports it under
WRAPPERS = {"decode_attention_stacked": decode_attention_stacked,
            "vit_attention": vit_attention, "int4_gemv_tiled": int4_gemv_tiled,
            "int4_matmul_prefill_tiled": int4_matmul_prefill_tiled,
            "decode_attention_stacked_q": decode_attention_stacked_q,
            "gather_cache_blocks": gather_cache_blocks,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "int8_matmul": int8_matmul, "int4_gemv_flat": int4_gemv_flat,
            "int4_matmul_prefill": int4_matmul_prefill, "int4_matmul": int4_matmul,
            "flash_attention_bwd": flash_attention_bwd,
            "int4_matmul_T_tiled": int4_matmul_T_tiled, "int4_matmul_T_flat": int4_matmul_T_flat,
            "int8_stacked_fwd": int8_stacked_fwd, "int8_stacked_bwd": int8_stacked_bwd,
            "fused_mlp_stacked": fused_mlp_stacked}


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


def graph_time_ms(fn, iters: int = 10) -> float:
    """Mean device ms of fn() replayed from a CUDA graph captured after one
    eager call: a chain of many small launches timed without the host's
    launch rate in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_time_ms(lambda _: graph.replay(), iters=iters, warmup=2)


def bound(nbytes: float, flops: float, f32_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their type's peak rate (bf16 products on the
    tensor cores, `f32_flops` of f32 products outside them)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (flops / BF16_FLOP_S + f32_flops / F32_FLOP_S) * 1e3
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


def _check_int4(name, got, want, dtype, rows, tol=INT4_TOL):
    got, want = got.float(), want.float()
    ymax = float(want.abs().max())
    err = (got - want).abs()
    limit = tol[dtype] * ymax
    if dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * want.abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    rows.append(float(err.max()))
    log(f"  {name} {str(dtype).split('.')[-1]}: max_abs_err={rows[-1]:.3e} "
        f"= {rows[-1] / ymax:.2e} x max|y| (tol {tol[dtype]:.0e} x max|y|"
        f"{' + one bf16 step' if dtype == torch.bfloat16 else ''}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")


def _sdpa(q, k, v, mask=None):
    """scaled_dot_product_attention on (B, T, H, D) layouts (views); `mask`
    a bool (B or 1, 1, T, S) of the pairs attended."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask)


def _window_mask(tw, n):
    """(1, 1, tw, n) bool: window row tq attends keys < n - (tw - 1) + tq."""
    keys = torch.arange(n, device="cuda")
    return (keys[None, :] < (n - (tw - 1) + torch.arange(tw, device="cuda"))[:, None])[None, None]


def _log_window(name, attend, q, planes, dense, lt, n, bl, nbytes):
    """Time a decode kernel at the verify window (q's T rows over the first
    n keys, `lt` layers cycled) beside sdpa over the same keys with the
    window's causal mask (`dense(i)`: layer i's bf16 k, v), with its bound."""
    tw, h, d = q.shape[1], q.shape[2], q.shape[3]
    w_ms = cuda_time_ms(lambda i: attend(q, *planes, i % lt, n, blocks=bl))
    mask = _window_mask(tw, n)
    lib_ms = cuda_time_ms(lambda i: _sdpa(q, *dense(i % lt), mask))
    bound_ms, bound_by = bound(nbytes + 2 * tw * h * d * 2, 4 * n * tw * h * d)
    log(f"  {name} time at the verify window (T={tw}, same cache): kernel {w_ms:.4f} ms, "
        f"library (sdpa, the window's causal mask) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); {_shares(w_ms, bound_ms, lib_ms)}")


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

    # a fragmented 7B serving cache (4 layers, 1.07 GB)
    frag = [_rand(gen, (4, SERVE_SLOTS, SERVE_LEN, K, D), torch.bfloat16) for _ in range(2)]
    _fragmented_decode("B1", decode_attention_stacked, decode_attention_stacked_ref, frag, 4,
                       errs, 2 * D * 2, lambda i: (frag[0][i], frag[1][i]))
    del frag

    # time at the 7B decode shape: one query, length 450, the layers cycled
    # (16 x 8.5 MB of cache: each launch finds its layer outside L2)
    Lt, n = 16, DECODE_LEN
    ck = _rand(gen, (Lt, B, S, K, D), torch.bfloat16)
    cv = _rand(gen, (Lt, B, S, K, D), torch.bfloat16)
    q1 = _rand(gen, (B, 1, H, D), torch.bfloat16)
    bl = block_list(None, n, B, S, "cuda")  # built once per forward, not per layer
    ms = cuda_time_ms(lambda i: decode_attention_stacked(q1, ck, cv, i % Lt, n, blocks=bl))
    plain_ms = cuda_time_ms(
        lambda i: decode_attention_stacked_ref(q1, ck, cv, i % Lt, n, blocks=bl), iters=20)
    library_ms = cuda_time_ms(
        lambda i: _sdpa(q1, ck[i % Lt, :, :n], cv[i % Lt, :, :n]))
    bound_ms, bound_by = bound(2 * n * K * D * 2 + 2 * H * D * 2, 4 * n * H * D)
    log(f"  B1 time (B=1 H=K=32 D=128 S=520 len={n} bf16, {Lt} layers cycled): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); {_shares(ms, bound_ms, library_ms)}")
    qw = _rand(gen, (B, SPEC_K + 1, H, D), torch.bfloat16)
    _log_window("B1", decode_attention_stacked, qw, (ck, cv),
                lambda i: (ck[i, :, :n], cv[i, :, :n]), Lt, n, bl, 2 * n * K * D * 2)
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
        f"library (sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{_shares(ms, bound_ms, library_ms)}")
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

    def cache(b, k, layers=L, s=S):
        k8, ks = _quantize_kv_rows(_rand(gen, (layers, b, s, k, D), torch.bfloat16))
        v8, vs = _quantize_kv_rows(_rand(gen, (layers, b, s, k, D), torch.bfloat16))
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

    frag = cache(SERVE_SLOTS, K, 4, SERVE_LEN)
    _fragmented_decode("B6", decode_attention_stacked_q, decode_attention_stacked_q_ref, frag,
                       4, errs, 2 * (D + 4), lambda i: _dequantized(frag, i))
    del frag

    Lt, n = 16, DECODE_LEN
    ct = cache(B, K, Lt)
    q1 = _rand(gen, (B, 1, H, D), torch.bfloat16)
    bl = block_list(None, n, B, S, "cuda")  # built once per forward, not per layer
    ms = cuda_time_ms(lambda i: decode_attention_stacked_q(q1, *ct, i % Lt, n, blocks=bl))
    plain_ms = cuda_time_ms(
        lambda i: decode_attention_stacked_q_ref(q1, *ct, i % Lt, n, blocks=bl), iters=20)
    # the library call: sdpa over the cache dequantized to bf16 outside the loop
    deq = [(ct[0][i, :, :n].float() * ct[2][i, :, :, :n].transpose(1, 2)[..., None]).to(
        torch.bfloat16) for i in range(Lt)]
    deq = [(kd, (ct[1][i, :, :n].float() * ct[3][i, :, :, :n].transpose(1, 2)[..., None]).to(
        torch.bfloat16)) for i, kd in enumerate(deq)]
    library_ms = cuda_time_ms(lambda i: _sdpa(q1, *deq[i % Lt]))
    bound_ms, bound_by = bound(2 * n * K * D + 2 * n * K * 4 + 2 * H * D * 2, 4 * n * H * D)
    log(f"  B6 time (B=1 H=K=32 D=128 S=520 len={n}, int8 cache, bf16 q, {Lt} layers "
        f"cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa over the "
        f"dequantized bf16 cache) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{_shares(ms, bound_ms, library_ms)}")
    qw = _rand(gen, (B, SPEC_K + 1, H, D), torch.bfloat16)
    _log_window("B6", decode_attention_stacked_q, qw, ct, lambda i: deq[i], Lt, n, bl,
                2 * n * K * D + 2 * n * K * 4)
    del deq
    return {
        "name": "decode_attention_stacked_q", "route": "cuda",
        "source": "handsonvlm_torch/csrc/decode_attention.cu",
        "replaces": "handsonvlm_tpu/ops/decode_attention.py:341",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def fragmented_mask(b, s, length, device="cuda"):
    """(b, s) key masks as continuous batching leaves them: row r has a
    leading pad of 7r keys and r % 4 + 1 interior holes of 512 keys, so the
    rows list different counts of 256-key blocks; keys at or past `length`
    are invalid."""
    mask = torch.zeros((b, s), dtype=torch.bool, device=device)
    for r in range(b):
        mask[r, 7 * r:length] = True
        for j in range(r % 4 + 1):
            mask[r, 512 * (2 * j + 1):512 * (2 * j + 2)] = False
    return mask


def _dequantized(cache, i):
    """Layer i of an int8 (k8, v8, ks, vs) cache as bf16 (B, S, K, D) k, v."""
    return tuple((c[i].float() * sc[i].transpose(1, 2)[..., None]).to(torch.bfloat16)
                 for c, sc in ((cache[0], cache[2]), (cache[1], cache[3])))


def _fragmented_decode(name, attend, ref, cache, lt, tol_errs, key_bytes, dense):
    """The decode kernel over a fragmented 7B serving cache (SERVE_SLOTS
    rows of SERVE_LEN positions): checked against its plain version in bf16
    and fp32 queries, then timed (bf16, `lt` layers cycled) against the
    plain version, sdpa over the whole rows with the key mask (`dense(i)`:
    layer i's bf16 k, v) and the bound of the bytes its valid keys need
    (`key_bytes` per key and kv head: k, v and their scales)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, s, h, d = SERVE_SLOTS, SERVE_LEN, 32, 128
    kh = cache[0].shape[3]
    mask = fragmented_mask(b, s, FRAG_LEN)
    for dtype in (torch.bfloat16, torch.float32):
        # a float cache takes the query's dtype; the int8 cache any
        c = [x.to(dtype) if x.is_floating_point() and x.dim() == 5 else x for x in cache]
        q = _rand(gen, (b, 1, h, d), dtype)
        _check(f"{name} T=1 fragmented slots={b} S={s}", attend(q, *c, 1, FRAG_LEN,
                                                               key_mask=mask),
               ref(q, *c, 1, FRAG_LEN, key_mask=mask), dtype, tol_errs[dtype])
        q4 = _rand(gen, (b, 4, h, d), dtype)
        _check(f"{name} T=4 fragmented slots={b} S={s}", attend(q4, *c, 0, FRAG_LEN,
                                                               key_mask=mask),
               ref(q4, *c, 0, FRAG_LEN, key_mask=mask), dtype, tol_errs[dtype])
        del c
    q = _rand(gen, (b, 1, h, d), torch.bfloat16)
    # the forward builds the block list once for all layers: timed without it
    bl = block_list(mask, FRAG_LEN, b, s, "cuda")
    ms = cuda_time_ms(lambda i: attend(q, *cache, i % lt, FRAG_LEN, key_mask=mask, blocks=bl))
    plain_ms = cuda_time_ms(lambda i: ref(q, *cache, i % lt, FRAG_LEN, key_mask=mask, blocks=bl),
                            iters=5, warmup=1)
    list_ms = cuda_time_ms(lambda i: block_list(mask, FRAG_LEN, b, s, "cuda"))
    layers = [dense(i) for i in range(lt)]
    keep = mask[:, None, None, :]
    library_ms = cuda_time_ms(lambda i: _sdpa(q, *layers[i % lt], keep), iters=20)
    del layers
    keys = int(mask[:, :FRAG_LEN].sum())
    bound_ms, bound_by = bound(keys * kh * key_bytes + 2 * b * h * d * 2, 4 * keys * h * d)
    log(f"  {name} time fragmented (slots={b} S={s} len={FRAG_LEN}, {keys} valid keys, bf16 q, "
        f"{lt} layers cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa, "
        f"the key mask) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{_shares(ms, bound_ms, library_ms)}; the block list, built once per forward, "
        f"{list_ms:.4f} ms")


def _plane(gen, shape, dtype):
    c = torch.empty(shape, dtype=dtype, device="cuda")
    if dtype == torch.int8:
        return c.random_(-127, 128, generator=gen)
    return c.normal_(generator=gen)


def _index_select_rows(c, table, bk, seq_axis):
    """The library version: each row's blocks gathered out of place by one
    index_select (a new plane's worth of memory)."""
    lanes = torch.arange(bk, device=c.device)
    return [c[:, r].index_select(seq_axis - 1, (table[r].long()[:, None] * bk + lanes).reshape(-1))
            for r in range(c.shape[1])]


def check_gather_cache_blocks() -> dict:
    """B8 on the 7B serving planes with a random left-moving table (as
    compaction builds: each row keeps a random ascending subset of its
    blocks at the front): bit-exact against its plain version, then timed
    in place against the plain version and an out-of-place index_select
    per row. Bound: the bytes of the moved blocks, read once and written
    once."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.default_rng(8)
    L, b, s, kh, d, bk = 32, SERVE_SLOTS, SERVE_LEN, 32, 128, 256
    nk = s // bk
    table = np.tile(np.arange(nk, dtype=np.int32), (b, 1))
    for r in range(b):
        m = int(rng.integers(nk // 2, nk + 1))
        table[r, :m] = np.sort(rng.choice(nk, size=m, replace=False))
    table_d = torch.as_tensor(table, device="cuda")
    moved = int((table != np.arange(nk)).sum())
    row = None
    for shape, dtype, axis in (((L, b, s, kh, d), torch.int8, 2),
                               ((L, b, kh, s), torch.float32, 3),
                               ((L, b, s, kh, d), torch.bfloat16, 2)):
        c = _plane(gen, shape, dtype)
        want = gather_cache_blocks_ref(c.clone(), table_d, block_k=bk, seq_axis=axis)
        got = gather_cache_blocks(c, table_d, block_k=bk, seq_axis=axis)
        ok = torch.equal(got, want)
        del want
        name = f"B8 {tuple(shape)} {str(dtype).split('.')[-1]}"
        log(f"  {name} seq_axis={axis}: {moved} of {b * nk} blocks moved, bit-exact "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with the plain version")
        ms = cuda_time_ms(lambda i: gather_cache_blocks(c, table_d, block_k=bk, seq_axis=axis),
                          iters=20)
        plain_ms = cuda_time_ms(
            lambda i: gather_cache_blocks_ref(c, table_d, block_k=bk, seq_axis=axis),
            iters=3, warmup=1)
        library_ms = cuda_time_ms(lambda i: _index_select_rows(c, table_d, bk, axis),
                                  iters=3, warmup=1)
        block_bytes = c[0, 0].numel() // s * bk * c.element_size()
        bound_ms, bound_by = bound(2 * moved * L * block_bytes, 0)
        log(f"  {name} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(index_select per row, out of place) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {2 * moved * L * block_bytes / 1e9:.3f} GB)")
        row = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        del c
        torch.cuda.empty_cache()
    # the row reported is the bf16 plane's (the last)
    return {"name": "gather_cache_blocks", "route": "cuda",
            "source": "handsonvlm_torch/csrc/cache_ops.cu",
            "replaces": "handsonvlm_tpu/ops/cache_ops.py:87", **row}


def _int4_stack(din, dout, layers, gen):
    """Random weights at the 7B init scale, quantized and tiled as
    quantize_llama_int4 does: (w4t, gst) stacked over `layers`."""
    packed = [quantize_int4(0.02 * torch.randn((din, dout), generator=gen, device="cuda"))
              for _ in range(layers)]
    return tile_int4_stacked(torch.stack([p[0] for p in packed]),
                             torch.stack([p[1] for p in packed]))


def _shares(ms: float, bound_ms: float, library_ms) -> str:
    """A kernel's time as a share of its bound and as a multiple of the
    library call's."""
    lib = "" if library_ms is None else f", {ms / library_ms:.2f}x the library's time"
    return f"{bound_ms / ms:.1%} of the bound{lib}"


def _also_timed(name, wrapper, x, w, s, dense, what, times) -> None:
    """Time `wrapper` and torch.mm over the dequantized bf16 weights at one
    more row count (x's), cycling the layers; add (kernel, library, bytes,
    flops) into `times` and print the projection's line."""
    Lt = len(dense)
    m, din = x.shape[-2:]
    dout = dense[0].shape[1]
    t_k = cuda_time_ms(lambda i: wrapper(x, w, s, i % Lt), iters=20)
    t_mm = cuda_time_ms(lambda i: torch.mm(x[0], dense[i % Lt]), iters=20)
    nbytes = _mm_bytes(m, din, dout, w[0].numel() + s[0].numel() * 4)
    log(f"  {name} time {what} ({din}->{dout}, m={m}, bf16, {Lt} layers cycled): "
        f"kernel {t_k:.4f} ms, library {t_mm:.4f} ms, bound "
        f"{bound(nbytes, 2 * m * din * dout)[0]:.4f} ms")
    for i, v in enumerate((t_k, t_mm, nbytes, 2 * m * din * dout)):
        times[i] += v


def _log_also_timed(name, m, times) -> None:
    ms, mm_ms, nbytes, flops = times
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"  {name}: the four projections of one layer at m={m}: kernel {ms:.4f} ms, library "
        f"(torch.mm over the dequantized bf16 weight) {mm_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); {_shares(ms, bound_ms, mm_ms)}")


def _int4_kernel(name, wrapper, ref, rows_checked, rows_timed, seed, also_rows=0) -> dict:
    """Check `wrapper` against `ref` at the four 7B projections for each m
    in rows_checked (bf16 and fp32), then time kernel, plain and the library
    call, torch.mm over the weight dequantized to bf16 (outside the timed
    loop), at each m of rows_timed (the first is the row reported), cycling
    over TIMING_LAYERS layers; `also_rows` also times the kernel and the
    library call at that m."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = int4_projection_shapes(get_config("7b").llama)
    errs = {torch.bfloat16: [], torch.float32: []}
    times = {m: [0.0] * 5 for m in rows_timed}  # kernel, plain, library, bytes, flops
    also = [0.0] * 4
    Lt = TIMING_LAYERS
    for proj, (din, dout) in shapes.items():
        w4t, gst = _int4_stack(din, dout, Lt, gen)
        for dtype in (torch.bfloat16, torch.float32):
            for m in rows_checked:
                x = _rand(gen, (1, m, din), dtype)
                _check_int4(f"{name} {proj} {din}->{dout} m={m}",
                            wrapper(x, w4t, gst, m % Lt),
                            ref(x, w4t, gst, m % Lt), dtype, errs[dtype])
        w_dense = [dequantize_tiled(w4t, gst, i).to(torch.bfloat16) for i in range(Lt)]
        for m in rows_timed:
            x = _rand(gen, (1, m, din), torch.bfloat16)
            t_k = cuda_time_ms(lambda i: wrapper(x, w4t, gst, i % Lt))
            t_p = cuda_time_ms(lambda i: ref(x, w4t, gst, i % Lt), iters=10, warmup=2)
            t_mm = cuda_time_ms(lambda i: torch.mm(x[0], w_dense[i % Lt]))
            nbytes = w4t[0].numel() + gst[0].numel() * 4 + m * (din + dout) * 2
            log(f"  {name} time {proj} ({din}->{dout}, m={m}, bf16, {Lt} layers cycled): "
                f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library {t_mm:.4f} ms, bound "
                f"{bound(nbytes, 2 * m * din * dout)[0]:.4f} ms")
            for k, v in enumerate((t_k, t_p, t_mm, nbytes, 2 * m * din * dout)):
                times[m][k] += v
        if also_rows:
            _also_timed(name, wrapper, _rand(gen, (1, also_rows, din), torch.bfloat16), w4t,
                        gst, w_dense, proj, also)
        del w4t, gst, w_dense
    for m in rows_timed:
        ms, plain_ms, mm_ms, nbytes, flops = times[m]
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"  {name}: the four projections of one layer at m={m}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library (torch.mm over the dequantized bf16 weight) "
            f"{mm_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{_shares(ms, bound_ms, mm_ms)}")
    if also_rows:
        _log_also_timed(name, also_rows, also)
    ms, plain_ms, mm_ms, nbytes, flops = times[rows_timed[0]]
    bound_ms, bound_by = bound(nbytes, flops)
    return {"max_abs_err": max(errs[torch.bfloat16]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": mm_ms}


def check_int4_gemv() -> dict:
    row = _int4_kernel("B4b", int4_gemv_tiled, int4_gemv_tiled_ref, (1, SPEC_K + 1, 8, 9, 127),
                       (1, SPEC_K + 1), 4)
    return {"name": "int4_gemv_tiled", "route": "cuda",
            "source": "handsonvlm_torch/csrc/int4_gemv.cu",
            "replaces": "handsonvlm_tpu/ops/int8_matmul.py:469", **row}


def check_int4_prefill() -> dict:
    row = _int4_kernel("B5b", int4_matmul_prefill_tiled, int4_matmul_prefill_tiled_ref,
                       (128, PREFILL_ROWS, 500), (PREFILL_ROWS,), 5, also_rows=TRAIN_ROWS)
    return {"name": "int4_matmul_prefill_tiled", "route": "cuda",
            "source": "handsonvlm_torch/csrc/int4_prefill.cu",
            "replaces": "handsonvlm_tpu/ops/int8_matmul.py:704", **row}


def _mm_bytes(m, din, dout, weight_bytes):
    """Bytes a matmul of m rows must move: the weight, x and y (bf16)."""
    return weight_bytes + m * (din + dout) * 2


def check_int8_matmul() -> dict:
    """B9 against its plain version at the seven 7B projections (f32 out
    for bf16 and f32 x, the JAX package's output; x's dtype out, the
    decoder's call, also checked to give the same bits twice), the rows of
    a T = 5 window and of an 8-slot batch bit-equal to each row alone,
    then timed at each m against the plain version and torch.mm over the
    weight upcast to bf16 (outside the timed loop) with f32 output times the
    scale, TIMING_LAYERS layers cycled; and both of its paths, the GEMV and
    the tensor cores, forced at the m around the crossover that
    INT8_TC_MIN_M sets."""
    if INT8_TC_MIN_M <= max(SPEC_K + 1, SERVE_SLOTS):
        raise AssertionError(f"INT8_TC_MIN_M = {INT8_TC_MIN_M} would move a decode-time row "
                             f"count (a verify window, a slot batch) off the GEMV")
    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = projection_shapes(get_config("7b").llama)
    errs = {torch.bfloat16: [], torch.float32: []}
    Lt = TIMING_LAYERS
    rows = (1, SPEC_K + 1, SERVE_SLOTS, PREFILL_ROWS, TRAIN_ROWS, LONG_PROMPT_ROWS)
    crossover = (1, SPEC_K + 1, SERVE_SLOTS, INT8_TC_MIN_M, 16, 24, 32, 64, 128)
    times = {m: [0.0] * 5 for m in rows}  # kernel, plain, library, bytes, flops
    paths = {(m, tc): 0.0 for m in crossover for tc in (False, True)}
    for proj, (din, dout) in shapes.items():
        w8, sc = quantize_stacked_int8(0.02 * torch.randn((Lt, din, dout), generator=gen,
                                                          device="cuda"))
        for dtype in (torch.bfloat16, torch.float32):
            for m in rows:
                x, i = _rand(gen, (m, din), dtype), m % Lt
                _check_int4(f"B9 {proj} {din}->{dout} m={m} out f32",
                            int8_matmul(x, w8[i], sc[i]), int8_matmul_ref(x, w8[i], sc[i]),
                            torch.float32, errs[dtype])
                if dtype == torch.bfloat16 and m in (1, PREFILL_ROWS, TRAIN_ROWS):
                    got = int8_matmul(x, w8[i], sc[i], dtype)
                    _check_int4(f"B9 {proj} {din}->{dout} m={m} out bf16", got,
                                int8_matmul_ref(x, w8[i], sc[i], dtype), dtype, errs[dtype])
                    if not torch.equal(got, int8_matmul(x, w8[i], sc[i], dtype)):
                        raise AssertionError(f"B9 {proj} m={m}: two calls differ")
            for m in (SPEC_K + 1, SERVE_SLOTS):
                _window_bit_equal(f"B9 {proj} {str(dtype).split('.')[-1]} m={m}",
                                  lambda a: int8_matmul(a, w8[1], sc[1], dtype),
                                  _rand(gen, (m, din), dtype))
        w_bf16 = [w8[i].to(torch.bfloat16) for i in range(Lt)]
        for m in rows:
            x = _rand(gen, (m, din), torch.bfloat16)
            few = m >= PREFILL_ROWS
            t = times[m]
            t[0] += cuda_time_ms(lambda i: int8_matmul(x, w8[i % Lt], sc[i % Lt], x.dtype),
                                 iters=10 if few else 50)
            t[1] += cuda_time_ms(lambda i: int8_matmul_ref(x, w8[i % Lt], sc[i % Lt], x.dtype),
                                 iters=3 if few else 10, warmup=1)
            t[2] += cuda_time_ms(
                lambda i: torch.mm(x, w_bf16[i % Lt], out_dtype=torch.float32) * sc[i % Lt],
                iters=10 if few else 50)
            t[3] += _mm_bytes(m, din, dout, w8[0].numel() + sc[0].numel() * 4)
            t[4] += 2 * m * din * dout
        for m, tc in paths:
            x = _rand(gen, (m, din), torch.bfloat16)
            paths[m, tc] += cuda_time_ms(
                lambda i: _launch_int8(x, w8[i % Lt], sc[i % Lt], x.dtype, tensor_cores=tc),
                iters=10)
        del w8, sc, w_bf16
        torch.cuda.empty_cache()
    for m in rows:
        ms, plain_ms, library_ms, nbytes, flops = times[m]
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"  B9 time, the seven projections of one layer at m={m} (bf16 x and out, "
            f"{Lt} layers cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch.mm over the upcast weight, f32 out, x scale) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); {100 * bound_ms / ms:.1f}% of the bound")
    log(f"  B9 crossover, the seven projections of one layer, bf16, ms: m, GEMV, tensor cores "
        f"(the dispatch takes the tensor cores from m = {INT8_TC_MIN_M})")
    for m in crossover:
        log(f"    {m:4d}  {paths[m, False]:8.4f}  {paths[m, True]:8.4f}")
    ms, plain_ms, library_ms, nbytes, flops = times[1]
    bound_ms, bound_by = bound(nbytes, flops)
    # the row reported is the decode step's (m = 1)
    return {"name": "int8_matmul", "route": "cuda",
            "source": "handsonvlm_torch/csrc/int8_matmul.cu",
            "replaces": "handsonvlm_tpu/ops/int8_matmul.py:89",
            "max_abs_err": max(errs[torch.bfloat16]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _window_bit_equal(name, fn, x) -> None:
    """Each row of the m-row call fn(x) is bit-equal to fn of that row alone
    (the GEMV's splits and sums do not depend on m)."""
    window = fn(x)
    same = all(torch.equal(fn(x[r:r + 1])[0], window[r]) for r in range(x.shape[0]))
    log(f"  {name}: the {x.shape[0]} rows of a call bit-equal to each row alone: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: a row of a window differs from the same row alone")


def check_int4_flat() -> list:
    """B4c and B5a on the four fused 7B projections, the flat layout made
    from the tiled one by the inverse permute: bit-equal to B4b and B5b on
    the same weight and held against their plain versions, then timed (B4c
    at m = 1 and SPEC_K + 1, B5a at PREFILL_ROWS); B4a on the seven
    per-projection 7B matrices in the flat layout at m = 1 and m =
    PREFILL_ROWS (the JAX package runs it at every m), checked and timed;
    B4b's, B4c's and B4a's window rows (SPEC_K + 1 and 9 rows) bit-equal to
    each row alone."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    Lt = TIMING_LAYERS
    errs = {k: {torch.bfloat16: [], torch.float32: []} for k in ("B4c", "B5a", "B4a")}
    timed = (("B4c", 1), ("B4c", SPEC_K + 1), ("B5a", PREFILL_ROWS), ("B4a", 1),
             ("B4a", PREFILL_ROWS))
    times = {k: [0.0] * 5 for k in timed}  # kernel, plain, bytes, flops, library
    b5a_train = [0.0] * 4  # B5a at TRAIN_ROWS: kernel, library, bytes, flops

    def time_at(key, fn, ref, x, w_dense, din, dout, nbytes, args):
        m, t = x.shape[-2], times[key]
        few = m >= PREFILL_ROWS
        t[0] += cuda_time_ms(lambda i: fn(x, *args(i % Lt)), iters=10 if few else 50)
        t[1] += cuda_time_ms(lambda i: ref(x, *args(i % Lt)), iters=3 if few else 5, warmup=1)
        t[2] += _mm_bytes(m, din, dout, nbytes)
        t[3] += 2 * m * din * dout
        t[4] += cuda_time_ms(lambda i: torch.mm(x.reshape(m, din), w_dense[i % Lt]),
                             iters=10 if few else 50)

    for proj, (din, dout) in int4_projection_shapes(get_config("7b").llama).items():
        w4t, gst = _int4_stack(din, dout, Lt, gen)
        w4, gs = untile_int4_stacked(w4t, gst)
        for dtype in (torch.bfloat16, torch.float32):
            for name, flat, tiled, ref, ms_ in (
                    ("B4c", int4_gemv_flat, int4_gemv_tiled, int4_gemv_flat_ref,
                     (1, SPEC_K + 1, 8, 9, 127)),
                    ("B5a", int4_matmul_prefill, int4_matmul_prefill_tiled,
                     int4_matmul_prefill_ref, (128, PREFILL_ROWS, TRAIN_ROWS))):
                for m in ms_:
                    x, i = _rand(gen, (1, m, din), dtype), m % Lt
                    got = flat(x, w4, gs, i)
                    same = torch.equal(got, tiled(x, w4t, gst, i))
                    _check_int4(f"{name} {proj} {din}->{dout} m={m}", got, ref(x, w4, gs, i),
                                dtype, errs[name][dtype])
                    log(f"    bit-equal to the tiled kernel: {'ok' if same else 'FAIL'}")
                    if not same:
                        raise AssertionError(f"{name} differs from the tiled kernel")
            for m in (SPEC_K + 1, 9):
                x = _rand(gen, (m, din), dtype)
                _window_bit_equal(f"B4b {proj} {str(dtype).split('.')[-1]} m={m}",
                                  lambda a: int4_gemv_tiled(a, w4t, gst, 1), x)
                _window_bit_equal(f"B4c {proj} {str(dtype).split('.')[-1]} m={m}",
                                  lambda a: int4_gemv_flat(a, w4, gs, 1), x)
        nbytes = w4t[0].numel() + gst[0].numel() * 4
        w_dense = [dequantize_tiled(w4t, gst, i).to(torch.bfloat16) for i in range(Lt)]
        for name, fn, ref, m in (("B4c", int4_gemv_flat, int4_gemv_flat_ref, 1),
                                 ("B4c", int4_gemv_flat, int4_gemv_flat_ref, SPEC_K + 1),
                                 ("B5a", int4_matmul_prefill, int4_matmul_prefill_ref,
                                  PREFILL_ROWS)):
            time_at((name, m), fn, ref, _rand(gen, (1, m, din), torch.bfloat16), w_dense, din,
                    dout, nbytes, lambda i: (w4, gs, i))
        _also_timed("B5a", int4_matmul_prefill, _rand(gen, (1, TRAIN_ROWS, din), torch.bfloat16),
                    w4, gs, w_dense, proj, b5a_train)
        del w4t, gst, w4, gs, w_dense
    for proj, (din, dout) in projection_shapes(get_config("7b").llama).items():
        packed = [quantize_int4(0.02 * torch.randn((din, dout), generator=gen, device="cuda"))
                  for _ in range(Lt)]
        for dtype in (torch.bfloat16, torch.float32):
            for m in (1, PREFILL_ROWS):
                x = _rand(gen, (m, din), dtype)
                _check_int4(f"B4a {proj} {din}->{dout} m={m}", int4_matmul(x, *packed[m % Lt]),
                            int4_matmul_ref(x, *packed[m % Lt]), dtype, errs["B4a"][dtype])
            _window_bit_equal(f"B4a {proj} {str(dtype).split('.')[-1]} m=9",
                              lambda a: int4_matmul(a, *packed[1]), _rand(gen, (9, din), dtype))
        nbytes = packed[0][0].numel() + packed[0][1].numel() * 4
        w_dense = [dequantize_int4(*p).to(torch.bfloat16) for p in packed]
        for m in (1, PREFILL_ROWS):
            time_at(("B4a", m), int4_matmul, int4_matmul_ref,
                    _rand(gen, (m, din), torch.bfloat16), w_dense, din, dout, nbytes,
                    lambda i: packed[i])
        del packed, w_dense
        torch.cuda.empty_cache()
    for key in timed:
        name, m = key
        ms, plain_ms, nbytes, flops, library_ms = times[key]
        bound_ms, bound_by = bound(nbytes, flops)
        what = ("the seven per-projection matrices" if name == "B4a"
                else "the four fused projections")
        log(f"  {name} time, {what} at m={m} (bf16, {Lt} layers cycled): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library (torch.mm over the dequantized bf16 weight) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{_shares(ms, bound_ms, library_ms)}")
        if name == "B5a":
            _log_also_timed(name, TRAIN_ROWS, b5a_train)
    out = []
    for name, m, site, fn in (("B4c", 1, "int8_matmul.py:931", "int4_gemv_flat"),
                              ("B5a", PREFILL_ROWS, "int8_matmul.py:637", "int4_matmul_prefill"),
                              ("B4a", 1, "int8_matmul.py:413", "int4_matmul")):
        ms, plain_ms, nbytes, flops, library_ms = times[name, m]
        bound_ms, bound_by = bound(nbytes, flops)
        out.append({"name": fn, "route": "cuda",
                    "source": "handsonvlm_torch/csrc/" + (
                        "int4_prefill.cu" if name == "B5a" else "int4_gemv.cu"),
                    "replaces": "handsonvlm_tpu/ops/" + site,
                    "max_abs_err": max(errs[name][torch.bfloat16]),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
    return out


def _prefill_case(gen, t, s, dtype, pad=0, layers=1):
    """q (1, t, 32, 128), a cache (layers, 1, s, 32, 128) pair holding a
    prefill of t rows at index 0, and its key mask: the written prefix less
    a left pad of `pad` keys (None when there is neither pad nor tail)."""
    q = _rand(gen, (1, t, 32, 128), dtype)
    ck = _rand(gen, (layers, 1, s, 32, 128), dtype)
    cv = _rand(gen, (layers, 1, s, 32, 128), dtype)
    mask = None
    if pad or s > t:
        mask = torch.zeros((1, s), dtype=torch.bool, device="cuda")
        mask[:, pad:t] = True
    return q, ck, cv, mask


def _flash_long_prompt_time(gen, lt) -> None:
    """B3 at the long prompt's shape (LONG_ROWS rows at cache index 0 over
    2560 positions, a 37-key left pad) beside sdpa with the same pairs as a
    boolean mask; the bound counts the pairs and keys this mask leaves."""
    t, s, pad, h, d = LONG_ROWS, 2560, 37, 32, 128
    q, ck, cv, mask = _prefill_case(gen, t, s, torch.bfloat16, pad, layers=lt)
    keys = torch.arange(s, device="cuda")
    pairs_ok = (keys[None, :] <= torch.arange(t, device="cuda")[:, None]) & mask
    ms = cuda_time_ms(lambda i: flash_attention(q, ck[i % lt], cv[i % lt], key_mask=mask),
                      iters=20)
    library_ms = cuda_time_ms(
        lambda i: _sdpa(q, ck[i % lt], cv[i % lt], pairs_ok[None, None]), iters=20)
    pairs, n_keys = int(pairs_ok.sum()), int(mask.sum())
    bound_ms, bound_by = bound(2 * t * h * d * 2 + 2 * n_keys * h * d * 2 + 4 * h * t,
                               4 * pairs * h * d)
    log(f"  B3 time at the long prompt (T={t} over S={s}, pad {pad}, H=K=32 D=128 bf16, {lt} "
        f"layers cycled): kernel {ms:.4f} ms, library (sdpa, the boolean mask) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{4 * pairs * h * d / ms / 1e9:.1f} TFLOP/s, {_shares(ms, bound_ms, library_ms)}")


def check_flash_attention() -> dict:
    """B3 against its plain version at the long prompt's shapes (output and
    logsumexp; a left-pad row gives 0 / NEG_INF in both), then timed at
    T = S = 4096 causal against the plain version and sdpa, and the
    crossover the dispatch rests on: kernel, the plain route (attention_xla)
    and sdpa at T = S = 512 .. 4096; the share of the bound and the ratio
    to sdpa at a training sample's 2048 rows, at 4096, and at the long
    prompt's shape (LONG_ROWS over 2560 keys, a left pad)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    errs = {torch.bfloat16: [], torch.float32: []}
    for t, s, pad, dtype in ((LONG_ROWS, 2560, 37, torch.bfloat16),
                             (LONG_ROWS, 2560, 37, torch.float32),
                             (4096, 4608, 0, torch.bfloat16)):
        q, ck, cv, mask = _prefill_case(gen, t, s, dtype, pad)
        got, lse = flash_attention(q, ck[0], cv[0], key_mask=mask, q_offset=0)
        want, want_lse = flash_attention_ref(q, ck[0], cv[0], key_mask=mask, q_offset=0)
        _check(f"B3 T={t} S={s} pad={pad}", got, want, dtype, errs[dtype])
        lse_err = float((lse - want_lse).abs().max())
        log(f"    logsumexp max_abs_err={lse_err:.3e} (tol 1e-3)")
        if not lse_err <= 1e-3:
            raise AssertionError("B3: logsumexp disagrees with the plain version")
        if pad and (bool(got[:, :pad].any()) or float(lse[..., :pad].max()) > -1e29):
            raise AssertionError("B3: a row with no valid key must give 0 / NEG_INF")
        del q, ck, cv, got, want, lse, want_lse
        torch.cuda.empty_cache()

    def sdpa_causal(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True)

    rows, Lt = {}, 4  # 4 layers of k, v cycled: 4 x 67 MB at T = 4096, past L2
    log("  B3 crossover, T = S causal, (1, T, 32, 128) bf16, ms per layer: "
        "T, kernel, plain route (attention_xla), library (sdpa)")
    for t in (512, 1024, 2048, 4096):
        q, ck, cv, _ = _prefill_case(gen, t, t, torch.bfloat16, layers=Lt)
        k_ms = cuda_time_ms(lambda i: flash_attention(q, ck[i % Lt], cv[i % Lt]), iters=20)
        x_ms = cuda_time_ms(lambda i: attention_xla(q, ck[i % Lt], cv[i % Lt]),
                            iters=5, warmup=1)
        l_ms = cuda_time_ms(lambda i: sdpa_causal(q, ck[i % Lt], cv[i % Lt]), iters=20)
        log(f"    {t:5d}  {k_ms:8.4f}  {x_ms:8.4f}  {l_ms:8.4f}")
        rows[t] = (k_ms, l_ms)
        if t == 4096:
            plain_ms = cuda_time_ms(lambda i: flash_attention_ref(q, ck[i % Lt], cv[i % Lt]),
                                    iters=3, warmup=1)
        del q, ck, cv
        torch.cuda.empty_cache()
    h, d = 32, 128
    for t in (TRAIN_ROWS, 4096):  # a training sample's rows, then the reported shape
        pairs = t * (t + 1) // 2  # (query, key) pairs under the causal mask
        bound_ms, bound_by = bound(4 * t * h * d * 2 + 4 * h * t, 4 * pairs * h * d)
        ms, library_ms = rows[t]
        log(f"  B3 time (T=S={t} causal, H=K=32 D=128 bf16, {Lt} layers cycled): kernel "
            f"{ms:.4f} ms{f', plain {plain_ms:.4f} ms' if t == 4096 else ''}, library (sdpa, "
            f"causal) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{4 * pairs * h * d / ms / 1e9:.1f} TFLOP/s, {_shares(ms, bound_ms, library_ms)}")
    _flash_long_prompt_time(gen, Lt)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "handsonvlm_torch/csrc/flash_attention.cu",
        "replaces": "handsonvlm_tpu/ops/flash_attention.py:143",
        "max_abs_err": max(errs[torch.bfloat16]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_decode_attention_single() -> dict:
    """B12 over one layer's own cache of 4608 positions against its plain
    version, then timed at the long prompt's decode shape (2304 keys) and
    at 4096 keys, the layers cycled."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    S, H, K, D, Lt = 4608, 32, 32, 128, 8
    errs = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        k, v = _rand(gen, (1, S, K, D), dtype), _rand(gen, (1, S, K, D), dtype)
        q = _rand(gen, (1, 1, H, D), dtype)
        for length in (1, 33, 450, LONG_ROWS, 4096):
            _check(f"B12 len={length}", decode_attention(q, k, v, length),
                   decode_attention_ref(q, k, v, length), dtype, errs[dtype])
        mask = torch.ones((1, S), dtype=torch.bool, device="cuda")
        mask[:, :37] = False
        mask[:, 1000:1300] = False
        _check("B12 len=2304 masked (pad, a hole of whole tiles)",
               decode_attention(q, k, v, LONG_ROWS, key_mask=mask),
               decode_attention_ref(q, k, v, LONG_ROWS, key_mask=mask), dtype, errs[dtype])
        kg, vg = _rand(gen, (2, 600, 8, D), dtype), _rand(gen, (2, 600, 8, D), dtype)
        qg = _rand(gen, (2, H, D), dtype)
        _check("B12 GQA H=32 K=8 B=2 len=555", decode_attention(qg, kg, vg, 555),
               decode_attention_ref(qg, kg, vg, 555), dtype, errs[dtype])
    ck = _rand(gen, (Lt, 1, S, K, D), torch.bfloat16)
    cv = _rand(gen, (Lt, 1, S, K, D), torch.bfloat16)
    q = _rand(gen, (1, 1, H, D), torch.bfloat16)
    row = None
    for n in (4096, LONG_ROWS):
        ms = cuda_time_ms(lambda i: decode_attention(q, ck[i % Lt], cv[i % Lt], n))
        plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, ck[i % Lt], cv[i % Lt], n),
                                iters=10, warmup=2)
        library_ms = cuda_time_ms(lambda i: _sdpa(q, ck[i % Lt, :, :n], cv[i % Lt, :, :n]))
        bound_ms, bound_by = bound(2 * n * K * D * 2 + 2 * H * D * 2, 4 * n * H * D)
        log(f"  B12 time (B=1 H=K=32 D=128 S={S} len={n} bf16, {Lt} layers cycled): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {_shares(ms, bound_ms, library_ms)}")
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
    # the row reported is the long prompt's decode shape (the last)
    return {"name": "decode_attention", "route": "cuda",
            "source": "handsonvlm_torch/csrc/decode_attention.cu",
            "replaces": "handsonvlm_tpu/ops/decode_attention.py:449",
            "max_abs_err": max(errs[torch.bfloat16]), **row}


def _grad_limit(want: torch.Tensor, rtol: float) -> torch.Tensor:
    """The per-element limit of a gradient (B, N, heads, D): rtol x (|want|
    + its (token, head) row's rms) + GRAD_FLOOR x the rms of its row's block
    of GRAD_BLOCK tokens."""
    ms = want.pow(2).mean(-1)  # (B, N, H)
    block = torch.arange(ms.shape[1], device=want.device) // GRAD_BLOCK
    sums = torch.zeros((ms.shape[0], int(block[-1]) + 1, ms.shape[2]),
                       device=want.device).index_add_(1, block, ms)
    local = (sums / torch.bincount(block)[None, :, None])[:, block]
    return (rtol * (want.abs() + ms.sqrt()[..., None])
            + GRAD_FLOOR * local.sqrt()[..., None])


def _check_grad(name, got, want, want32, dtype, rows):
    """A gradient (B, N, heads, D) against its plain version per element
    (`_grad_limit`); in bf16 also phase 4's rule against `want32`, the
    plain version in fp32 on the same inputs: the kernel at most
    BF16_VS_PLAIN x the bf16 plain version's relative L2 distance from
    it."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = _grad_limit(want, GRAD_RTOL[dtype])
    worst = float((diff / limit.clamp(min=1e-30)).max())
    err = float(diff.max())
    ok = bool(torch.isfinite(got).all()) and bool((diff <= limit).all())
    rows.append(err)
    l2 = ""
    if want32 is not None:
        d_k, d_p = _rel(got, want32), _rel(want, want32)
        ok = ok and d_k <= BF16_VS_PLAIN * d_p
        l2 = (f"; relative L2 from fp32 plain: kernel {d_k:.3e}, bf16 plain {d_p:.3e} "
              f"(ratio {d_k / d_p:.3f}, limit {BF16_VS_PLAIN})")
    log(f"  {name} {str(dtype).split('.')[-1]}: max_abs_err={err:.3e}, worst element "
        f"{worst:.3f} x its limit (rtol {GRAD_RTOL[dtype]:.2e}){l2} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")


def check_flash_attention_bwd() -> dict:
    """B3b (the delta pass, then the wgmma grid of dk/dv and dq blocks)
    against its plain version on the forward kernel's output and logsumexp:
    T = S = 2048 and 4096 causal (bf16; 2048 also fp32), a 1024-row prefill
    at q_offset 1024 over 2048 keys, and a right-padded key mask (a training
    row's tail); at T = S = 2048 in bf16 a second call must give the same
    bits. Timed at T = S = 2048 and 4096 against the plain version and the
    backward of scaled_dot_product_attention (its forward outside the timed
    loop), with each part of the bf16 route timed alone beside the total."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = {torch.bfloat16: [], torch.float32: []}
    h, d = 32, 128
    cases = [(t, t, 0, 0, torch.bfloat16) for t in TRAIN_T] + [
        (2048, 2048, 0, 0, torch.float32), (1024, 2048, 1024, 0, torch.bfloat16),
        (2048, 2048, 0, 117, torch.bfloat16)]
    for t, s, q_offset, right_pad, dtype in cases:
        q, k, v = _rand(gen, (1, t, h, d), dtype), _rand(gen, (1, s, h, d), dtype), \
            _rand(gen, (1, s, h, d), dtype)
        mask = None
        if right_pad:
            mask = torch.ones((1, s), dtype=torch.bool, device="cuda")
            mask[:, s - right_pad:] = False
        out, lse = flash_attention(q, k, v, key_mask=mask, q_offset=q_offset)
        do = _rand(gen, (1, t, h, d), dtype)
        got = flash_attention_bwd(q, k, v, out, lse, do, key_mask=mask, q_offset=q_offset)
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, key_mask=mask, q_offset=q_offset)
        want32 = [None] * 3
        if dtype == torch.bfloat16:
            want32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse,
                                             do.float(), key_mask=mask, q_offset=q_offset)
        for name, g, w, w32 in zip(("dq", "dk", "dv"), got, want, want32):
            _check_grad(f"B3b T={t} S={s} q_offset={q_offset} right_pad={right_pad} {name}",
                        g, w, w32, dtype, errs[dtype])
        if (t, s, q_offset, right_pad, dtype) == (2048, 2048, 0, 0, torch.bfloat16):
            again = flash_attention_bwd(q, k, v, out, lse, do)
            for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"B3b T=S=2048 {name}: two calls differ")
            log("  B3b T=S=2048: a second call gives the same bits (dq, dk, dv)")
            del again
        del q, k, v, out, lse, do, got, want, want32
        torch.cuda.empty_cache()

    rows, Lt = {}, 4
    log("  B3b time, T = S causal, (1, T, 32, 128) bf16, ms per layer (the whole backward): "
        "T, kernel, plain, library (sdpa backward), bound; then each part alone")
    for t in TRAIN_T:
        q, k, v = (_rand(gen, (Lt, t, h, d), torch.bfloat16) for _ in range(3))
        do = _rand(gen, (1, t, h, d), torch.bfloat16)
        fwd = [flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(Lt)]
        ms = cuda_time_ms(lambda i: flash_attention_bwd(
            q[i % Lt:i % Lt + 1], k[i % Lt:i % Lt + 1], v[i % Lt:i % Lt + 1],
            fwd[i % Lt][0], fwd[i % Lt][1], do), iters=20)
        plain_ms = cuda_time_ms(lambda i: flash_attention_bwd_ref(
            q[i % Lt:i % Lt + 1], k[i % Lt:i % Lt + 1], v[i % Lt:i % Lt + 1],
            fwd[i % Lt][0], fwd[i % Lt][1], do), iters=3, warmup=1)
        leaves = [[x[i:i + 1].transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
                  for i in range(Lt)]
        outs = [F.scaled_dot_product_attention(*lv, is_causal=True) for lv in leaves]
        do_t = do.transpose(1, 2)
        library_ms = cuda_time_ms(lambda i: torch.autograd.grad(
            outs[i % Lt], leaves[i % Lt], do_t, retain_graph=True), iters=20)
        pairs = t * (t + 1) // 2
        # the function's five products (S, dP, dV, dK, dQ); the two-kernel
        # design's second S and dP are not counted
        flops = 5 * 2 * pairs * h * d
        nbytes = 8 * t * h * d * 2 + 2 * h * t * 4  # q k v O dO dq dk dv, lse and delta
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"    {t:5d}  {ms:8.4f}  {plain_ms:8.4f}  {library_ms:8.4f}  {bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s)")
        parts = {part: cuda_time_ms(lambda i: flash_attention_bwd_part(
            q[i % Lt:i % Lt + 1], k[i % Lt:i % Lt + 1], v[i % Lt:i % Lt + 1],
            fwd[i % Lt][0], fwd[i % Lt][1], do, part), iters=20)
            for part in ("delta", "dkv", "dq")}
        # dk/dv blocks do four of the seven products, dq blocks three
        log(f"      parts alone: delta pass {parts['delta']:.4f} ms, dk/dv blocks "
            f"{parts['dkv']:.4f} ms ({0.8 * flops / parts['dkv'] / 1e9:.1f} TFLOP/s), dq blocks "
            f"{parts['dq']:.4f} ms ({0.6 * flops / parts['dq'] / 1e9:.1f} TFLOP/s), sum "
            f"{sum(parts.values()):.4f} against {ms:.4f} in one grid")
        rows[t] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
        del q, k, v, do, fwd, leaves, outs
        torch.cuda.empty_cache()
    # the row reported is the training shape (T = S = 2048)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "handsonvlm_torch/csrc/flash_attention.cu",
            "replaces": "handsonvlm_tpu/ops/flash_attention.py:303",
            "max_abs_err": max(errs[torch.bfloat16]), **rows[TRAIN_ROWS]}


def check_int4_transpose() -> list:
    """B7b (tiled) and B7a (flat) against their plain versions at the four
    fused 7B projections, m = 16 and 2048 (bf16 and fp32 dy), the flat
    kernel bit-equal to the tiled one on the same weight and the tiled one
    to itself called again; then both timed
    over a layer's four projections at m = 2048 and 16 against the plain
    version and torch.mm of dy with the dequantized bf16 weight
    (transposed; upcast outside the timed loop), TIMING_LAYERS layers
    cycled."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = int4_projection_shapes(get_config("7b").llama)
    errs = {torch.bfloat16: [], torch.float32: []}
    Lt = TIMING_LAYERS
    kernels = {"B7b": (int4_matmul_T_tiled, int4_matmul_T_tiled_ref),
               "B7a": (int4_matmul_T_flat, int4_matmul_T_flat_ref)}
    t = {(k, m): [0.0] * 5 for k in kernels for m in T_ROWS}  # kernel plain library bytes flops
    for proj, (din, dout) in shapes.items():
        w4t, gst = _int4_stack(din, dout, Lt, gen)
        w4, gs = untile_int4_stacked(w4t, gst)
        weights = {"B7b": (w4t, gst), "B7a": (w4, gs)}
        for dtype in (torch.bfloat16, torch.float32):
            for m in T_ROWS:
                dy = _rand(gen, (1, m, dout), dtype)
                got = {}
                for k, (fn, ref) in kernels.items():
                    got[k] = fn(dy, *weights[k], m % Lt)
                    _check_int4(f"{k} {proj} {dout}->{din} m={m}", got[k],
                                ref(dy, *weights[k], m % Lt), dtype, errs[dtype])
                if not torch.equal(got["B7a"], got["B7b"]):
                    raise AssertionError(f"B7a {proj} m={m}: not bit-equal to B7b")
                if not torch.equal(got["B7b"], int4_matmul_T_tiled(dy, w4t, gst, m % Lt)):
                    raise AssertionError(f"B7b {proj} m={m}: two calls differ")
        w_dense = [dequantize_tiled(w4t, gst, i).to(torch.bfloat16) for i in range(Lt)]
        for m in T_ROWS:
            dy = _rand(gen, (1, m, dout), torch.bfloat16)
            lib = cuda_time_ms(lambda i: torch.mm(dy[0], w_dense[i % Lt].t()))
            for k, (fn, ref) in kernels.items():
                w, sc = weights[k]
                row = t[(k, m)]
                row[0] += cuda_time_ms(lambda i: fn(dy, w, sc, i % Lt))
                row[1] += cuda_time_ms(lambda i: ref(dy, w, sc, i % Lt), iters=3, warmup=1)
                row[2] += lib
                row[3] += w4t[0].numel() + gst[0].numel() * 4 + m * (din + dout) * 2
                row[4] += 2 * m * din * dout
        del w4t, gst, w4, gs, w_dense, weights
        torch.cuda.empty_cache()
    out = []
    for k, (fn, _) in kernels.items():
        for m in T_ROWS:
            ms, plain_ms, library_ms, nbytes, flops = t[(k, m)]
            bound_ms, bound_by = bound(nbytes, flops)
            log(f"  {k} ({fn.__name__}) time, a layer's four projections at m={m} (bf16, {Lt} "
                f"layers cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(torch.mm, dequantized bf16 weight) {library_ms:.4f} ms, bound {bound_ms:.4f} "
                f"ms ({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s")
        ms, plain_ms, library_ms, nbytes, flops = t[(k, TRAIN_ROWS)]
        bound_ms, bound_by = bound(nbytes, flops)
        out.append({"name": fn.__name__, "route": "cuda",
                    "source": "handsonvlm_torch/csrc/int4_transpose.cu",
                    "replaces": ("handsonvlm_tpu/ops/int8_matmul.py:805" if k == "B7b"
                                 else "handsonvlm_tpu/ops/int8_matmul.py:858"),
                    "max_abs_err": max(errs[torch.bfloat16]), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    return out


def check_qlora_fused() -> list:
    """B10a (int8_stacked_fwd) and B10b (int8_stacked_bwd) through their
    autograd fronts at the seven 7B projections, m = 16 and 2048, bf16 and
    fp32 x and dy, r = 0 (no term), 5 and 128: the forward output and dx
    of the kernel route against the plain route (`plain=True`). Both kernels
    round their output to bf16 whatever the input's dtype (the Pallas
    kernels' contract), so both dtypes take the bf16 gate. At m = 16 (split-K,
    the term a split of its own) a second kernel call must give the same
    bits. Then each kernel timed over a layer's seven projections at m =
    2048, r = 128, against its plain version and the library calls (torch.mm
    over the weight upcast to bf16 outside the timed loop, plus the LoRA
    delta), TIMING_LAYERS layers cycled. The bound counts the term as the
    kernels compute it, on the tensor cores: three bf16 products of the
    operands' high and low parts, which keep its f32 contract."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    shapes = projection_shapes(get_config("7b").llama)
    Lt, m_t, r_t, ls = TIMING_LAYERS, TRAIN_ROWS, LORA_R, LORA_ALPHA / LORA_R
    errs = {"B10a": [], "B10b": []}
    # kernel, plain, library, bytes, base flops, term flops, kernel without the term (r = 0)
    t = {k: [0.0] * 7 for k in errs}
    for proj, (din, dout) in shapes.items():
        w8, sc = quantize_stacked_int8(0.02 * torch.randn((Lt, din, dout), generator=gen,
                                                          device="cuda"))
        for m in QLORA_ROWS:
            for r in QLORA_RANKS:
                a, b = (0.02 * torch.randn((din, r), generator=gen, device="cuda"),
                        0.02 * torch.randn((r, dout), generator=gen, device="cuda"))
                for dtype in (torch.bfloat16, torch.float32):
                    x, dy, i = _rand(gen, (m, din), dtype), _rand(gen, (m, dout), dtype), m % Lt
                    out = {}
                    # under split-K (16 rows) the kernel route runs twice
                    for plain in (False, True) + ((False,) if m == QLORA_ROWS[0] else ()):
                        xg = x.clone().requires_grad_()
                        y = (int8_lora_matmul_stacked(xg, w8, sc, a, b, ls, i, plain=plain) if r
                             else int8_matmul_stacked(xg, w8, sc, i, plain=plain))
                        got = (y.detach(), torch.autograd.grad(y, xg, dy)[0])
                        if plain in out and not all(map(torch.equal, got, out[plain])):
                            raise AssertionError(f"B10a / B10b {proj} m={m} r={r}: two calls "
                                                 f"differ under split-K")
                        out[plain] = got
                    what = f"{proj} {din}->{dout} m={m} r={r} {str(dtype).split('.')[-1]} in"
                    _check_int4(f"B10a {what}", out[False][0], out[True][0], torch.bfloat16,
                                errs["B10a"])
                    _check_int4(f"B10b dx {what}", out[False][1], out[True][1],
                                torch.bfloat16, errs["B10b"])
        x2 = _rand(gen, (m_t, din), torch.bfloat16)
        g2 = _rand(gen, (m_t, dout), torch.bfloat16)
        a = 0.02 * torch.randn((din, r_t), generator=gen, device="cuda")
        b = 0.02 * torch.randn((r_t, dout), generator=gen, device="cuda")
        u_s = mm_f32(x2, a.to(torch.bfloat16)) * ls
        v_s = mm_f32(g2, b.to(torch.bfloat16).t()) * ls
        w_up = [w8[i].to(torch.bfloat16) for i in range(Lt)]
        w_dq = [w8[i].to(torch.bfloat16) * sc[i].to(torch.bfloat16) for i in range(Lt)]
        for k, fn, ref, lib, lhs, lora in (
                ("B10a", int8_stacked_fwd, int8_stacked_fwd_ref,
                 lambda i: torch.mm(x2, w_up[i % Lt], out_dtype=torch.float32) * sc[i % Lt]
                 + u_s @ b, x2, (u_s, b)),
                ("B10b", int8_stacked_bwd, int8_stacked_bwd_ref,
                 lambda i: torch.mm(g2, w_dq[i % Lt].t(), out_dtype=torch.float32)
                 + v_s @ a.t(), g2, (v_s, a))):
            row = t[k]
            row[0] += cuda_time_ms(lambda i: fn(lhs, w8, sc, i % Lt, *lora), iters=10)
            row[6] += cuda_time_ms(lambda i: fn(lhs, w8, sc, i % Lt), iters=10)
            row[1] += cuda_time_ms(lambda i: ref(lhs, w8, sc, i % Lt, *lora), iters=3, warmup=1)
            row[2] += cuda_time_ms(lib, iters=10)
            row[3] += (din * dout + dout * 4 + m_t * (din + dout) * 2 + m_t * r_t * 4
                       + r_t * (dout if k == "B10a" else din) * 4)
            row[4] += 2 * m_t * din * dout
            row[5] += 3 * 2 * m_t * r_t * (dout if k == "B10a" else din)
        del w8, sc, w_up, w_dq
        torch.cuda.empty_cache()
    out = []
    for k, fn, site in (("B10a", int8_stacked_fwd, "qlora_fused.py:212"),
                        ("B10b", int8_stacked_bwd, "qlora_fused.py:306")):
        ms, plain_ms, library_ms, nbytes, flops, term_flops, base_ms = t[k]
        bound_ms, bound_by = bound(nbytes, flops + term_flops)
        log(f"  {k} ({fn.__name__}) time, a layer's seven projections at m={m_t}, r={r_t} "
            f"(bf16, {Lt} layers cycled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch.mm over the upcast weight + the LoRA delta) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP base + "
            f"{term_flops / 1e9:.1f} GFLOP term, both bf16 on the tensor cores); "
            f"{100 * bound_ms / ms:.1f}% of the bound, {ms / library_ms:.2f}x the library, "
            f"{(flops + term_flops) / ms / 1e9:.1f} TFLOP/s; without the term (r = 0) "
            f"{base_ms:.4f} ms, so the term costs {ms - base_ms:.4f} ms")
        out.append({"name": fn.__name__, "route": "cuda",
                    "source": "handsonvlm_torch/csrc/qlora_fused.cu",
                    "replaces": "handsonvlm_tpu/ops/" + site,
                    "max_abs_err": max(errs[k]), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    return out


def mlp_weights(cfg_llama, layers, gen):
    """A stack of 7B-shaped int4 MLP weights: the int4 decoder's fused,
    tiled gate|up leaf and w_down, and the gate / up split that B11 takes."""
    d, f = cfg_llama.hidden_size, cfg_llama.intermediate_size
    wgu = dict(zip(("w4t", "gst"), _int4_stack(d, 2 * f, layers, gen)))
    wd = dict(zip(("w4t", "gst"), _int4_stack(f, d, layers, gen)))
    wg, wu = split_wgu_tiled(wgu, f)
    return wgu, wg, wu, wd


def unfused_mlp(h, nrm, wgu, wd, layer, eps):
    """The int4 decoder's MLP half as the port runs it: rms_norm, B4b over
    the fused gate|up, silu(gate) * up, B4b over w_down, the residual."""
    gu = int4_gemv_tiled(rms_norm(h, nrm[layer], eps), wgu["w4t"], wgu["gst"], layer)
    f = gu.shape[-1] // 2
    return h + int4_gemv_tiled(F.silu(gu[..., :f]) * gu[..., f:], wd["w4t"], wd["gst"], layer)


def check_fused_mlp() -> dict:
    """B11 (fused_mlp_stacked) at a 7B int4 layer's MLP half (d 4096, f
    11008: gate / up in 43 tiles of 256 columns, w_down in 16), MLP_ROWS
    rows, bf16 and fp32 rows, against its plain version by B11_TOL (the int4
    gate in bf16; in fp32 3e-4 x max|y|, as both versions round xn and act
    to bf16 whatever the rows' dtype and a flip of act moves an fp32 output
    by a bf16 step of act); the rows of the 8-row call bit-equal to each row
    alone, and two calls bit-equal. Timed at MLP_ROWS against the plain
    version and the port's unfused chain (rms_norm, B4b over the fused
    gate|up, silu * up, B4b over w_down, the residual: no single PyTorch
    call computes it), and its two kernels each alone (gate/up, then down
    over that act), TIMING_LAYERS layers cycled."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    lcfg = get_config("7b").llama
    d, f, eps, Lt = lcfg.hidden_size, lcfg.intermediate_size, lcfg.rms_norm_eps, TIMING_LAYERS
    wgu, wg, wu, wd = mlp_weights(lcfg, Lt, gen)
    nrm = (1.0 + 0.1 * torch.randn((Lt, d), generator=gen, device="cuda")).to(torch.bfloat16)
    errs = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.bfloat16, torch.float32):
        for b in MLP_ROWS:
            h, i = _rand(gen, (b, d), dtype), b % Lt
            _check_int4(f"B11 B={b} {str(dtype).split('.')[-1]} rows",
                        fused_mlp_stacked(h, nrm, wg, wu, wd, i, eps),
                        fused_mlp_stacked_ref(h, nrm, wg, wu, wd, i, eps), dtype,
                        errs[dtype], B11_TOL)
        h = _rand(gen, (ROWS_MAX, d), dtype)
        window = fused_mlp_stacked(h, nrm, wg, wu, wd, 1, eps)
        same = all(torch.equal(fused_mlp_stacked(h[r:r + 1], nrm, wg, wu, wd, 1, eps)[0],
                               window[r]) for r in range(ROWS_MAX))
        twice = torch.equal(window, fused_mlp_stacked(h, nrm, wg, wu, wd, 1, eps))
        log(f"  B11 {str(dtype).split('.')[-1]} rows: the {ROWS_MAX}-row call's rows bit-equal "
            f"to each alone {'ok' if same else 'FAIL'}; two calls bit-equal "
            f"{'ok' if twice else 'FAIL'}")
        if not (same and twice):
            raise AssertionError("B11: rows differ alone and in a window, or between calls")
    weight_bytes = sum(w[k][0].numel() * w[k].element_size() for w in (wg, wu, wd)
                       for k in ("w4t", "gst"))
    times = {}
    for b in MLP_ROWS:
        h = _rand(gen, (b, d), torch.bfloat16)
        act = fused_mlp_part(h, nrm, wg, wu, wd, 0, eps, 1)
        ms = cuda_time_ms(lambda i: fused_mlp_stacked(h, nrm, wg, wu, wd, i % Lt, eps))
        chain_ms = cuda_time_ms(lambda i: unfused_mlp(h, nrm, wgu, wd, i % Lt, eps))
        plain_ms = cuda_time_ms(lambda i: fused_mlp_stacked_ref(h, nrm, wg, wu, wd, i % Lt, eps),
                                iters=5, warmup=1)
        up_ms = cuda_time_ms(lambda i: fused_mlp_part(h, nrm, wg, wu, wd, i % Lt, eps, 1))
        down_ms = cuda_time_ms(lambda i: fused_mlp_part(h, nrm, wg, wu, wd, i % Lt, eps, 2,
                                                        act=act))
        bound_ms, bound_by = bound(weight_bytes + 2 * b * d * 2, 2 * 3 * b * d * f)
        times[b] = (ms, plain_ms, bound_ms, bound_by)
        log(f"  B11 time, a 7B layer's MLP half at B={b} (bf16, {Lt} layers cycled): kernel "
            f"{ms:.4f} ms ({100 * bound_ms / ms:.1f}% of the bound, {ms / chain_ms:.2f}x the "
            f"unfused chain), plain {plain_ms:.4f} ms, the unfused chain (library none) "
            f"{chain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {weight_bytes / 1e6:.1f} "
            f"MB of weights and scales); alone: gate/up {up_ms:.4f} ms, down {down_ms:.4f} ms")
    ms, plain_ms, bound_ms, bound_by = times[1]
    return {"name": "fused_mlp_stacked", "route": "cuda",
            "source": "handsonvlm_torch/csrc/fused_decode.cu",
            "replaces": "handsonvlm_tpu/ops/fused_decode.py:159",
            "max_abs_err": max(errs[torch.bfloat16]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernels() -> list:
    log("phase 2: kernels against their plain versions")
    return [check_decode_attention(), check_vit_attention(), check_int4_gemv(),
            check_int4_prefill(), check_decode_attention_q(), check_gather_cache_blocks(),
            check_flash_attention(), check_decode_attention_single(), check_int8_matmul(),
            *check_int4_flat(), check_flash_attention_bwd(), *check_int4_transpose(),
            *check_qlora_fused(), check_fused_mlp()]


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


def expect_launches(counts: dict, expect: dict) -> None:
    """Every kernel's launches in a phase against `expect` (kernel ->
    count; kernels not named must not launch). Off the card nothing
    launches, and nothing is checked."""
    for name in WRAPPERS:
        want, got = expect.get(name, 0), counts[name]
        log(f"  launches {name}: {got} (expect {want})")
        if torch.cuda.is_available() and got != want:
            raise AssertionError(f"{name} launched {got} times, expected {want}")


def check_launches(run: dict, expect_per: dict) -> None:
    """Every kernel's count from a chat phase against its expectation:
    expect_per maps a kernel to (launches per unit, unit name)."""
    expect_launches(run["launches"], {name: per * run[unit]
                                      for name, (per, unit) in expect_per.items()})


def _greedy_decode(model, cfg, ids, images, frame_map, max_len, impl, fed=None,
                   kv_quant=None, step_impl=None):
    """Greedy prefill + 4 decode steps with attention `impl` (the steps
    with `step_impl` when given); `fed` feeds another run's tokens instead
    of this run's own argmax. Returns (final hidden fp32, this run's own 5
    greedy tokens)."""
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
                                 attn_mask=mask, kv_cache=cache, attn_impl=step_impl or impl)
        hidden = out[:, 0]
    return hidden.float(), greedy


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _greedy_args(model, cfg, tokenizer, video, frame_map, text="What happens next?"):
    dev = model.llama.embed_tokens.weight.device
    ids = torch.as_tensor(prompt_ids(new_conversation(), tokenizer, text), device=dev)
    images = torch.as_tensor(video, device=dev)
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + 8
    return model, cfg, ids, images, frame_map, max_len


def phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map, long_text=None):
    """Greedy prefill + 4 decode steps with the kernels ("auto") and the
    plain versions ("xla") in the model's dtype, then with the same weights
    cast to fp32 (an int8 model keeps its int8 weights: the fp32 plain path
    is their exact product); every run is fed the first run's tokens.
    Leaves the model in fp32. Returns (the kernel path's final hidden, its greedy tokens, the
    launches of the per-layer decode kernel as counted in its run).

    The counts are set to 0 before each run in the model's dtype and read
    after it: the CLIP kernel per CLIP layer, the flash kernel per layer of
    a prefill of 2048 rows or more, per layer and step the stacked decode
    kernel ("auto") or the per-layer one ("decode"), with int8 weights B9
    seven times per layer and forward, nothing else.

    The fp32 plain path is the reference. A random-weight bf16 7B amplifies
    one rounding step many times over (on an H100 the bf16 kernel and plain
    paths end 3.6e-2 apart in relative L2), so the bf16 kernel path is held
    to the bf16 plain path's own distance from the reference, and the fp32
    kernel path to FP32_REL_L2.

    `long_text` repeats the comparison at a long prompt: its "auto" prefill
    goes through the flash kernel (one launch per layer), and a third run
    takes the decode steps with attn_impl="decode" (the per-layer decode
    kernel, one launch per layer and step), held to the same bounds."""
    dtype = model.llama.embed_tokens.weight.dtype
    name = str(dtype).split(".")[-1]
    n_layers = cfg.llama.num_layers
    scenes = {"chat prompt": _greedy_args(model, cfg, tokenizer, video, frame_map)}
    if long_text is not None:
        scenes["long prompt"] = _greedy_args(model, cfg, tokenizer, video, frame_map, long_text)
    low, b12 = {}, 0
    with torch.inference_mode():
        for scene, args in scenes.items():
            want = serving_launches(model, cfg, None, 4, 1, 0)
            if args[2].shape[1] + cfg.num_visual_tokens - 1 >= 2048:
                want["flash_attention"] = n_layers
            reset_launches()
            h_k, tok_k = _greedy_decode(*args, "auto")
            expect_launches(read_launches(), want)
            h_p, tok_p = _greedy_decode(*args, "xla", fed=tok_k)
            h_d = None
            if scene == "long prompt":
                reset_launches()
                h_d, _ = _greedy_decode(*args, "auto", fed=tok_k, step_impl="decode")
                counts = read_launches()
                want["decode_attention"] = want.pop("decode_attention_stacked")
                expect_launches(counts, want)
                b12 = counts["decode_attention"]
            low[scene] = (h_k, tok_k, h_p, tok_p, h_d)
        model.float()
        for scene, args in scenes.items():
            h_k, tok_k, h_p, tok_p, h_d = low[scene]
            h_ref, tok_ref = _greedy_decode(*args, "xla", fed=tok_k)
            h_k32, tok_k32 = _greedy_decode(*args, "auto", fed=tok_k)
            d_k, d_p, d_32 = _rel(h_k, h_ref), _rel(h_p, h_ref), _rel(h_k32, h_ref)
            log(f"  {scene} ({args[2].shape[1] + cfg.num_visual_tokens - 1} rows): greedy "
                f"tokens: {name} kernels {tok_k[:4]}, {name} plain {tok_p[:4]}, fp32 plain "
                f"{tok_ref[:4]}, fp32 kernels {tok_k32[:4]}")
            log(f"  {name} final hidden relative L2, kernels vs plain: {_rel(h_k, h_p):.3e}")
            log(f"  final hidden relative L2 from the fp32 plain path: {name} kernels "
                f"{d_k:.3e}, {name} plain {d_p:.3e} (limit {BF16_VS_PLAIN} x that), fp32 "
                f"kernels {d_32:.3e} (limit {FP32_REL_L2:.0e})")
            dists = {f"{name} kernel path": (d_k, BF16_VS_PLAIN * d_p),
                     "fp32 kernel path": (d_32, FP32_REL_L2)}
            if h_d is not None:
                h_d32, _ = _greedy_decode(*args, "auto", fed=tok_k, step_impl="decode")
                dists[f"{name} per-layer decode kernel"] = (_rel(h_d, h_ref),
                                                            BF16_VS_PLAIN * d_p)
                dists["fp32 per-layer decode kernel"] = (_rel(h_d32, h_ref), FP32_REL_L2)
                log(f"  steps with attn_impl='decode': {name} {_rel(h_d, h_ref):.3e}, fp32 "
                    f"{_rel(h_d32, h_ref):.3e} from the fp32 plain path")
            for what, (dist, limit) in dists.items():
                if not (np.isfinite(dist) and dist <= limit):
                    raise AssertionError(f"{scene}: the {what} lies {dist:.3e} from the fp32 "
                                         f"reference, limit {limit:.3e}")
    h_k, tok_k = low["chat prompt"][:2]
    return h_k, tok_k, b12


def phase_quant_kernel_vs_plain(model, cfg, tokenizer, video, frame_map, fed=None,
                                h_dense=None, long_text=None, layouts=None) -> dict:
    """The quantized + int8-cache path: greedy prefill + 4 decode steps with
    the kernels ("auto") and the plain versions ("xla") in the model's
    dtype, then with the quantized weights dequantized into an fp32 model
    (plain path, the reference). All runs decode over the int8 cache and
    are fed `fed` (else the first run's own tokens). The kernel path may
    lie at most BF16_VS_PLAIN x as far from the reference as the plain
    path. `layouts` (name -> (Llama.int4, Llama.proj)) repeats the chat
    prompt's runs with each weight layout installed in turn: layouts of one
    quantization share the fp32 reference. The launches of each kernel run
    are counted exactly. `h_dense`, the dense model's final hidden for the
    same tokens, is compared for information only. `long_text` repeats the
    comparison at a long prompt (the flash prefill) with the first layout.
    Leaves the model dense fp32. Returns each layout's launches."""
    dtype = model.llama.embed_tokens.weight.dtype
    name = str(dtype).split(".")[-1]
    llama, n_layers = model.llama, cfg.llama.num_layers
    layouts = layouts or {"": (llama.int4, llama.proj)}
    first = next(iter(layouts))
    chat = _greedy_args(model, cfg, tokenizer, video, frame_map)
    scenes = [("chat prompt", layout, chat, fed) for layout in layouts]
    if long_text is not None:
        scenes.append(("long prompt", first,
                       _greedy_args(model, cfg, tokenizer, video, frame_map, long_text), None))
    low, counts = [], {}
    with torch.inference_mode():
        for scene, layout, args, fed_s in scenes:
            llama.int4, llama.proj = layouts[layout]
            want = serving_launches(model, cfg, "int8", 4, 1, 0)
            if args[2].shape[1] + cfg.num_visual_tokens - 1 >= 2048:
                want["flash_attention"] = n_layers
            reset_launches()
            h_k, tok_k = _greedy_decode(*args, "auto", fed=fed_s, kv_quant="int8")
            counts[layout] = read_launches()
            expect_launches(counts[layout], want)
            fed_s = tok_k if fed_s is None else fed_s
            h_p, tok_p = _greedy_decode(*args, "xla", fed=fed_s, kv_quant="int8")
            low.append((h_k, tok_k, h_p, tok_p, fed_s))
        llama.int4, llama.proj = layouts[first]
        dequantize_llama(llama, cfg.llama, torch.float32)
        model.float()
        refs = {}
        for (scene, layout, args, _), (h_k, tok_k, h_p, tok_p, fed_s) in zip(scenes, low):
            if scene not in refs:
                refs[scene] = _greedy_decode(*args, "xla", fed=fed_s, kv_quant="int8")
            h_ref, tok_ref = refs[scene]
            d_k, d_p = _rel(h_k, h_ref), _rel(h_p, h_ref)
            what = f"{scene}{f', {layout}' if layout else ''}"
            log(f"  {what}: greedy tokens: {name} kernels {tok_k[:4]}, plain {tok_p[:4]}, "
                f"dequantized fp32 plain {tok_ref[:4]}")
            log(f"  {name} final hidden relative L2, kernels vs plain: {_rel(h_k, h_p):.3e}")
            log(f"  final hidden relative L2 from the dequantized fp32 plain path: {name} "
                f"kernels {d_k:.3e}, {name} plain {d_p:.3e} (limit {BF16_VS_PLAIN} x that)")
            if h_dense is not None and scene == "chat prompt":
                log(f"  quantized + kv8 kernel path vs the dense {name} kernel path, final "
                    f"hidden relative L2 (information): {_rel(h_k, h_dense):.3e}")
            if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
                raise AssertionError(f"{what}: the kernel path lies further from the fp32 "
                                     "reference than the plain path")
    return counts


def serving_launches(model, cfg, kv_quant, decode_steps, prefills, compactions) -> dict:
    """The launches a run of the serving path must make: per decode
    forward B1 (bf16) or B6 (int8 cache) once per layer; per prefill B2
    once per CLIP layer; per compaction B8 once per cache plane; and by the
    weights: fused int4, per layer B4b (tiled) or B4c (flat) for the four
    projections of a decode forward and B5b or B5a for those of a prefill;
    per projection, B9 (int8) or B4a (flat int4) for the seven projections
    of every forward."""
    n_layers, llama = cfg.llama.num_layers, model.llama
    n_clip = cfg.vision.num_layers + cfg.vision.select_layer + 1
    attn = "decode_attention_stacked_q" if kv_quant else "decode_attention_stacked"
    want = {attn: n_layers * decode_steps, "vit_attention": n_clip * prefills,
            "gather_cache_blocks": (4 if kv_quant else 2) * compactions}
    if llama.int4 is not None:
        tiled = hasattr(llama.int4["wo"], "w4t")
        want["int4_gemv_tiled" if tiled else "int4_gemv_flat"] = 4 * n_layers * decode_steps
        want["int4_matmul_prefill_tiled" if tiled else "int4_matmul_prefill"] = (
            4 * n_layers * prefills)
    if llama.proj is not None:
        kernel = "int8_matmul" if isinstance(llama.proj["wo"], Int8Weight) else "int4_matmul"
        want[kernel] = 7 * n_layers * (decode_steps + prefills)
    return want


def _capture_waypoints(eng) -> dict:
    """Record every finished slot's per-step waypoints, by request seed."""
    wps = {}
    finalize = eng._finalize

    def wrapped(slot):
        wps[slot.seed] = np.stack(slot.wps)
        return finalize(slot)

    eng._finalize = wrapped
    return wps


def _raw_prompt(cfg, seed, n):
    """n random prompt ids with the image sentinel, and 10 unique frames."""
    ids = np.random.default_rng(seed).integers(3, 1000, size=(1, n))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    video, frame_map = random_video(cfg, seed)
    return ids, video, frame_map


def phase_compaction(model, cfg, kv_quant=None, prompt_len=20) -> dict:
    """test_compact_bit_equal_stream's scenario with this model: two
    engines (2 slots, 1024 positions, chunks of 4, temperature 0.5)
    run request 0 out while request 1, joined behind it, is mid-generation;
    engine A then compacts (B8) and engine B does not. Request 1's tokens
    and every waypoint must be bit-equal in A and B. The launches of both
    runs are counted exactly. A third engine then ends request 1 on an
    EOS id (_eos_replay). Returns per-layer times (ms): join, chunk step,
    compaction."""
    dev = model.llama.embed_tokens.weight.device
    (ids0, v0, fm), (ids1, v1, _) = (_raw_prompt(cfg, 1, prompt_len),
                                     _raw_prompt(cfg, 2, prompt_len))
    times = {"join_ms": [], "step_ms": [], "compact_ms": []}

    def timed(key, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def drive(do_compact):
        # no EOS id: the scenario needs request 0 to run its 6 tokens and
        # request 1 its 18, whatever a random model samples; _eos_replay
        # ends request 1 on an EOS id afterwards
        eng = ContinuousEngine(model, cfg, slots=2, max_len=1024, chunk=4, temperature=0.5,
                               kv_quant=kv_quant, eos_token_id=-1)
        wps = _capture_waypoints(eng)
        timed("join_ms", lambda: eng.join(ids0, v0, seed=11, max_new=6, frame_map=fm))
        timed("step_ms", eng.step)
        timed("join_ms", lambda: eng.join(ids1, v1, seed=22, max_new=18, frame_map=fm))
        while eng.slots[0].busy:
            timed("step_ms", eng.step)
        if not eng.slots[1].busy:
            raise AssertionError("request 1 finished before the compaction point")
        pos = eng.pos
        if do_compact:
            reclaimed = timed("compact_ms", eng.compact)
            log(f"  engine A compacted: cursor {pos} -> {eng.pos} ({reclaimed} positions "
                f"reclaimed)")
            if reclaimed <= 0 or eng.compactions != 1:
                raise AssertionError("compaction reclaimed nothing")
        outs = []
        while not outs:
            outs += [o for _, o in timed("step_ms", eng.step)]
        return outs[0], wps[22], eng

    _sync(dev)
    reset_launches()
    (a, wa, ea), (b, wb, eb) = drive(True), drive(False)
    _sync(dev)
    counts = read_launches()
    n = int(a.num_tokens[0])
    same = (np.array_equal(a.sequences, b.sequences) and np.array_equal(wa, wb)
            and np.array_equal(a.pred_hands, b.pred_hands))
    log(f"  request 1 after compaction: {n} tokens {a.sequences[0, :n].tolist()}, "
        f"{int(a.num_hands[0])} hand tokens; bit-equal to the uncompacted engine: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("compaction changed a live request's stream")
    _eos_replay(model, cfg, kv_quant, (ids0, v0), (ids1, v1), fm, b.sequences[0, :n])
    steps, prefills = ea.decode_steps + eb.decode_steps, ea.prefills + eb.prefills
    expect_launches(counts, serving_launches(model, cfg, kv_quant, steps, prefills,
                                             ea.compactions + eb.compactions))
    out = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  serving layer times, median (ms): join {out['join_ms']:.2f}, chunk of 4 steps "
        f"{out['step_ms']:.2f}, compaction {out['compact_ms']:.2f}")
    return out


def _eos_replay(model, cfg, kv_quant, req0, req1, frame_map, stream) -> None:
    """The end of a request on EOS: the compaction scenario's two requests
    once more, with request 1's 10th token as the engine's EOS id. Rows
    are independent, so request 1 must come out cut after the first
    occurrence of that token, equal to `stream` (its tokens with no EOS id)
    up to there."""
    eos = int(stream[9])
    stop = int(np.flatnonzero(stream == eos)[0]) + 1
    eng = ContinuousEngine(model, cfg, slots=2, max_len=1024, chunk=4, temperature=0.5,
                           kv_quant=kv_quant, eos_token_id=eos)
    eng.join(*req0, seed=11, max_new=6, frame_map=frame_map)
    eng.step()
    row = eng.join(*req1, seed=22, max_new=18, frame_map=frame_map)
    out = None
    while out is None:
        out = next((o for r, o in eng.step() if r == row), None)
    got = out.sequences[0, :int(out.num_tokens[0])]
    same = np.array_equal(got, stream[:stop])
    log(f"  request 1 with EOS id {eos}: {len(got)} tokens, ends on EOS, equal to the first "
        f"{stop} of its stream without: {'ok' if same else 'FAIL'}")
    if not same or (out.sequences[0, stop:] != sampler.PAD_TOKEN_ID).any():
        raise AssertionError(f"request 1 did not end on its EOS id {eos}: {got.tolist()}")


class EkClips:
    """An in-memory dataset with the EK100 evaluation schema: per clip 10
    unique frames tiled x10 to the model's frame count, an EK-style
    instruction, and future hands (2, 5, 2) in [0, 1) from a seed."""

    ACTIONS = ("open the fridge", "take the knife", "wash the cup", "cut the onion",
               "pour the water", "close the drawer", "stir the pan", "put down the plate")

    def __init__(self, cfg, n, seed=0):
        self.cfg, self.n, self.seed = cfg, n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 1000 + i)
        size = self.cfg.vision.image_size
        n_unique = min(10, self.cfg.num_frames)
        frames = rng.normal(size=(n_unique, 3, size, size)).astype(np.float32)
        reps = -(-self.cfg.num_frames // n_unique)
        template = ACTION_QUESTION_TEMPLATES[i % len(ACTION_QUESTION_TEMPLATES)]
        return {"prompt": template.format(self.ACTIONS[i % len(self.ACTIONS)]),
                "image": np.tile(frames, (reps, 1, 1, 1))[:self.cfg.num_frames],
                "future_hands": rng.uniform(size=(2, 5, 2)).astype(np.float32),
                "future_valid": np.ones(2, np.float32)}


def _scored(name, res, n_clips) -> None:
    finite = all(np.isfinite(res[k]) for k in ("ade", "fde", "wde"))
    log(f"  {name}: {len(res['val_info'])} clips, n={res['n']} with a trajectory, "
        f"ADE {res['ade']:.4f} FDE {res['fde']:.4f} WDE {res['wde']:.4f}")
    if len(res["val_info"]) != n_clips or (res["n"] > 0 and not finite):
        raise AssertionError(f"{name}: not every clip was scored")


def phase_eval(model, cfg, tokenizer, n_clips=16, serial_clips=2, max_new=32, slots=8,
               max_len=SERVE_LEN, chunk=16, burst=24, burst_slots=4, burst_len=2048,
               burst_chunk=8, burst_gap_s=0.05) -> dict:
    """EK100 evaluation over the int8 cache: serial on `serial_clips`,
    batched on all clips, then a staggered burst through the scheduler
    (max_new cycling 8 / 24 / 48) that runs the cursor out. Launches are
    counted over the three and checked exactly; then a greedy pass checks
    each clip's first token, serial against batched."""
    dev = model.llama.embed_tokens.weight.device
    data = EkClips(cfg, n_clips)
    engine = InferenceEngine(model=model, cfg=cfg, tokenizer=tokenizer, temperature=0.5,
                             top_p=0.9, max_new_tokens=max_new, kv_quant="int8")
    stats = {}
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()

    t0 = time.perf_counter()
    serial = evaluate_epic_kitchen_traj(engine, data, seed=0, log_every=0, limit=serial_clips)
    _sync(dev)
    wall = time.perf_counter() - t0
    toks = [v["num_tokens"] for v in serial["val_info"].values()]
    stats["serial_tok_s"] = sum(toks) / wall
    _scored(f"serial evaluation ({serial_clips} clips, {sum(toks)} tokens, {wall:.2f} s)",
            serial, serial_clips)

    t0 = time.perf_counter()
    batched = evaluate_epic_kitchen_traj(engine, data, seed=0, log_every=0, batched=slots,
                                         batched_max_len=max_len, batched_chunk=chunk)
    _sync(dev)
    wall = time.perf_counter() - t0
    n_tok = sum(v["num_tokens"] for v in batched["val_info"].values())
    stats["batched_tok_s"] = n_tok / wall
    _scored(f"batched evaluation ({slots} slots, {n_clips} clips, {n_tok} tokens, "
            f"{wall:.2f} s)", batched, n_clips)
    (eval_sched,) = engine._batched_scheds.values()

    # the burst: requests arrive `burst_gap_s` apart on fewer slots and a
    # shorter cache, so the cursor runs out and the scheduler compacts
    sched = ContinuousScheduler(model, cfg, slots=burst_slots, max_len=burst_len,
                                chunk=burst_chunk, temperature=0.5, top_p=0.9, kv_quant="int8")
    prepared = []
    for i in range(n_clips):
        item = data[i]
        images, fmap = engine.dedup_frames(item["image"][None])
        prepared.append((engine.build_prompt_ids(item["prompt"]),
                         torch.as_tensor(images, device=dev, dtype=engine.dtype), fmap))
    outs, errs = {}, {}

    def one(i, max_new_i):
        ids, images, fmap = prepared[i % n_clips]
        try:
            outs[i] = (max_new_i, sched.submit(ids, images, seed=i, max_new=max_new_i,
                                               frame_map=fmap, timeout=600))
        except Exception as e:  # noqa: BLE001 - reported below
            errs[i] = repr(e)

    threads = []
    t0 = time.perf_counter()
    for i in range(burst):
        threads.append(threading.Thread(target=one, args=(i, (8, 24, 48)[i % 3])))
        threads[-1].start()
        time.sleep(burst_gap_s)
    for t in threads:
        t.join()
    _sync(dev)
    wall = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"burst requests failed: {errs}")
    truncated = [i for i, (mn, o) in outs.items()
                 if int(o.num_tokens[0]) != mn
                 and int(o.sequences[0, int(o.num_tokens[0]) - 1]) != sched.engine.eos]
    n_tok = sum(int(o.num_tokens[0]) for _, o in outs.values())
    ttft = np.asarray(sched.ttfts) * 1e3
    stats.update(burst_tok_s=n_tok / wall, ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p95_ms=float(np.percentile(ttft, 95)))
    log(f"  burst: {burst} requests {burst_gap_s * 1e3:.0f} ms apart, {n_tok} tokens in "
        f"{wall:.2f} s, {sched.engine.compactions} compactions, {len(truncated)} truncated, "
        f"join groups {sched.engine.join_group_sizes}")
    _sync(dev)
    counts = read_launches()

    serial_steps = sum(t - 1 for t in toks)
    steps = serial_steps + eval_sched.engine.decode_steps + sched.engine.decode_steps
    prefills = serial_clips + eval_sched.engine.prefills + sched.engine.prefills
    compactions = eval_sched.engine.compactions + sched.engine.compactions
    expect_launches(counts, serving_launches(model, cfg, "int8", steps, prefills, compactions))
    if sched.engine.compactions < 1 or truncated:
        raise AssertionError(f"burst: {sched.engine.compactions} compactions (need >= 1), "
                             f"truncated requests {truncated}")
    log(f"  tokens/s: batched {stats['batched_tok_s']:.2f}, serial {stats['serial_tok_s']:.2f} "
        f"(x{stats['batched_tok_s'] / stats['serial_tok_s']:.2f}), burst "
        f"{stats['burst_tok_s']:.2f}; burst first-token latency p50 "
        f"{stats['ttft_p50_ms']:.1f} ms, p95 {stats['ttft_p95_ms']:.1f} ms; scheduler "
        f"estimates: step {sched._step_s} s, join {sched._join_s} s")
    if dev.type == "cuda":
        log(f"  peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    sched.stop()
    eval_sched.stop()
    del sched, eval_sched
    engine._batched_scheds.clear()

    # greedy: a clip's first token comes from its own prefill, serially or
    # through a group join
    greedy = InferenceEngine(model=model, cfg=cfg, tokenizer=tokenizer, temperature=0.0,
                             max_new_tokens=4, kv_quant="int8")
    g_serial = evaluate_epic_kitchen_traj(greedy, data, seed=0, log_every=0,
                                          limit=serial_clips)
    g_batched = evaluate_epic_kitchen_traj(greedy, data, seed=0, log_every=0,
                                           limit=serial_clips, batched=serial_clips,
                                           batched_max_len=burst_len, batched_chunk=4)
    first = [(int(g_serial["val_info"][i]["gen_ids"][0]),
              int(g_batched["val_info"][i]["gen_ids"][0])) for i in range(serial_clips)]
    for s in greedy._batched_scheds.values():
        s.stop()
    greedy._batched_scheds.clear()
    log(f"  greedy first token per clip (serial, batched={serial_clips}): {first}")
    if any(a != b for a, b in first):
        raise AssertionError("greedy first tokens differ between serial and batched")
    stats["launches"] = counts
    return stats


def long_instruction(cfg, tokenizer, rows=LONG_ROWS) -> str:
    """An instruction whose chat prompt has at least `rows` rows after the
    splice: EK-style requests, one after another."""
    n_visual = cfg.num_visual_tokens - 1
    parts, i = [], 0
    while True:
        action = EkClips.ACTIONS[i % len(EkClips.ACTIONS)]
        parts.append(f"Step {i + 1}: " + ACTION_QUESTION_TEMPLATES[
            i % len(ACTION_QUESTION_TEMPLATES)].format(action))
        i += 1
        if i % 8 == 0 or rows < 200:
            text = " ".join(parts)
            if prompt_ids(new_conversation(), tokenizer, text).shape[1] + n_visual >= rows:
                return text


def phase_long_prompt(model, cfg, tokenizer, video, frame_map, kv_quant=None, rows=LONG_ROWS,
                      new_tokens=16):
    """One chat turn whose prompt is `rows` rows or a little more: on the
    card the prefill goes through the flash kernel, once per layer, and
    every decode step through the stacked decode kernel. Returns (the
    instruction, the launch counts)."""
    dev = model.llama.embed_tokens.weight.device
    text = long_instruction(cfg, tokenizer, rows)
    conv = new_conversation()
    gen = torch.Generator(device=dev).manual_seed(0)
    stamps = []
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = chat_turn(model, cfg, tokenizer, conv, text, video, frame_map, gen,
                    max_new_tokens=new_tokens, temperature=0.5, top_p=0.9,
                    on_token=lambda _tok: stamps.append(time.perf_counter()),
                    kv_quant=kv_quant)
    _sync(dev)
    counts = read_launches()
    n = int(out.num_tokens[0])
    toks = out.sequences[0, :n]
    if n < 1 or toks.min() < 0 or toks.max() >= cfg.llama.vocab_size:
        raise AssertionError(f"the long turn produced bad tokens {toks}")
    n_rows = prompt_ids(new_conversation(), tokenizer, text).shape[1] + cfg.num_visual_tokens - 1
    rate = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else float("nan")
    log(f"  prompt {n_rows} rows after the splice, {n} tokens, first-token "
        f"{(stamps[0] - t0) * 1e3:.1f} ms, decode {rate:.2f} tok/s")
    if dev.type == "cuda":
        log(f"  peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if n_rows < rows:
        raise AssertionError(f"the long prompt has {n_rows} rows, need {rows}")
    want = serving_launches(model, cfg, kv_quant, n - 1, 1, 0)
    if n_rows >= 2048:
        want["flash_attention"] = cfg.llama.num_layers
    expect_launches(counts, want)
    return text, counts


def _window_vs_steps(model, cfg, ids, images, frame_map, tokens, kv_quant):
    """Teacher-forced: the hidden rows of one window of len(tokens)
    positions (the kernels) against the same positions decoded one at a
    time with the kernels and with the plain versions, from one prefill
    each. Returns the largest relative L2 over the rows of (window vs
    single steps, plain single steps vs single steps)."""
    max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + len(tokens) + 2
    no_waypoint = torch.zeros((1, 2, 2), device=ids.device)
    feed = torch.as_tensor(tokens, device=ids.device).long()
    embs = torch.cat([embed_next_token(model, cfg, feed[i:i + 1], no_waypoint)
                      for i in range(len(tokens))])[None]

    def run(impl, window):
        _, cache, mask = sampler.prefill(model, cfg, ids, images, max_len, attn_impl=impl,
                                         frame_map=frame_map, kv_quant=kv_quant)
        chunks = [embs] if window else [embs[:, i:i + 1] for i in range(len(tokens))]
        rows = [apply_llama(model.llama, cfg.llama, inputs_embeds=c, attn_mask=mask,
                            kv_cache=cache, attn_impl=impl)[0][0] for c in chunks]
        return torch.cat(rows).float()

    win, steps, plain = run("auto", True), run("auto", False), run("xla", False)
    per_row = lambda a, b: float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())  # noqa: E731
    return per_row(win, steps), per_row(plain, steps)


def phase_spec(model, cfg, tokenizer, video, frame_map, kv_quant=None, new_tokens=32,
               k=SPEC_K, window_exact=False) -> dict:
    """Speculative chat, greedy, the gate off: run A with an empty bank,
    run B with run A's stream as its bank; each through the chat CLI's turn
    function on a fresh conversation. Checks the forwards saved, every
    kernel's launches per forward, the cache index after every forward and
    the rows of one verify window against single steps (with
    `window_exact`, on the card, bit-equal: every op of the forward reduces
    a row alone); prints how far run A agrees with sequential greedy decode,
    and a sampled run with the gate on. Returns run A's launch counts."""
    dev = model.llama.embed_tokens.weight.device
    question = "What is the person doing in this video?"
    n_layers = cfg.llama.num_layers
    ids = torch.as_tensor(prompt_ids(new_conversation(), tokenizer, question), device=dev)
    t_prompt = ids.shape[1] + cfg.num_visual_tokens - 1

    def turn(bank, temperature=0.0, gate=0.0, spec_k=k):
        stats = {}
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        out = chat_turn(model, cfg, tokenizer, new_conversation(), question, video, frame_map,
                        torch.Generator(device=dev).manual_seed(0), max_new_tokens=new_tokens,
                        temperature=temperature, top_p=0.9, kv_quant=kv_quant, spec_k=spec_k,
                        bank_ids=bank, gate_tok_per_fwd=gate, spec_stats=stats)
        _sync(dev)
        stats["wall_s"] = time.perf_counter() - t0
        return out, stats, read_launches()

    def check(name, out, stats, counts):
        n = int(out.num_tokens[0])
        log(f"  {name}: {n} tokens in {stats['iters']} forwards "
            f"({(n - 1) / max(stats['iters'], 1):.2f} tok/fwd after the first), drafts found "
            f"{stats['drafts_found']}, accept_hist {stats['accept_hist']}, {stats['wall_s']:.2f} s")
        expect_launches(counts, serving_launches(model, cfg, kv_quant, stats["iters"], 1, 0))
        index = t_prompt
        for before, n_emit, after in stats["trace"]:
            if before != index or after != before + n_emit or not 1 <= n_emit <= k + 1:
                raise AssertionError(f"{name}: cache index {before} -> {after} after a forward "
                                     f"that emitted {n_emit}, expected to start at {index}")
            index = after
        if sum(e for _, e, _ in stats["trace"]) + 1 < n:
            raise AssertionError(f"{name}: {n} tokens from {stats['trace']}")
        return n

    out_a, stats_a, counts_a = turn(np.zeros((0,), np.int32))
    n_a = check("run A (empty bank)", out_a, stats_a, counts_a)
    bank = np.concatenate([[int(ids[0, -1])], out_a.sequences[0, :n_a]]).astype(np.int32)
    out_b, stats_b, counts_b = turn(bank)
    n_b = check("run B (bank = run A's stream)", out_b, stats_b, counts_b)
    same = int(np.cumprod(out_a.sequences[0, :n_a] == out_b.sequences[0, :n_a]).sum())
    log(f"  run B repeats run A on {same} of {n_a} tokens")
    if not stats_b["iters"] < n_b - 1:
        raise AssertionError(f"run B took {stats_b['iters']} forwards for {n_b} tokens: the "
                             "bank's drafts were not accepted")

    # printed, not asserted: a random bf16 7B has near-tied logits, and a
    # window's rows round elsewhere than single steps
    seq = chat_turn(model, cfg, tokenizer, new_conversation(), question, video, frame_map,
                    None, max_new_tokens=new_tokens, temperature=0.0, top_p=0.9,
                    kv_quant=kv_quant)
    prefix = int(np.cumprod(out_a.sequences[0, :n_a] == seq.sequences[0, :n_a]).sum())
    log(f"  run A equals sequential greedy decode on the first {prefix} of {n_a} tokens")

    with torch.inference_mode():
        d_win, d_plain = _window_vs_steps(model, cfg, ids, torch.as_tensor(video, device=dev),
                                          frame_map, out_a.sequences[0, :k + 1], kv_quant)
    exact = window_exact and torch.cuda.is_available()
    limit = 0.0 if exact else max(BF16_VS_PLAIN * d_plain, FP32_REL_L2)
    log(f"  one T={k + 1} window against the same positions decoded one at a time, largest "
        f"relative L2 over the rows: {d_win:.3e}; the plain path's single steps against the "
        f"kernels': {d_plain:.3e} (limit {'0, bit-equal' if exact else f'{limit:.3e}'})")
    if not (np.isfinite(d_win) and d_win <= limit):
        raise AssertionError("a verify window's rows lie further from single-step rows than "
                             "allowed")

    out_s, stats_s, _ = turn(None, temperature=0.5, gate=1.2)
    log(f"  sampled run (temperature 0.5, top-p 0.9, template bank, gate 1.2 tok/fwd): "
        f"{int(out_s.num_tokens[0])} tokens in {stats_s['iters']} forwards, gated "
        f"{stats_s['gated']}, accept_hist {stats_s['accept_hist']}, {stats_s['wall_s']:.2f} s")
    return counts_a


def phase_eval_batched(model, cfg, tokenizer, n_clips=8, slots=8, chunk=8, max_new=32,
                       max_len=SERVE_LEN, kv_quant=None) -> dict:
    """Batched EK100 evaluation (`evaluate --batched` with the model's
    weights, the cache `kv_quant`): n_clips in-memory clips on `slots`
    slots, chunks of `chunk` steps, temperature 0.5 / top-p 0.9. Every clip
    is scored, none is truncated (each runs to max_new tokens or EOS), and
    the launches are exact. Returns the aggregate tok/s and the counts."""
    dev = model.llama.embed_tokens.weight.device
    engine = InferenceEngine(model=model, cfg=cfg, tokenizer=tokenizer, temperature=0.5,
                             top_p=0.9, max_new_tokens=max_new, kv_quant=kv_quant)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate_epic_kitchen_traj(engine, EkClips(cfg, n_clips, seed=1), seed=0, log_every=0,
                                     batched=slots, batched_max_len=max_len,
                                     batched_chunk=chunk)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = read_launches()
    (sched,) = engine._batched_scheds.values()
    eng = sched.engine
    n_tok = sum(v["num_tokens"] for v in res["val_info"].values())
    _scored(f"batched evaluation ({slots} slots, {n_clips} clips, {n_tok} tokens, {wall:.2f} s)",
            res, n_clips)
    truncated = [i for i, v in res["val_info"].items()
                 if v["num_tokens"] != max_new and int(v["gen_ids"][-1]) != eng.eos]
    stats = {"batched_tok_s": n_tok / wall, "launches": counts}
    log(f"  aggregate {stats['batched_tok_s']:.2f} tok/s; {eng.prefills} prefills, "
        f"{eng.decode_steps} decode forwards, {eng.compactions} compactions, "
        f"{len(truncated)} truncated")
    if dev.type == "cuda":
        log(f"  peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    sched.stop()
    engine._batched_scheds.clear()
    if truncated:
        raise AssertionError(f"batched evaluation truncated clips {truncated}")
    expect_launches(counts, serving_launches(model, cfg, kv_quant, eng.decode_steps,
                                             eng.prefills, eng.compactions))
    return stats


def flat_int4(llama, cfg) -> torch.nn.ModuleDict:
    """The fused int4 projections of `llama` (tiled) in the flat stacked
    layout: new buffers, the bytes by the inverse permute of the tiled
    ones."""
    out = torch.nn.ModuleDict()
    for name, (din, dout) in int4_projection_shapes(cfg).items():
        w = Int4Weight(din, dout, cfg.num_layers, device=llama.norm.weight.device, flat=True)
        w4, gs = untile_int4_stacked(*llama.int4[name].packed())
        w.w4.copy_(w4)
        w.gscale.copy_(gs)
        out[name] = w
    return out


def per_projection_int4(fused, cfg) -> torch.nn.ModuleDict:
    """The seven per-projection flat int4 leaves, sliced by columns from the
    fused flat buffers `fused`: the scales are per (group, column), so each
    slice is the quantization of its own projection."""
    qh, kh = cfg.num_heads * cfg.head_dim_, cfg.kv_heads * cfg.head_dim_
    f, d = cfg.intermediate_size, cfg.hidden_size
    cols = {"wq": ("wqkv", 0, qh), "wk": ("wqkv", qh, qh + kh),
            "wv": ("wqkv", qh + kh, qh + 2 * kh), "wo": ("wo", 0, d),
            "w_gate": ("wgu", 0, f), "w_up": ("wgu", f, 2 * f), "w_down": ("w_down", 0, d)}
    out = torch.nn.ModuleDict()
    for name, (din, dout) in projection_shapes(cfg).items():
        src, a, b = cols[name]
        w = Int4Weight(din, dout, cfg.num_layers, device=fused[src].w4.device, flat=True)
        w.w4.copy_(fused[src].w4[..., a:b])
        w.gscale.copy_(fused[src].gscale[..., a:b])
        out[name] = w
    return out


def phase_flat_int4(model, cfg, tokenizer, video, frame_map):
    """A greedy prefill and 4 decode steps over the int8 cache with the
    fused int4 projections tiled (B5b, B4b) and then in the flat layout
    (B5a, B4c), the launches of both counted exactly: the flat run's tokens
    and final hidden states must be bit-equal to the tiled run's. Leaves the
    tiled layout installed. Returns (the flat run's counts, the seven
    per-projection flat leaves sliced from the flat buffers)."""
    llama = model.llama
    tiled = llama.int4
    flat = flat_int4(llama, cfg.llama)
    args = _greedy_args(model, cfg, tokenizer, video, frame_map)
    runs = []
    with torch.inference_mode():
        for layout in (tiled, flat):
            llama.int4 = layout
            reset_launches()
            runs.append((*_greedy_decode(*args, "auto", kv_quant="int8"), read_launches()))
            expect_launches(runs[-1][2], serving_launches(model, cfg, "int8", 4, 1, 0))
    llama.int4 = tiled
    (h_t, tok_t, _), (h_f, tok_f, counts) = runs
    same = torch.equal(h_t, h_f) and tok_t == tok_f
    log(f"  greedy tokens tiled {tok_t}, flat {tok_f}; final hidden bit-equal: "
        f"{'ok' if same else 'FAIL'} (relative L2 {_rel(h_f, h_t):.3e})")
    if not same:
        raise AssertionError("the flat int4 layout does not give the tiled layout's bits")
    proj = per_projection_int4(flat, cfg.llama)
    del flat
    return counts, proj


def phase_fused_mlp(model, cfg, rows: int = 1) -> dict:
    """13c: B11 over the int4 model's own weights, the MLP half of every
    layer for one decode token (the JAX package's tools/perf_fused_mlp.py
    chain): each layer's fused gate|up leaf split into gate and up tiles of
    256 columns, the gate opened (HANDSONVLM_FUSED_MLP=1, `fused_mlp_ok`),
    `rows` random hidden rows through the 32 fused layers with the launch
    counts set to 0 before and read after. Held by phase 4's rule: the chain
    in bf16 through B11 may lie at most BF16_VS_PLAIN x as far from the
    plain chain with f32 rows as the plain chain in bf16 does. Then the
    fused chain and the port's unfused chain (B4b) timed. Returns the
    counts."""
    llama, lcfg = model.llama, cfg.llama
    d, f, eps = lcfg.hidden_size, lcfg.intermediate_size, lcfg.rms_norm_eps
    wgu = {"w4t": llama.int4["wgu"].w4t, "gst": llama.int4["wgu"].gst}
    wd = {"w4t": llama.int4["w_down"].w4t, "gst": llama.int4["w_down"].gst}
    wg, wu = split_wgu_tiled(wgu, f)
    nrm = torch.stack([lp.post_attention_layernorm.weight for lp in llama.layers])
    gen = torch.Generator(device="cuda").manual_seed(17)
    h0 = torch.randn((rows, d), generator=gen, device="cuda")
    previous = os.environ.get("HANDSONVLM_FUSED_MLP")
    os.environ["HANDSONVLM_FUSED_MLP"] = "1"
    try:
        if not fused_mlp_ok({"wg": wg, "wu": wu, "w_down": wd}, d, 1, rows):
            raise AssertionError("13c: fused_mlp_ok refuses the int4 model's split weights")
    finally:
        if previous is None:
            os.environ.pop("HANDSONVLM_FUSED_MLP")
        else:
            os.environ["HANDSONVLM_FUSED_MLP"] = previous

    def chain(h, fn):
        for i in range(lcfg.num_layers):
            h = fn(h, i)
        return h

    with torch.inference_mode():
        reset_launches()
        h_k = chain(h0.to(torch.bfloat16), lambda h, i: fused_mlp_stacked(h, nrm, wg, wu, wd, i,
                                                                          eps))
        torch.cuda.synchronize()
        counts = read_launches()

        def ref(h, i):
            return fused_mlp_stacked_ref(h, nrm, wg, wu, wd, i, eps)

        h_p, h_32 = chain(h0.to(torch.bfloat16), ref), chain(h0, ref)
        h_u = chain(h0.to(torch.bfloat16), lambda h, i: unfused_mlp(h, nrm, wgu, wd, i, eps))
        expect_launches(counts, {"fused_mlp_stacked": lcfg.num_layers})
        d_k, d_p = _rel(h_k, h_32), _rel(h_p, h_32)
        log(f"  13c the {lcfg.num_layers}-layer MLP chain, {rows} row(s): relative L2 from the "
            f"plain chain in f32: B11 {d_k:.3e}, plain bf16 {d_p:.3e} (ratio "
            f"{d_k / d_p if d_p else float('nan'):.3f}, limit {BF16_VS_PLAIN}); the unfused "
            f"chain (B4b) {_rel(h_u, h_32):.3e}")
        if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
            raise AssertionError(f"13c: B11's chain lies {d_k:.3e} from the f32 chain, limit "
                                 f"{BF16_VS_PLAIN * d_p:.3e}")
        h = h0.to(torch.bfloat16)
        chains = {"fused": lambda: chain(h, lambda x, i: fused_mlp_stacked(
                      x, nrm, wg, wu, wd, i, eps)),
                  "unfused": lambda: chain(h, lambda x, i: unfused_mlp(x, nrm, wgu, wd, i, eps))}
        graph = {k: graph_time_ms(fn) for k, fn in chains.items()}
        eager = {k: cuda_time_ms(lambda _: fn(), iters=10, warmup=2) for k, fn in chains.items()}
    log(f"  13c time, the {lcfg.num_layers}-layer MLP chain at B={rows} (bf16), fused (B11, "
        f"{lcfg.num_layers} launches) / unfused (rms_norm, B4b, silu * up, B4b, the residual): "
        f"replayed from a CUDA graph (device time) {graph['fused']:.4f} / "
        f"{graph['unfused']:.4f} ms; issued eagerly (the host's launch rate may bound it) "
        f"{eager['fused']:.4f} / {eager['unfused']:.4f} ms")
    del wg, wu
    return counts


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def phase_cli(device: str = "cuda", preset: str = "7b", r: int = LORA_R, steps: int = 2) -> dict:
    """15: the training CLI (`handsonvlm_torch.train.train`) at `preset`:
    `--qlora int8_fused --lora-r r --synthetic 4 --samples-per-epoch 4
    --batch-size 1 --max-steps steps --log-every 1` into a temporary
    directory, in this process (its returned state kept); the checkpoint
    restored into a fresh template must be bit-equal to it. Then the same
    command with `--max-steps steps + 1` as its own process must print
    `resumed from step <steps>` and run one step; its checkpoint's bytes and
    its save and restore seconds are printed. The LoRA artifact loaded by
    the builder (merged into the base) answers one chat turn. The directory
    is removed. Returns the launches of B10a / B10b in the first run."""

    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="handsonvlm_train_")
    log(f"  15 output directory {out}: {shutil.disk_usage(out).free / 2**30:.1f} GiB free")
    argv = ["--model-path", f"random:{preset}", "--preset", preset, "--qlora", "int8_fused",
            "--lora-r", str(r), "--synthetic", "4", "--samples-per-epoch", "4",
            "--batch-size", "1", "--log-every", "1", "--output-dir", out, "--device", device]
    try:
        reset_launches()
        t0 = time.perf_counter()
        first = train_cli.main(argv + ["--max-steps", str(steps)])
        counts = read_launches()
        log(f"  15 first run: {steps} steps in {time.perf_counter() - t0:.2f} s (model built, "
            f"steps, checkpoint and artifacts); launches {({k: v for k, v in counts.items() if v})}")
        if device == "cuda" and not (counts["int8_stacked_fwd"] and counts["int8_stacked_bwd"]):
            raise AssertionError("15: the CLI's int8_fused steps did not run B10a / B10b")
        template_model, cfg, _ = load_pretrained_model(f"random:{preset}", preset, device,
                                                       quantize="int8_fused")
        template_model.lora = init_lora(torch.Generator(device=device).manual_seed(0), cfg.llama,
                                        r, LORA_ALPHA, device=device)
        template = create_train_state(template_model, make_optimizer(
            template_model, TRAIN_LR, freeze_top_keys=("vision", "llama")))
        t0 = time.perf_counter()
        restore_train_state(os.path.join(out, "checkpoints"), template)
        _sync(device)
        restore_s = time.perf_counter() - t0
        want, got = first.model.state_dict(), template.model.state_dict()
        w_opt = first.optimizer.state_dict()["state"]
        g_opt = template.optimizer.state_dict()["state"]
        same = (template.step == first.step == steps and sorted(got) == sorted(want)
                and all(torch.equal(got[k], want[k]) for k in want)
                and template.optimizer.count == first.optimizer.count
                and sorted(w_opt) == sorted(g_opt)
                and all(torch.equal(g_opt[i][k], w_opt[i][k]) for i in w_opt for k in w_opt[i]))
        nbytes = _dir_bytes(os.path.join(out, "checkpoints", str(steps)))
        log(f"  15 checkpoint {steps}: {nbytes} bytes ({nbytes / 2**30:.3f} GiB), restored into a "
            f"fresh template in {restore_s:.3f} s, bit-equal to the saved state (model "
            f"{len(want)} tensors, optimizer {len(w_opt)} moments): {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("15: the restored train state differs from the saved one")
        del first, template, template_model, want, got, w_opt, g_opt
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        cmd = [sys.executable, "-m", "handsonvlm_torch.train.train", *argv,
               "--max-steps", str(steps + 1)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"    | {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise AssertionError(f"15: the resumed CLI run exited {proc.returncode}")
        steps_run = [json.loads(line)["step"] for line in proc.stdout.splitlines()
                     if line.startswith("{")]
        if f"resumed from step {steps}" not in proc.stdout or steps_run != [steps + 1]:
            raise AssertionError(f"15: the second run did not resume from step {steps} and run "
                                 f"one step (steps logged {steps_run})")
        log(f"  15 second run (its own process, {wall:.2f} s): resumed from step {steps}, ran "
            f"step {steps + 1}")

        model, cfg, tokenizer = load_pretrained_model(out, preset, device)
        video, frame_map = random_video(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        turn = chat_turn(model, cfg, tokenizer, new_conversation(),
                         "What is the person doing in this video?", video, frame_map, gen,
                         max_new_tokens=8, temperature=0.5, top_p=0.9)
        n = int(turn.num_tokens[0])
        toks = turn.sequences[0, :n]
        if n < 1 or toks.min() < 0 or toks.max() >= cfg.llama.vocab_size:
            raise AssertionError(f"15: the trained model's chat turn gave bad tokens {toks}")
        log(f"  15 the LoRA artifact merged into random:{preset} by the builder answers a chat "
            f"turn: {n} tokens {tokenizer.decode(toks)[:80]!r}")
        del model
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {k: counts[k] for k in ("int8_stacked_fwd", "int8_stacked_bwd")}


def _host_copy(module) -> dict:
    """The module's tensors copied to the host: the bit-identity check's
    reference, kept off the card so the steps' peak memory is their own."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def _bit_identical(module, before: dict, what: str) -> None:
    changed = [k for k, v in module.state_dict().items() if not torch.equal(v.cpu(), before[k])]
    log(f"  {what} bit-identical after the steps: {'ok' if not changed else 'FAIL'} "
        f"({len(before)} tensors)")
    if changed:
        raise AssertionError(f"{what} changed in training: {changed[:5]}")


def _moved(model, before: torch.Tensor, what: str) -> None:
    delta = float((model.lora.adapters["wq"].b.detach() - before).abs().max())
    log(f"  {what}: the adapters' b moved by up to {delta:.3e}")
    if not delta > 0:
        raise AssertionError(f"{what}: the adapters did not move")


def _train_launches(cfg, rows, **extra) -> dict:
    """Kernel launches of one train step: CLIP once (frozen, no graph); with
    a sample of FLASH_MIN_T rows or more, B3 per layer in the forward and
    again in its recompute (remat), B3b once per layer; `extra` per layer."""
    n_layers = cfg.llama.num_layers
    want = {"vit_attention": cfg.vision.num_layers + cfg.vision.select_layer + 1}
    if rows >= FLASH_MIN_T:
        want.update(flash_attention=2 * n_layers, flash_attention_bwd=n_layers)
    want.update({k: v * n_layers for k, v in extra.items()})
    return want


def _train_steps(model, cfg, opt, batch, steps: int, want: dict, label: str, remat="full"):
    """`steps` train steps (attn_impl="auto"), each with the launch counts
    set to 0 before it and held to `want` after it; per step the loss, wall
    ms, tokens/s and peak device memory. Returns (metrics, last counts,
    per-step (wall ms, peak GiB))."""
    device = model.llama.embed_tokens.weight.device
    cuda = device.type == "cuda"
    rows = batch["input_ids"].shape[1] + cfg.num_visual_tokens - 1
    step = make_train_step(cfg, opt, attn_impl="auto", remat=remat)
    state = create_train_state(model, opt)
    out, stats = [], []
    for i in range(steps):
        reset_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        m = step(state, batch, 0)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        log(f"  {label} step {i}: loss {m['loss']:.4f} (text {m['text_loss']:.4f}, traj "
            f"{m['traj_loss']:.4f}, kl {m['traj_kl_loss']:.4f}), grad_norm {m['grad_norm']:.4f}; "
            f"wall {wall:.1f} ms, {rows / wall * 1e3:.1f} tokens/s, peak {peak:.3f} GiB")
        launched = {k: v for k, v in counts.items() if v}
        log(f"    launches {launched} (expect {want})")
        if cuda and launched != want:
            raise AssertionError(f"{label}: launches {launched}, expected {want}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: metrics not finite: {m}")
        out.append(m)
        stats.append((wall, peak))
    return out, counts, stats


def _lora_grads(model, cfg, batch, eps, impl) -> torch.Tensor:
    """The adapters' gradients of one step's loss (no update), flattened."""
    device = model.llama.embed_tokens.weight.device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, cfg, batch, eps=eps, attn_impl=impl, remat="full")
    loss.backward()
    return torch.cat([p.grad.float().flatten() for p in model.lora.parameters()])


def phase_train_grads(model, cfg, batch, quantize=None, label="14e") -> None:
    """14e: one step's adapter gradients from the kernel route ("auto")
    against the plain route ("xla": plain attention and plain quantized
    products, B7's plain version their backward) in the model's dtype, and
    against the plain route in fp32 (a copy of the model and adapters with
    fp32 activations over the same `quantize`d weights, the reference), the
    same CVAE draws in all three. The kernel route may lie at most
    BF16_VS_PLAIN x the plain route's relative L2 distance from the
    reference."""
    device = model.llama.embed_tokens.weight.device
    gen = torch.Generator(device=device).manual_seed(14)
    eps = torch.randn((8, cfg.traj.latent_dim), generator=gen, device=device)
    g_k = _lora_grads(model, cfg, batch, eps, "auto")
    g_p = _lora_grads(model, cfg, batch, eps, "xla")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = build_model(cfg32, device, quantize=quantize)
    m32.lora = LoRA(cfg.llama, model.lora.adapters["wq"].a.shape[-1], 1.0, device=device)
    m32.load_state_dict(model.state_dict())
    g_32 = _lora_grads(m32, cfg32, batch, eps, "xla")
    del m32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    model.zero_grad(set_to_none=True)
    d_k, d_p = _rel(g_k, g_32), _rel(g_p, g_32)
    log(f"  {label} adapter gradients ({g_k.numel()} values), relative L2 from the fp32 plain "
        f"route: kernels {d_k:.3e}, plain {d_p:.3e} (ratio {d_k / d_p if d_p else float('nan'):.3f}, "
        f"limit {BF16_VS_PLAIN}); kernels vs plain {_rel(g_k, g_p):.3e}")
    if not (np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p):
        raise AssertionError(f"{label}: the kernel route's gradients lie {d_k:.3e} from the "
                             f"fp32 reference, limit {BF16_VS_PLAIN * d_p:.3e}")


def phase_train(model, cfg, rows: int = TRAIN_ROWS, r: int = LORA_R,
                alpha: float = LORA_ALPHA, steps: int = 3) -> dict:
    """Phase 14a-c on a bf16 model from `random:<preset>` (quantized in place
    on the way), batch 1, one sample of `rows` rows; returns the B3b, B7b
    and B7a launch counts of the steps that ran them.

    14a: LoRA (r, alpha) over the bf16 base, remat "full", `steps` steps: the
    loss finite, the base, CLIP and norms bit-identical, the adapters' b
    moved; 14e on the trained adapters; 14b: the base quantized to tiled int4
    (QLoRA int4), fresh adapters, `steps` steps through B5b and B7b, the
    packed weights bit-identical; 14c: the same fused projections untiled
    to the flat layout, one step through B5a and B7a."""
    device = model.llama.embed_tokens.weight.device
    batch = train_batch(cfg, rows)
    freeze = ("vision", "llama")
    gen = torch.Generator(device=device).manual_seed(1)
    counts = {}

    def adapters():
        model.lora = init_lora(gen, cfg.llama, r, alpha, device=device)
        return make_optimizer(model, TRAIN_LR, freeze_top_keys=freeze), \
            model.lora.adapters["wq"].b.detach().clone()

    log(f"phase 14a: LoRA r={r} alpha={alpha:g} over the {cfg.pdtype} base, {rows} rows, "
        f"remat full, {steps} steps")
    opt, b0 = adapters()
    frozen = {name: _host_copy(getattr(model, name)) for name in freeze}
    _, c, _ = _train_steps(model, cfg, opt, batch, steps, _train_launches(cfg, rows), "14a")
    for name in freeze:
        _bit_identical(getattr(model, name), frozen[name], f"14a {name}")
    del frozen
    _moved(model, b0, "14a")
    counts["flash_attention_bwd"] = c["flash_attention_bwd"]
    counts["flash_attention"] = c["flash_attention"]
    log("phase 14e: one step's adapter gradients, kernel route against the plain route")
    phase_train_grads(model, cfg, batch)

    log(f"phase 14b: QLoRA int4 (tiled), fresh adapters, {steps} steps")
    model.lora = opt = None
    quantize_llama_int4(model.llama, cfg.llama)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    opt, b0 = adapters()
    packed = _host_copy(model.llama.int4)
    _, c, _ = _train_steps(model, cfg, opt, batch, steps, _train_launches(
        cfg, rows, int4_matmul_prefill_tiled=8, int4_matmul_T_tiled=4), "14b")
    _bit_identical(model.llama.int4, packed, "14b packed int4 weights")
    _moved(model, b0, "14b")
    counts["int4_matmul_T_tiled"] = c["int4_matmul_T_tiled"]
    log("phase 14e-int4: one step's adapter gradients over the tiled int4 base, kernel route "
        "(B5b, B7b) against the plain route")
    phase_train_grads(model, cfg, batch, quantize="int4", label="14e-int4")

    log("phase 14c: QLoRA int4 over the flat layout (the same weights untiled), one step")
    model.llama.int4 = flat_int4(model.llama, cfg.llama)
    del packed
    opt, b0 = adapters()
    _, c, _ = _train_steps(model, cfg, opt, batch, 1, _train_launches(
        cfg, rows, int4_matmul_prefill=8, int4_matmul_T_flat=4), "14c")
    _moved(model, b0, "14c")
    counts["int4_matmul_T_flat"] = c["int4_matmul_T_flat"]
    model.lora = None
    model.requires_grad_(False)
    return counts


def phase_train_int8(model, cfg, rows: int = TRAIN_ROWS, r: int = LORA_R,
                     alpha: float = LORA_ALPHA) -> list:
    """14d: QLoRA int8 (the JAX package's 7B recommendation): one step over
    the int8 decoder, B9 seven times per layer in the forward and its
    recompute, the plain backward; the int8 weights bit-identical. Returns
    the step's (wall ms, peak GiB)."""
    device = model.llama.embed_tokens.weight.device
    log(f"phase 14d: QLoRA int8, r={r}, {rows} rows, one step")
    model.lora = init_lora(torch.Generator(device=device).manual_seed(2), cfg.llama, r, alpha,
                           device=device)
    b0 = model.lora.adapters["wq"].b.detach().clone()
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=("vision", "llama"))
    packed = _host_copy(model.llama.proj)
    batch = train_batch(cfg, rows)
    _, _, stats = _train_steps(model, cfg, opt, batch, 1,
                               _train_launches(cfg, rows, int8_matmul=14), "14d")
    _bit_identical(model.llama.proj, packed, "14d int8 weights")
    _moved(model, b0, "14d")
    log("phase 14e-int8: one step's adapter gradients over the int8 base, kernel route (B9, "
        "its plain backward) against the plain route")
    phase_train_grads(model, cfg, batch, quantize="int8", label="14e-int8")
    model.lora = None
    model.requires_grad_(False)
    return stats


def phase_train_int8_fused(model, cfg, unfused: list, rows: int = TRAIN_ROWS, r: int = LORA_R,
                           alpha: float = LORA_ALPHA, steps: int = 3) -> dict:
    """14f: QLoRA int8_fused over the same int8 weights (`--qlora
    int8_fused`): `steps` steps with every projection through B10a (the
    forward and its recompute) and B10b, B9 never; the int8 weights
    bit-identical, the adapters' b moved; step ms, tokens/s and peak beside
    14d's unfused step (`unfused`: its (wall ms, peak GiB)). Then
    14e-int8-fused: one step's adapter gradients through B10a / B10b against
    the fused plain route, phase 4's rule, the fp32 unfused plain route on
    the same int8 weights the reference. Returns B10a / B10b's launches of
    the last step."""
    device = model.llama.embed_tokens.weight.device
    log(f"phase 14f: QLoRA int8_fused, r={r} alpha={alpha:g}, {rows} rows, remat full, "
        f"{steps} steps")
    model.llama.quantize = "int8_fused"  # the int8 layout, routed through B10a / B10b
    model.lora = init_lora(torch.Generator(device=device).manual_seed(3), cfg.llama, r, alpha,
                           device=device)
    b0 = model.lora.adapters["wq"].b.detach().clone()
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=("vision", "llama"))
    packed = _host_copy(model.llama.proj)
    batch = train_batch(cfg, rows)
    _, counts, stats = _train_steps(
        model, cfg, opt, batch, steps,
        _train_launches(cfg, rows, int8_stacked_fwd=14, int8_stacked_bwd=7), "14f")
    _bit_identical(model.llama.proj, packed, "14f int8 weights")
    _moved(model, b0, "14f")
    wall, peak = min(w for w, _ in stats[1:] or stats), max(p for _, p in stats)
    log(f"  14f int8_fused step {wall:.1f} ms ({rows / wall * 1e3:.1f} tokens/s, best of the "
        f"steps after the first), peak {peak:.3f} GiB; 14d unfused int8 step "
        f"{unfused[0][0]:.1f} ms ({rows / unfused[0][0] * 1e3:.1f} tokens/s), peak "
        f"{unfused[0][1]:.3f} GiB; fused / unfused step {wall / unfused[0][0]:.3f}")
    log("phase 14e-int8-fused: one step's adapter gradients through B10a / B10b against the "
        "plain route (the fp32 unfused int8 route the reference)")
    phase_train_grads(model, cfg, batch, quantize="int8", label="14e-int8-fused")
    model.lora = None
    model.requires_grad_(False)
    model.llama.quantize = "int8"
    return {k: counts[k] for k in ("int8_stacked_fwd", "int8_stacked_bwd")}


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
    log(f"7B model (random:7b, seed 0) built on the card for training in "
        f"{time.perf_counter() - t0:.2f} s")
    train = phase_train(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()

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
    # a decode-attention call is one launch: its splits merge in the same
    # launch (a thread block cluster), so the wrapper's count is its calls
    check_launches(run, {"decode_attention_stacked": (n_layers, "decode_steps"),
                         "vit_attention": (n_clip, "clip_calls")})
    launches.update({k: run["launches"][k] for k in ("decode_attention_stacked",
                                                     "vit_attention")})
    log("phase 7a: compaction at 7B, bf16 cache, kernels")
    phase_compaction(model, cfg)
    log("phase 9a: a long prompt at 7B, bf16")
    long_text, counts = phase_long_prompt(model, cfg, tokenizer, video, frame_map)
    launches["flash_attention"] = counts["flash_attention"]
    log("phase 10a: speculative chat at 7B, bf16")
    phase_spec(model, cfg, tokenizer, video, frame_map)
    log("phase 4: bf16 kernel path against plain path at 7B, chat and long prompt")
    h_dense, tok_dense, launches["decode_attention"] = phase_kernel_vs_plain(
        model, cfg, tokenizer, video, frame_map, long_text=long_text)
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
    log("phase 7b: compaction at 7B, int4 weights + int8 cache, kernels")
    phase_compaction(model, cfg, kv_quant="int8")
    log("phase 8: EK100 evaluation at 7B, int4 weights + int8 cache")
    stats = phase_eval(model, cfg, tokenizer)
    launches["gather_cache_blocks"] = stats["launches"]["gather_cache_blocks"]
    log("phase 9b: a long prompt at 7B, int4 weights + int8 cache")
    _, counts = phase_long_prompt(model, cfg, tokenizer, video, frame_map, kv_quant="int8")
    launches["flash_attention"] += counts["flash_attention"]
    log("phase 10b: speculative chat at 7B, int4 weights + int8 cache")
    phase_spec(model, cfg, tokenizer, video, frame_map, kv_quant="int8")
    log("phase 13a: the fused int4 projections in the flat layout (B4c, B5a) against the tiled")
    counts, proj = phase_flat_int4(model, cfg, tokenizer, video, frame_map)
    launches.update({k: counts[k] for k in ("int4_gemv_flat", "int4_matmul_prefill")})
    log("phase 13c: B11 (the fused decode MLP) over the int4 model's 32 layers, one token")
    launches["fused_mlp_stacked"] = phase_fused_mlp(model, cfg)["fused_mlp_stacked"]
    log("phase 6 and 13b: int4 + kv8 kernel path against plain path at 7B, chat and long "
        "prompt, tiled; chat prompt, per-projection flat leaves (B4a)")
    counts = phase_quant_kernel_vs_plain(
        model, cfg, tokenizer, video, frame_map, fed=tok_dense, h_dense=h_dense,
        long_text=long_text, layouts={"tiled": (model.llama.int4, None),
                                      "per-projection flat": (None, proj)})
    launches["int4_matmul"] = counts["per-projection flat"]["int4_matmul"]
    del model, proj
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, cfg, tokenizer = load_pretrained_model("random:7b", "7b", "cuda", quantize="int8")
    torch.cuda.synchronize()
    log(f"7B int8 model (random:7b, seed 0, quantized on the card) built in "
        f"{time.perf_counter() - t0:.2f} s: {model_bytes(model) / 2**30:.3f} GiB on the card "
        f"(decoder int8 projections {model_bytes(model.llama.proj) / 2**30:.3f} GiB, "
        f"int8 head {model_bytes(model.llama.lm_head) / 2**30:.3f} GiB)")
    unfused = phase_train_int8(model, cfg)
    launches.update(phase_train_int8_fused(model, cfg, unfused))
    log("phase 11a: 7B int8 chat on the card, bf16 cache")
    run = phase_chat(model, cfg, tokenizer, video, frame_map)
    expect_launches(run["launches"], serving_launches(model, cfg, None, run["decode_steps"],
                                                      run["prefills"], 0))
    launches["int8_matmul"] = run["launches"]["int8_matmul"]
    log("phase 11b: speculative chat at 7B, int8 weights + int8 cache")
    phase_spec(model, cfg, tokenizer, video, frame_map, kv_quant="int8", window_exact=True)
    log("phase 11c: batched EK100 evaluation at 7B, int8 weights, 8 clips on 8 slots")
    phase_eval_batched(model, cfg, tokenizer)
    log("phase 12: int8 kernel path against plain path at 7B")
    phase_kernel_vs_plain(model, cfg, tokenizer, video, frame_map)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 15: the training CLI at 7B, --qlora int8_fused, LoRA r=128: 2 steps, a "
        "checkpoint, a resumed run, the adapter in a chat turn")
    phase_cli()

    launches["flash_attention"] += train.pop("flash_attention")
    launches.update(train)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
