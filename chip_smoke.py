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
   bytes and save / restore seconds;
16. the EK100 eval CLI at 7B over an EK100 layout written from seed 0
   (`phase_ek_cli`);
17. the HTTP serving stack at 7B in this process on 127.0.0.1 ephemeral
   ports (`phase_serving`): the controller, a bf16 worker (continuous
   batching on 4 slots, speculative decode, two r=128 LoRA adapters with
   one resident) with a burst of 8 requests, a stream, adapter requests,
   the web server's proxy and test_message; then an int4 + int8-cache
   worker with the dynamic batcher. Launches exact, the base model
   unchanged by the adapters, greedy first tokens of a burst as alone;
18. the HOI-forecast side: (b) LITA-HOI over the bf16 7B decoder of phase
   3 (no second decoder: new heads from seed 18), fuse mode 'hoi', 8 clips
   x 10 frames x 5 streams = 50 rows a clip with streams missing at some
   frames: B3 / B3b first held against their plain versions (and timed) at
   that shape, then the loss, its backward into the HOI encoder and the
   heads through the frozen decoder, the decoder's hidden states and the
   rollout, under attn_impl "auto" (plain at 50 rows) and "flash" (B3 32
   launches per encode, B3b 32 per backward); (c) `visual_pipeline` in the
   'origin' mode on 10 frames through the CLIP-L tower (B2, 23 launches)
   and the plain route. After phase 4 leaves the model in fp32, the same
   on the plain routes in fp32 is the reference of phase 4's rule for
   18b's hidden states and input gradients and 18c's tokens. (a) the
   hoi_train CLI at the reference width (embed 512, batch 128) over the
   EK100 layout with a train label: two epochs with evaluation, then the
   same command resuming from step 2;
19. parallelism (`phase_parallel`): (a) on this card, each rank's
   tensor-parallel shard at tp = 2 and 4 of the four fused 7B projections
   (tiled: B4b at m = 1, B5b at 391 rows; flat: B4c, B5a) and of the 32
   heads (B1 over a bf16 cache, B6 over an int8 one, T = 1 and 5), the
   ranks' outputs concatenated against the unsharded kernel by phase 2's
   rules; the tiled wgu (43 tiles) must be the one weight left whole; (b)
   one NCCL rank a card (`parallel/distributed.spawn`): the 7B model cut
   for each rank (`parallel/tp.shard_llama_tp`) in bf16 and in int4 +
   kv8, a greedy prefill and 4 steps fed rank 0's unsharded run's tokens,
   held by phase 4's rule against the fp32 reference on rank 0's card, a
   32-token greedy decode (launches exact, collectives a step, bytes a
   rank, step wall and device time); FSDP2 full SFT over the ranks
   (`parallel/partition.shard_model`), 2 steps on one 2048-row sample a
   rank, all 32 layers on two cards or more, 16 on one; the ring
   (`--seq-parallel N`): LoRA r = 128 over the bf16 base on one sample of
   2048 x N rows, its adapters' gradients held by phase 4's rule against
   the same rows' flash route (B3 / B3b) on rank 0's card alone, the fp32
   flash route the reference; (c) the train CLI's `--eval-every`: on one
   card the steered 7B model's evaluation of 4 EK clips (`steer_to_hand`,
   per-clip draws, n > 0, launches exact); on two cards or more, QLoRA
   int8_fused r = 128 at (2, N/2) and full SFT at (1, N) (with
   `phase_eval_parallel(every_base=True)` also LoRA r = 128, QLoRA int4
   and int8 at (1, N)), each steered, cut and sharded for training: one
   step, the sharded evaluation of 4 clips x 32 tokens
   (`eval.evaluator.evaluate_sharded`; wall, tok/s a data group, eval copy
   and peak GiB a rank, collectives a forward, launches exact on every
   rank) against rank 0's one-card evaluation of the gathered state (each
   clip's ids equal, its waypoints within EVAL_ABS; a planted wrong slice
   must fail that rule), then the next step; then the train CLI under
   torchrun with `--model-axis 2 --eval-every 1` (one `eval/*` line).

Phase 13c runs B11 over the int4 model's 32 layers for one token (the JAX
package's `tools/perf_fused_mlp.py` chain; no decoder takes B11), its
launches counted and the chain held by phase 4's rule against the plain
chain in f32, then timed against the unfused chain.

Phase 2 also checks B3b (the flash backward) at T = S = 2048 and 4096 and
B7a / B7b (the int4 transpose products) at the four fused 7B projections,
m = 16 and 2048. Phase 14 a-c runs right after phase 2 on its own
`random:7b` model, 14d and 14f on the int8 model before phase 11, phases
15 and 16 last (each CLI loads its own model), then 17, 18a and 19. Phases 7
to 10, 13a, 13c and 18b-c run before phases 4 and 6 (which convert the
model), on the model each chat phase loaded; 18b-c's fp32 reference right
after phase 4.

It exits non-zero, printing no result, when there is no CUDA device or
nvcc, and when any check fails: no phase catches its own failure.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from handsonvlm_torch.infer import sampler
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model, quantize_model
from handsonvlm_torch.config import get_config
from handsonvlm_torch.constants import ACTION_QUESTION_TEMPLATES, IMAGE_TOKEN_INDEX
from handsonvlm_torch.core.checkpoint import restore_train_state, save_artifact
from handsonvlm_torch.data import epic_constants, native_loader, video_io
from handsonvlm_torch.data.action_sampler import sample_history_frames
from handsonvlm_torch.data.native_lmdb import write_lmdb_pickled
from handsonvlm_torch.eval import evaluate as evaluate_cli
from handsonvlm_torch.eval.evaluator import (
    InferenceEngine,
    evaluate_epic_kitchen_traj,
    evaluate_sharded,
)
from handsonvlm_torch.infer.chat import chat_turn, new_conversation, prompt_ids
from handsonvlm_torch.infer.profile import random_video, train_batch
from handsonvlm_torch.models.handsonvlm import decode_hand_waypoint, embed_next_token
from handsonvlm_torch.models.lita_hoi import LitaHoi, lita_hoi_forward, lita_hoi_inference
from handsonvlm_torch.models.llama import (
    Int4Weight,
    Int8Weight,
    Llama,
    _quantize_kv_rows,
    apply_llama,
    apply_rope,
    dequantize_llama,
    int4_projection_shapes,
    lm_logits,
    projection_shapes,
    quantize_llama_int4,
    rms_norm,
    rope_cos_sin,
)
from handsonvlm_torch.models.lora import LoRA, init_lora, lora_delta
from handsonvlm_torch.models.visual_tokens import visual_pipeline
from handsonvlm_torch.ops import _build
from handsonvlm_torch.ops.cache_ops import gather_cache_blocks, gather_cache_blocks_ref
from handsonvlm_torch.ops.attention import FLASH_MIN_T, attention, attention_xla
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
from handsonvlm_torch.serve import test_message
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.serve.controller import serve_controller
from handsonvlm_torch.serve.model_worker import ModelWorker, serve_worker
from handsonvlm_torch.serve.scheduler import ContinuousScheduler
from handsonvlm_torch.serve.web_server import serve_web
from handsonvlm_torch.parallel.distributed import spawn
from handsonvlm_torch.parallel.mesh import create_mesh, model_group
from handsonvlm_torch.parallel.partition import bytes_per_rank, shard_model
from handsonvlm_torch.parallel.tp import (
    TPGroup,
    linear_f32,
    shard_for_training,
    shard_int4_stacked,
    shard_llama_tp,
)
from handsonvlm_torch.train import train as train_cli
from handsonvlm_torch.train.step import draw_eps, loss_fn, make_train_step, step_generator
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


def _check_partials(name, parts, want, rows, tol=INT4_TOL):
    """Partial products of a rank each, each rounded to bf16 by its kernel,
    summed in f32 against the unsharded call (rounded once): phase 2's int4
    rule, its bf16 step taken for every rounded term, 2^-7 x (sum of
    |partial| + |want|) per element (a partial may exceed the sum)."""
    got = sum(p.float() for p in parts)
    want = want.float()
    ymax = float(want.abs().max())
    err = (got - want).abs()
    limit = tol[torch.bfloat16] * ymax + 2.0 ** -7 * (sum(p.float().abs() for p in parts)
                                                     + want.abs())
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    rows.append(float(err.max()))
    log(f"  {name}: max_abs_err={rows[-1]:.3e} = {rows[-1] / ymax:.2e} x max|y| (tol "
        f"{tol[torch.bfloat16]:.0e} x max|y| + one bf16 step of each of {len(parts)} partials "
        f"and of the whole) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the summed partials disagree with the unsharded call")


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
                   kv_quant=None, step_impl=None, tp=None):
    """Greedy prefill + 4 decode steps with attention `impl` (the steps
    with `step_impl` when given); `fed` feeds another run's tokens instead
    of this run's own argmax; `tp` runs this rank's tensor-parallel shard.
    Returns (final hidden fp32, this run's own 5 greedy tokens)."""
    hidden, cache, mask = sampler.prefill(model, cfg, ids, images, max_len,
                                          attn_impl=impl, frame_map=frame_map,
                                          kv_quant=kv_quant, tp=tp)
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
                                 attn_mask=mask, kv_cache=cache, attn_impl=step_impl or impl,
                                 tp=tp)
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


# phase 16's EK100 clips: (start second, narration, verb, noun); the first
# row is the train split's, the rest the validation split's (uid = 1, 2, ...)
EK_CLIPS = ((8.0, "open the fridge", "open", "fridge"),
            (10.0, "reach for the cup", "reach", "cup"),
            (14.0, "pick up the knife", "pick", "knife"),
            (18.0, "wash the plate", "wash", "plate"),
            (22.0, "cut the onion", "cut", "onion"))
EK_PARTICIPANT, EK_VIDEO = "P01", "P01_01"


def _ek_row(start_sec, narration, verb, noun, cls):
    def stamp(sec):
        return f"00:{int(sec // 60):02d}:{sec % 60:05.2f}"

    return {"participant_id": EK_PARTICIPANT, "video_id": EK_VIDEO, "narration": narration,
            "start_timestamp": stamp(start_sec), "stop_timestamp": stamp(start_sec + 2.0),
            "start_frame": int(start_sec * epic_constants.ORIGIN_FPS) + 1,
            "stop_frame": int((start_sec + 2.0) * epic_constants.ORIGIN_FPS),
            "verb": verb, "verb_class": cls, "noun": noun, "noun_class": cls,
            "all_nouns": f"['{noun}']", "all_noun_classes": f"[{cls}]"}


def _write_csv(path, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def _ek_video_info(rng) -> dict:
    """A training label pkl's payload: both hands' 21-point trajectories."""
    t = np.linspace(0, 1, 21)[:, None]
    right = np.asarray([[100.0, 80.0]]) + t * np.asarray([[120.0, 60.0]])
    left = np.asarray([[300.0, 90.0]]) + t * np.asarray([[-80.0, 40.0]])
    return {"hand_trajs": {"RIGHT": {"traj": right.astype(np.float32)},
                           "LEFT": {"traj": left.astype(np.float32)}},
            "affordance": {"select_points_homo": rng.uniform(50, 200, size=(5, 2))
                           .astype(np.float32)},
            "frame_indices": [1]}


def write_ek_fixture(root: str, n_val: int = 2, seed: int = 0, train_label: bool = False) -> dict:
    """The EK100 layout the eval CLI reads, under `root`, from `seed`: the
    annotation CSVs (train: one clip, validation: `n_val`), actions.csv,
    video_info.json and the label pkls, the feature LMDB, the reasoning
    questions JSON and 10 distinct 256x456 JPEG frames per clip. At n_val =
    2 the tree is the JAX package's tests/test_e2e_eval_cli.py fixture, file
    for file. `train_label` also writes the train clip's label pkl (uid 0),
    which the hoi-forecast trainer's train split needs. Returns {"frames":
    frames written}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    ann_dir = os.path.join(root, "common", "epic-kitchens-100-annotations")
    for d in (ann_dir, os.path.join(root, "ek100", "labels"),
              os.path.join(root, "ek100", "feats"), os.path.join(root, "assets")):
        os.makedirs(d)
    rows = [_ek_row(*clip, cls) for cls, clip in enumerate(EK_CLIPS[:n_val + 1])]
    _write_csv(os.path.join(ann_dir, "EPIC_100_train.csv"), rows[:1])
    _write_csv(os.path.join(ann_dir, "EPIC_100_validation.csv"), rows[1:])
    _write_csv(os.path.join(ann_dir, "actions.csv"), [
        {"verb": r["verb"], "noun": r["noun"], "verb_class": r["verb_class"],
         "noun_class": r["noun_class"], "action": f"{r['verb']}_{r['noun']}",
         "action_class": cls} for cls, r in enumerate(rows)])
    val_uids = list(range(1, n_val + 1))  # row index + len(train)
    with open(os.path.join(root, "ek100", "video_info.json"), "w") as f:
        json.dump([0] + val_uids, f)
    for uid in ([0] if train_label else []) + val_uids:
        with open(os.path.join(root, "ek100", "labels", f"label_{uid}.pkl"), "wb") as f:
            pickle.dump(_ek_video_info(rng), f)

    rel_dir = f"{EK_PARTICIPANT}/rgb_frames/{EK_VIDEO}"
    frames_dir = os.path.join(root, "EPIC-KITCHENS", rel_dir)
    os.makedirs(frames_dir)
    entries, last_paths, n_frames = {}, [], 0
    for row in rows:
        _, idxs = sample_history_frames(row["start_frame"])
        names = [epic_constants.FRAME_TEMPLATE.format(i)
                 for i in idxs][-epic_constants.OBSERVATION_FRAMES_NUM:]
        for j, name in enumerate(names):
            img = rng.uniform(0, 255, size=(256, 456, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(frames_dir, name))
            n_frames += 1
            entry = {
                "GLOBAL_FEAT": rng.normal(size=(1024,)).astype(np.float32),
                "HAND_RIGHT_FEAT": rng.normal(size=(1024,)).astype(np.float32),
                "HAND_RIGHT_BBOX": np.asarray([0.5, 0.5, 0.7, 0.8], np.float32),
                "OBJECT_RIGHT_FEAT": rng.normal(size=(1024,)).astype(np.float32),
                "OBJECT_RIGHT_BBOX": np.asarray([0.2, 0.2, 0.4, 0.5], np.float32),
            }
            if j % 2 == 0:  # the absent-left-hand default path on odd frames
                entry["HAND_LEFT_FEAT"] = rng.normal(size=(1024,)).astype(np.float32)
                entry["HAND_LEFT_BBOX"] = np.asarray([0.1, 0.4, 0.3, 0.7], np.float32)
            entries[f"{rel_dir}/{name}".encode()] = entry
        last_paths.append(f"{rel_dir}/{names[-1]}")
    write_lmdb_pickled(os.path.join(root, "ek100", "feats",
                                    "full_data_chenbao_processed.lmdb"), entries)
    questions = {p: 'Candidates: "Where should my hand move to next?" '
                    'or "How do I continue this action?"' for p in last_paths}
    with open(os.path.join(root, "assets", "ek100_questions_val.json"), "w") as f:
        json.dump(questions, f)
    return {"frames": n_frames}


class _RecordedEngine(InferenceEngine):
    """The eval CLI's engine, kept after the CLI returns so the phase can
    read its decode counts (the scheduler's engine, the speculative
    stats)."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _RecordedEngine.made.append(self)


def _run_eval_cli(name, argv, clips, samples, max_new, kv_quant, out_path) -> dict:
    """One `handsonvlm_torch.eval.evaluate.main(argv)` with every kernel's
    count set to 0 just before and read just after: the summary written,
    every clip scored, none truncated, the launches exact."""
    _RecordedEngine.made.clear()
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    timed = {}

    def evaluate_timed(*args, **kwargs):  # the CLI's evaluator, its wall taken
        _sync(dev)
        t = time.perf_counter()
        out = evaluate_epic_kitchen_traj(*args, **kwargs)
        _sync(dev)
        timed["eval_s"] = time.perf_counter() - t
        return out

    _sync(dev)
    reset_launches()
    evaluate_cli.evaluate_epic_kitchen_traj = evaluate_timed
    t0 = time.perf_counter()
    try:
        res = evaluate_cli.main(argv)
    finally:
        evaluate_cli.evaluate_epic_kitchen_traj = evaluate_epic_kitchen_traj
    wall = time.perf_counter() - t0
    counts = read_launches()
    (engine,) = _RecordedEngine.made
    with open(out_path) as f:
        summary = json.load(f)
    if set(summary) != {"ade", "fde", "wde", "n"}:
        raise AssertionError(f"16 {name}: summary {summary}")
    info = res["val_info"]
    n_tok = sum(v["num_tokens"] for v in info.values())
    eos = sampler.EOS_TOKEN_ID
    truncated = [i for i, v in info.items()
                 if len(v["gen_ids"]) != max_new and int(v["gen_ids"][-1]) != eos]
    log(f"  16 {name}: {len(info)} clips x {samples} samples, {n_tok} tokens; CLI wall "
        f"{wall:.2f} s (model load and dataset included), evaluation {timed['eval_s']:.2f} s, "
        f"{n_tok / timed['eval_s']:.2f} tok/s aggregate; summary {summary}, "
        f"{len(truncated)} truncated")
    if len(info) != clips or truncated or n_tok < clips * samples:
        raise AssertionError(f"16 {name}: {len(info)} of {clips} clips scored, truncated "
                             f"{truncated}")
    if engine.spec_k:
        steps, prefills, compactions = engine.spec_stats["iters"], 1, 0
    elif engine.__dict__.get("_batched_scheds"):
        (sched,) = engine._batched_scheds.values()
        eng = sched.engine
        steps, prefills, compactions = eng.decode_steps, eng.prefills, eng.compactions
    else:
        steps, prefills, compactions = n_tok - clips * samples, clips * samples, 0
    log(f"  16 {name}: {prefills} prefills, {steps} decode forwards, {compactions} compactions")
    expect_launches(counts, serving_launches(engine.model, engine.cfg, kv_quant, steps,
                                             prefills, compactions))
    _RecordedEngine.made.clear()
    return {"wall_s": wall, "eval_s": timed["eval_s"], "tokens": n_tok, "launches": counts}


def _frame_decoders(paths) -> None:
    """The native frame loader (data/native_loader.py, libjpeg, with PIL
    for what it cannot build or decode) on one clip's JPEGs: which decoder
    returned each frame, by its counter, and the frames against the CLI's
    PIL decode (video_io), equal where PIL decoded them, else within the
    JAX package's native-vs-PIL bound (mean 0.03, 99th percentile 0.25)."""
    before = dict(native_loader.DECODED)
    got = native_loader.load_frames(paths)
    used = {k: native_loader.DECODED[k] - before[k] for k in before}
    diff = np.abs(got - video_io.load_video_frames(paths))
    log(f"  16 native frame loader on {len(paths)} frames: decoded by {used}; against the "
        f"PIL decode mean |diff| {diff.mean():.3e}, 99th percentile "
        f"{np.quantile(diff, 0.99):.3e}")
    if sum(used.values()) != len(paths):
        raise AssertionError(f"16: the loader's counter says {used} for {len(paths)} frames")
    if used["native"] == 0 and diff.max() > 0:
        raise AssertionError("16: the PIL fallback differs from the PIL decode")
    if diff.mean() >= 0.03 or np.quantile(diff, 0.99) >= 0.25:
        raise AssertionError("16: native frames outside the native-vs-PIL bound")


def phase_ek_cli(device: str = "cuda", preset: str = "7b", max_new: int = 32,
                 slots: int = 4, spec_k: int = SPEC_K) -> dict:
    """16: the EK100 eval CLI (`handsonvlm_torch.eval.evaluate.main`) at
    `preset` from `random:<preset>` over an EK100 layout written into a
    temporary directory (write_ek_fixture, 4 validation clips): (a) bf16,
    vanilla, 2 clips, serial; (b) `--int4 --kv-int8 --use-reason
    --num-samples 2 --batched <slots>` over the 4 clips; (c) bf16
    `--spec <spec_k>`, 1 clip. The frames are JPEGs written with PIL, which
    the CLI decodes with PIL (data/video_io.py) as on the CPU. Returns the
    runs' walls, tokens and launch counts."""
    import PIL

    root = tempfile.mkdtemp(prefix="handsonvlm_ek_")
    env = {k: os.environ.get(k) for k in ("HANDSONVLM_DATA_ROOT", "HANDSONVLM_ASSETS_DIR")}
    runs = {}
    try:
        t0 = time.perf_counter()
        written = write_ek_fixture(root, n_val=4)
        log(f"  16 EK100 layout from seed 0 in {root}: 4 validation clips, "
            f"{written['frames']} frames in {time.perf_counter() - t0:.2f} s; frame route: "
            f"JPEGs written and decoded with PIL {PIL.__version__}, as on the CPU")
        _frame_decoders(sorted(glob.glob(os.path.join(root, "EPIC-KITCHENS", "*", "*", "*",
                                                      "*.jpg")))[:10])
        os.environ["HANDSONVLM_DATA_ROOT"] = root
        os.environ["HANDSONVLM_ASSETS_DIR"] = os.path.join(root, "assets")
        evaluate_cli.InferenceEngine = _RecordedEngine
        base = ["--model-path", f"random:{preset}", "--preset", preset, "--device", device,
                "--max-new-tokens", str(max_new)]
        for name, extra, clips, samples, kvq in (
                ("a bf16 vanilla serial", ["--limit", "2"], 2, 1, None),
                (f"b int4 + kv8 reasoning, 2 samples, batched {slots}",
                 ["--int4", "--kv-int8", "--use-reason", "--num-samples", "2",
                  "--batched", str(slots)], 4, 2, "int8"),
                (f"c bf16 spec {spec_k}", ["--spec", str(spec_k), "--limit", "1"], 1, 1, None)):
            out = os.path.join(root, f"summary_{len(runs)}.json")
            runs[name] = _run_eval_cli(name, base + extra + ["--out", out], clips, samples,
                                       max_new, kvq, out)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        evaluate_cli.InferenceEngine = InferenceEngine
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return runs


# ---------------------------------------------------------------------------
# phase 17: the HTTP serving stack
# ---------------------------------------------------------------------------


def _http(url: str, payload: dict, timeout: float = 600.0):
    """POST JSON; a stream's b'\\0'-delimited chunks come back as a list."""
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
    if url.endswith(("_stream", "/generate")):
        return [json.loads(c) for c in body.split(b"\0") if c]
    return json.loads(body)


def _serving(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def write_adapters(root: str, cfg, device, names=("styleA", "styleB"), r: int = LORA_R,
                   b_std: float = 0.02, seed: int = 0) -> None:
    """LoRA adapters (every target, rank r, alpha 2r) from seeds, A as
    init_lora draws it and B ~ b_std N(0, 1) so that each moves the output,
    written as the train CLI writes them (`<root>/<name>/lora`, the
    module's state dict in f32)."""
    for i, name in enumerate(names):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        lora = init_lora(gen, cfg.llama, r=r, alpha=2.0 * r, device=device)
        with torch.no_grad():
            for ad in lora.adapters.values():
                ad.b.normal_(0.0, b_std, generator=gen)
        save_artifact(os.path.join(root, name), "lora",
                      {k: v.cpu() for k, v in lora.state_dict().items()},
                      meta={"base": "random", "r": r, "alpha": 2.0 * r})
        del lora


def _tokens_finished(eng) -> list:
    """Record (generated length, last token) of every request the engine
    finishes."""
    lengths = []
    finalize = eng._finalize

    def wrapped(slot):
        lengths.append((len(slot.tokens), slot.tokens[-1]))
        return finalize(slot)

    eng._finalize = wrapped
    return lengths


def _engine_counts(eng) -> tuple:
    return eng.decode_steps, eng.prefills, eng.compactions


def _expect_since(name, model, cfg, kv_quant, eng, before, extra_steps=0, extra_prefills=0):
    """The launches since `before` (the scheduler engine's counts then)
    against what its prefills, decode forwards and compactions since, plus
    the solo path's, must make."""
    steps, prefills, compactions = (a - b for a, b in zip(_engine_counts(eng), before))
    counts = read_launches()
    log(f"  17{name}: {prefills + extra_prefills} prefills, {steps + extra_steps} decode "
        f"forwards, {compactions} compactions")
    expect_launches(counts, serving_launches(model, cfg, kv_quant, steps + extra_steps,
                                             prefills + extra_prefills, compactions))
    return counts


def _burst(url, payloads) -> list:
    with ThreadPoolExecutor(len(payloads)) as pool:
        return list(pool.map(lambda p: _http(url, p), payloads))


def _first_tokens_as_solo(name, w_addr, prompts) -> None:
    """Greedy, one new token: each request of a concurrent burst answers
    as it does alone (the solo runs first, one at a time)."""
    greedy = [{"prompt": p, "max_new_tokens": 1, "temperature": 0.0} for p in prompts]
    solo = [_http(w_addr + "/worker_generate", p)["text"] for p in greedy]
    burst = [o["text"] for o in _burst(w_addr + "/worker_generate", greedy)]
    log(f"  17{name}: greedy first token alone {solo}, in the burst {burst}")
    if solo != burst:
        raise AssertionError(f"17{name}: a burst request's greedy first token differs "
                             "from its solo run's")


def phase_serving(device: str = "cuda", preset: str = "7b", new_tokens: int = 32,
                  n_burst: int = 8, slots: int = 4, spec_k: int = SPEC_K,
                  lora_r: int = LORA_R, b_std: float = 0.02) -> dict:
    """17: the HTTP serving stack (controller, model worker, web server,
    test_message) in this process on 127.0.0.1 ephemeral ports, from
    `random:<preset>`.

    (a) bf16 worker: `continuous_slots`, `spec_k`, two rank-`lora_r` LoRA
    adapters (B ~ `b_std` N(0, 1)) in its `lora_dir` with one resident, loaded after its HTTP
    server binds. /healthz says "loading" and /worker_generate answers 503
    before the load; it registers with the controller; a burst of `n_burst`
    concurrent /worker_generate (`new_tokens`, temperature 0.5, top-p 0.9)
    runs through the continuous scheduler; a /worker_generate_stream's
    chunks grow by prefix and the last carries `finish` and `pred_hands`;
    greedy, each of 4 burst requests' first token equals its solo run's;
    two adapter requests (the `lora` field, a `<model>:<adapter>` name)
    take the speculative solo path and at temperature 0 answer other than
    the base, and the second again as a stream gives its text in bursts;
    the base model's `lora` stays None and one adapter is
    evicted; the web server's /generate proxies one stream, and
    test_message.main runs against the controller.
    (b) int4 + int8-cache worker with the dynamic batcher (4 rows, a 200 ms
    window): after one warm request, 4 concurrent requests run in fewer
    than 4 batches; greedy first tokens as in (a).
    Every kernel's launches are exact from the scheduler engine's, the
    speculative loop's and the batcher's own counts. Returns each burst's
    wall, aggregate tok/s, TTFT p50 / p95 and batches."""
    root = tempfile.mkdtemp(prefix="handsonvlm_serve_")
    controller, ctrl_server = serve_controller("127.0.0.1", 0)
    ctrl_addr = _serving(ctrl_server)
    servers, workers, stats = [ctrl_server], [], {}
    try:
        cfg = get_config(preset)
        t0 = time.perf_counter()
        write_adapters(os.path.join(root, "lora"), cfg, device, r=lora_r, b_std=b_std)
        log(f"  17a two rank-{lora_r} adapters written in {time.perf_counter() - t0:.2f} s "
            f"({_dir_bytes(os.path.join(root, 'lora'))} bytes)")
        worker = ModelWorker(ctrl_addr, None, f"random:{preset}", preset=preset,
                             model_name=f"handsonvlm-{preset}", continuous_slots=slots,
                             spec_k=spec_k, lora_dir=os.path.join(root, "lora"),
                             lora_resident=1, defer_load=True, device=device)
        workers.append(worker)
        w_server = serve_worker(worker, "127.0.0.1", 0)
        servers.append(w_server)
        worker.worker_addr = w_addr = _serving(w_server)
        with urllib.request.urlopen(w_addr + "/healthz", timeout=10) as r:
            health = json.loads(r.read())["status"]
        try:
            _http(w_addr + "/worker_generate", {"prompt": "x"})
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        log(f"  17a before load: /healthz {health!r}, /worker_generate HTTP {refused}")
        if health != "loading" or refused != 503:
            raise AssertionError("17a: the worker did not answer 'loading' and 503")
        t0 = time.perf_counter()
        worker.load()
        _sync(device)
        log(f"  17a worker loaded in {time.perf_counter() - t0:.2f} s")
        name = f"handsonvlm-{preset}"
        if _http(ctrl_addr + "/get_worker_address", {"model": name})["address"] != w_addr:
            raise AssertionError("17a: the controller does not route to the worker")
        model, eng = worker.engine.model, worker.scheduler.engine
        lengths = _tokens_finished(eng)
        prompts = [f"Where should my hand move to reach the cup? (request {i})"
                   for i in range(n_burst)]

        _sync(device)
        reset_launches()
        before = _engine_counts(eng)
        t0 = time.perf_counter()
        outs = _burst(w_addr + "/worker_generate",
                      [{"prompt": p, "max_new_tokens": new_tokens, "temperature": 0.5,
                        "top_p": 0.9} for p in prompts])
        _sync(device)
        wall = time.perf_counter() - t0
        bad = [o for o in outs if o["error_code"] != 0
               or np.asarray(o["pred_hands"]).shape != (1, 2, 4, 2)]
        truncated = [n for n, last in lengths
                     if n != new_tokens and last != sampler.EOS_TOKEN_ID]
        if bad or truncated or len(lengths) != n_burst:
            raise AssertionError(f"17a burst: {len(bad)} bad answers, {len(lengths)} finished, "
                                 f"truncated {truncated}")
        _expect_since("a burst", model, cfg, None, eng, before)
        st = worker.status()["continuous"]
        n_tok = sum(n for n, _ in lengths)
        stats["a"] = {"wall_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
                      "ttft_p50_s": st["ttft_p50_s"], "ttft_p95_s": st["ttft_p95_s"],
                      "joins": list(eng.join_group_sizes), "compactions": st["compactions"]}
        log(f"  17a burst of {n_burst} x {new_tokens} tokens on {slots} slots: wall "
            f"{wall:.3f} s, {n_tok} tokens, {n_tok / wall:.2f} tok/s aggregate; "
            f"TTFT p50 {st['ttft_p50_s']} s, p95 {st['ttft_p95_s']} s; group joins "
            f"{eng.join_group_sizes}, compactions {st['compactions']}")

        # a stream, the web proxy and test_message, all through the scheduler
        reset_launches()
        before = _engine_counts(eng)
        chunks = _http(w_addr + "/worker_generate_stream",
                       {"prompt": prompts[0], "max_new_tokens": new_tokens})
        texts = [c["text"] for c in chunks]
        if (any(c["error_code"] for c in chunks) or not chunks[-1].get("finish")
                or "pred_hands" not in chunks[-1]
                or not all(texts[i + 1].startswith(texts[i]) for i in range(len(texts) - 1))):
            raise AssertionError(f"17a stream: chunks {chunks}")
        web = serve_web(ctrl_addr, "127.0.0.1", 0, logdir=os.path.join(root, "logs"))
        servers.append(web)
        proxied = _http(_serving(web) + "/generate",
                        {"model": name, "prompt": prompts[1], "max_new_tokens": 16})
        if not proxied[-1].get("finish") or proxied[-1]["error_code"]:
            raise AssertionError(f"17a web proxy: {proxied[-1]}")
        out = test_message.main(["--controller", ctrl_addr, "--model", name,
                                 "--max-new-tokens", "8"])
        if out["error_code"]:
            raise AssertionError(f"17a test_message: {out}")
        log(f"  17a stream: {len(chunks)} chunks; web proxy: {len(proxied)} chunks; "
            "test_message answered")
        _expect_since("a stream, web proxy, test_message", model, cfg, None, eng, before)

        reset_launches()
        before = _engine_counts(eng)
        _first_tokens_as_solo("a", w_addr, prompts[:4])
        _expect_since("a greedy first tokens", model, cfg, None, eng, before)

        # adapters: the speculative solo path, one request at a time
        greedy = {"prompt": prompts[2], "max_new_tokens": new_tokens, "temperature": 0.0}
        base_text = _http(w_addr + "/worker_generate", greedy)["text"]
        adapter_texts = {}
        for label, payload in (("lora field", dict(greedy, lora="styleA")),
                               ("model name", dict(greedy, model=f"{name}:styleB"))):
            reset_launches()
            before = _engine_counts(eng)
            t0 = time.perf_counter()
            text = _http(w_addr + "/worker_generate", payload)["text"]
            _sync(device)
            spec = worker.engine.spec_stats
            log(f"  17a adapter by {label}: {spec['tokens']} tokens in {spec['iters']} "
                f"verify forwards, {time.perf_counter() - t0:.3f} s; differs from the base: "
                f"{text != base_text}")
            if text == base_text:
                raise AssertionError(f"17a: the adapter ({label}) left the greedy text as "
                                     "the base's")
            _expect_since(f"a adapter by {label}", model, cfg, None, eng, before,
                          extra_steps=spec["iters"], extra_prefills=1)
            adapter_texts[label] = text
        # the stream's solo route: speculative bursts, one per verify forward
        reset_launches()
        before = _engine_counts(eng)
        chunks = _http(w_addr + "/worker_generate_stream", dict(greedy, model=f"{name}:styleB"))
        spec = worker.engine.spec_stats
        texts = [c["text"] for c in chunks]
        log(f"  17a adapter stream: {len(chunks)} chunks, {spec['iters']} verify forwards; "
            f"the request's text: {texts[-1] == adapter_texts['model name']}")
        if (any(c["error_code"] for c in chunks) or not chunks[-1].get("finish")
                or "pred_hands" not in chunks[-1]
                or not all(texts[i + 1].startswith(texts[i]) for i in range(len(texts) - 1))
                or texts[-1] != adapter_texts["model name"]):
            raise AssertionError(f"17a adapter stream: chunks {chunks}")
        _expect_since("a adapter stream", model, cfg, None, eng, before,
                      extra_steps=spec["iters"], extra_prefills=1)
        log(f"  17a base model lora after the adapter requests: {model.lora}; adapter "
            f"evictions {worker.lora.evictions}")
        if model.lora is not None or worker.lora.evictions != 1:
            raise AssertionError("17a: the base model changed or the LRU did not evict")
        worker.stop()
        w_server.shutdown()
        del model, eng, worker
        workers.clear()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # (b) int4 weights + int8 cache, the dynamic batcher
        worker = ModelWorker(None, None, f"random:{preset}", preset=preset,
                             quantize="int4", kv_quant="int8", max_batch=4,
                             batch_wait_ms=200.0, device=device)
        workers.append(worker)
        worker.engine.max_new_tokens = new_tokens  # the batcher decodes at these settings
        w_server = serve_worker(worker, "127.0.0.1", 0)
        servers.append(w_server)
        w_addr = _serving(w_server)
        model, batcher = worker.engine.model, worker.batcher
        decoded = []  # per batch: each row's generated length
        infer_batch = worker.engine.infer_batch

        def recorded(*args, **kwargs):
            out = infer_batch(*args, **kwargs)
            decoded.append([len(ids) for ids in out[2]])
            return out

        worker.engine.infer_batch = recorded

        def counted(label, fn):
            reset_launches()
            del decoded[:]
            runs = batcher.batches_run
            t0 = time.perf_counter()
            outs = fn()
            _sync(device)
            wall = time.perf_counter() - t0
            n = batcher.batches_run - runs
            # a batch prefills once and decodes until its longest row ends
            steps = sum(max(rows) - 1 for rows in decoded)
            log(f"  17b {label}: {n} batches of {[len(r) for r in decoded]} rows, {n} "
                f"prefills, {steps} decode forwards, wall {wall:.3f} s")
            expect_launches(read_launches(), serving_launches(model, cfg, "int8", steps, n, 0))
            return outs, n, wall, sum(sum(rows) for rows in decoded)

        counted("warm request", lambda: _http(w_addr + "/worker_generate",
                                              {"prompt": prompts[0]}))
        outs, n, wall, tokens = counted("burst of 4", lambda: _burst(
            w_addr + "/worker_generate", [{"prompt": p} for p in prompts[:4]]))
        if n >= 4 or any(o["error_code"] for o in outs):
            raise AssertionError(f"17b: 4 requests ran in {n} batches")
        stats["b"] = {"wall_s": wall, "batches": n, "tokens": tokens, "tok_s": tokens / wall}
        log(f"  17b burst of 4 x {new_tokens} tokens (the engine's max_new_tokens): {n} "
            f"batches, wall {wall:.3f} s, {tokens} tokens, {tokens / wall:.2f} tok/s aggregate")
        worker.engine.temperature = 0.0
        worker.engine.max_new_tokens = 1
        counted("greedy first tokens", lambda: _first_tokens_as_solo("b", w_addr, prompts[:4]))
    finally:
        for w in workers:
            w.stop()
        for s in servers:
            s.shutdown()
            s.server_close()
        controller.stop()
        shutil.rmtree(root, ignore_errors=True)
    return stats


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


# ---------------------------------------------------------------------------
# phase 18: the HOI-forecast side
# ---------------------------------------------------------------------------

HOI_CLIPS, HOI_FRAMES = 8, 10  # 18b: 8 clips x 10 frames x 5 streams = 50 rows a clip


def hoi_batch(device, b: int = HOI_CLIPS, t: int = HOI_FRAMES, seed: int = 18) -> dict:
    """A LITA-HOI batch from `seed`: TSN-width features N(0, 1), boxes
    uniform, the global stream valid at every frame and the hand / object
    streams missing at about a third of the frames (holes inside the
    sequence), future hands, contact points, clip 1's right hand and clip
    3's left hand invalid."""
    rng = np.random.default_rng(seed)
    valid = (rng.uniform(size=(b, 5, t)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0
    fv = np.ones((b, 2), np.float32)
    fv[1, 0] = fv[3, 1] = 0.0
    batch = {"feat": rng.normal(size=(b, 5, t, 1024)).astype(np.float32),
             "bbox_feat": rng.uniform(size=(b, 4, t, 4)).astype(np.float32),
             "valid_mask": valid,
             "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
             "contact_point": rng.uniform(size=(b, 2)).astype(np.float32),
             "future_valid": fv,
             "gt_hand_valid": fv[:, :, None].repeat(5, axis=2) > 0}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def hoi_draws(cfg, b: int, device, seed: int = 18):
    """The CVAE noise of a LITA-HOI loss and the rollout's latents, drawn
    once so every route reads the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lat, zs = cfg.traj.latent_dim, cfg.traj.z_scale

    def n(*shape):
        return torch.randn(shape, generator=gen, device=device)

    eps = {"traj": n(b * 2 * 4, lat), "obj_r": n(b, lat), "obj_l": n(b, lat)}
    z = {"first_r": zs * n(b, lat), "first_l": zs * n(b, lat), "roll_r": zs * n(4, b, lat),
         "roll_l": zs * n(4, b, lat), "contact_r": zs * n(b, lat), "contact_l": zs * n(b, lat)}
    return eps, z


def _hoi_flash_check(cfg, batch, device) -> None:
    """B3 and B3b at the shape this path gives them, (8, 50, 32, 128) with
    the clips' key mask (holes inside the sequence), against their plain
    versions: B3 per element at phase 2's tolerance, B3b by phase 2's
    gradient rule (bf16 also held to the fp32 plain version). The global
    stream leaves every row a valid key."""
    b, t = batch["valid_mask"].shape[0], batch["valid_mask"].shape[2]
    h, d = cfg.llama.num_heads, cfg.llama.head_dim_
    mask = batch["valid_mask"].transpose(1, 2).reshape(b, t * 5).bool().contiguous()
    gen = torch.Generator(device=device).manual_seed(181)
    errs = {torch.bfloat16: [], torch.float32: []}
    for dtype in (torch.float32, torch.bfloat16):  # bf16 last: the times below take it
        q, k, v, do = (torch.randn((b, t * 5, h, d), generator=gen, device=device).to(dtype)
                       for _ in range(4))
        out, lse = flash_attention(q, k, v, key_mask=mask)
        want, want_lse = flash_attention_ref(q, k, v, key_mask=mask)
        _check(f"18b B3 ({b},{t * 5},{h},{d}) stream holes", out, want, dtype, errs[dtype])
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= 1e-3:
            raise AssertionError(f"18b B3: logsumexp max_abs_err {lse_err:.3e} > 1e-3")
        got = flash_attention_bwd(q, k, v, out, lse, do, key_mask=mask)
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, key_mask=mask)
        want32 = [None] * 3
        if dtype == torch.bfloat16:
            want32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse,
                                             do.float(), key_mask=mask)
        for name, g, w, w32 in zip(("dq", "dk", "dv"), got, want, want32):
            _check_grad(f"18b B3b ({b},{t * 5},{h},{d}) {name}", g, w, w32, dtype, errs[dtype])
    if device.type != "cuda":
        return
    # bf16 times at this shape: the kernels, their plain versions, sdpa with
    # the same pairs as a boolean mask (and its backward); the bounds count
    # the attended pairs
    n = t * 5
    pairs_ok = torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))[None] & mask[:, None]
    pairs = int(pairs_ok.sum())
    out, lse = flash_attention(q, k, v, key_mask=mask)
    ms = cuda_time_ms(lambda i: flash_attention(q, k, v, key_mask=mask))
    plain_ms = cuda_time_ms(lambda i: flash_attention_ref(q, k, v, key_mask=mask), iters=20)
    lib_ms = cuda_time_ms(lambda i: _sdpa(q, k, v, pairs_ok[:, None]))
    bound_ms, bound_by = bound(4 * b * n * h * d * 2, 4 * pairs * h * d)
    log(f"  18b B3 time ({b},{n},{h},{d}) bf16, stream holes: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (sdpa, boolean mask) {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {_shares(ms, bound_ms, lib_ms)}")
    ms = cuda_time_ms(lambda i: flash_attention_bwd(q, k, v, out, lse, do, key_mask=mask))
    plain_ms = cuda_time_ms(lambda i: flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                              key_mask=mask), iters=20)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=pairs_ok[:, None])
    do_t = do.transpose(1, 2)
    lib_ms = cuda_time_ms(lambda i: torch.autograd.grad(sdpa_out, leaves, do_t,
                                                        retain_graph=True))
    bound_ms, bound_by = bound(8 * b * n * h * d * 2 + 2 * b * h * n * 4, 10 * pairs * h * d)
    log(f"  18b B3b time ({b},{n},{h},{d}) bf16, stream holes: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (sdpa backward) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); {_shares(ms, bound_ms, lib_ms)}")


def _input_grads(lita) -> torch.Tensor:
    """The gradients that reached the HOI encoder and the projector, which
    lie below the decoder: each passed back through its 32 layers."""
    return torch.cat([p.grad.float().flatten() for m in (lita.hoi_encoder, lita.projector)
                      for p in m.parameters() if p.grad is not None]).cpu()


def _lita_route(lita, cfg, batch, eps, z, impl: str) -> dict:
    """One route of 18b: lita_hoi_forward's loss and its backward, the
    decoder's final hidden states over the clips' valid tokens, and
    lita_hoi_inference, each with the launch counts set to 0 before it and
    held after it (under "flash" B3 once per layer and pass, B3b once per
    layer in the backward; nothing under the plain routes)."""
    dev = batch["feat"].device
    n_layers = cfg.llama.num_layers
    fwd = {"flash_attention": n_layers} if impl == "flash" else {}
    bwd = {"flash_attention_bwd": n_layers} if impl == "flash" else {}
    counts = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    lita.zero_grad(set_to_none=True)
    ms = {}

    def run(part, want, fn):
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms[part] = (time.perf_counter() - t0) * 1e3
        got = read_launches()
        expect_launches(got, want)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return out

    loss, terms = run("forward", fwd, lambda: lita_hoi_forward(lita, cfg, batch, eps=eps,
                                                                attn_impl=impl))
    run("backward", bwd, loss.backward)
    grads = _input_grads(lita)
    lita.zero_grad(set_to_none=True)
    with torch.no_grad():
        def encode():
            tokens, attn = visual_pipeline(lita, cfg, feat=batch["feat"],
                                           bbox_feat=batch["bbox_feat"],
                                           valid_mask=batch["valid_mask"], attn_impl=impl)
            hidden, _ = apply_llama(lita.llama, cfg.llama, inputs_embeds=tokens,
                                    attn_mask=attn, attn_impl=impl)
            return hidden[attn].float().cpu()

        hidden = run("encode", fwd, encode)
        hand, contact = run("inference", fwd, lambda: lita_hoi_inference(
            lita, cfg, batch, z=z, attn_impl=impl))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    out = {"loss": float(loss.detach()), "terms": {k: float(v.detach()) for k, v in terms.items()},
           "grads": grads, "hidden": hidden, "hand": hand.float().cpu(),
           "contact": contact.float().cpu(), "ms": ms, "counts": counts, "peak": peak}
    if not (np.isfinite(out["loss"]) and all(bool(torch.isfinite(out[k]).all())
                                             for k in ("grads", "hidden", "hand", "contact"))):
        raise AssertionError(f"18b {impl}: a non-finite loss, gradient or output")
    dtype = str(next(lita.oct_decoder.parameters()).dtype).split(".")[-1]
    log(f"  18b {dtype} attn_impl={impl!r}: loss {out['loss']:.6f} "
        f"({', '.join(f'{k} {v:.4f}' for k, v in out['terms'].items())}); wall ms: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in ms.items())}; peak {peak:.3f} GiB; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    return out


def phase_hoi_7b(model, cfg) -> dict:
    """18b and 18c on a loaded HandsOnVLM in its own dtype (bf16 at 7B).

    18b: LITA-HOI over the model's decoder (no second decoder is built):
    new heads (the HOI encoder, projector, ObjectTransformer decoder, CVAE
    heads) from seed 18 in the model's dtype, fuse mode 'hoi', video_arch
    'none', 8 clips x 10 frames x 5 streams = 50 rows a clip with stream
    holes. The loss and its backward (the decoder frozen, its gradients
    flowing through to the HOI encoder and projector), the hidden states
    and the rollout, under attn_impl "auto" (the plain route at 50 rows) and
    "flash" (B3, B3b), after B3 / B3b are held against their plain versions
    at this shape. 18c: `visual_pipeline` in the 'origin' mode on the 10
    frames of `random_video` through the model's CLIP tower and projector,
    "auto" (B2, once per CLIP layer) and "xla". Returns what
    `phase_hoi_7b_reference` compares once the model is in fp32."""
    dev = model.llama.embed_tokens.weight.device
    dtype = str(model.llama.embed_tokens.weight.dtype).split(".")[-1]
    hcfg = dataclasses.replace(cfg, fuse_input_mode="hoi", video_arch="none",
                               mm_hidden_size=1024, param_dtype=dtype, compute_dtype=dtype)
    t0 = time.perf_counter()
    lita = LitaHoi(hcfg, llama=model.llama, device=dev)
    lita.init_weights(torch.Generator(device=dev).manual_seed(18), init_llama=False)
    _sync(dev)
    n_heads = sum(p.numel() for n, p in lita.named_parameters() if not n.startswith("llama."))
    log(f"  18b LITA-HOI heads over the loaded decoder: {n_heads / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = hoi_batch(dev)
    eps, z = hoi_draws(hcfg, HOI_CLIPS, dev)
    _hoi_flash_check(hcfg, batch, dev)
    # one untimed, uncounted pass first: the heads' first products and the
    # first backward through them carry one-time costs (cuBLAS plans)
    loss, _ = lita_hoi_forward(lita, hcfg, batch, eps=eps)
    loss.backward()
    with torch.no_grad():
        lita_hoi_inference(lita, hcfg, batch, z=z)
    runs = {impl: _lita_route(lita, hcfg, batch, eps, z, impl) for impl in ("auto", "flash")}
    log(f"  18b {dtype} flash vs plain: loss "
        f"{runs['flash']['loss']:.6f} vs {runs['auto']['loss']:.6f}, hidden rel L2 "
        f"{_rel(runs['flash']['hidden'], runs['auto']['hidden']):.3e}, input gradients rel L2 "
        f"{_rel(runs['flash']['grads'], runs['auto']['grads']):.3e}")

    ocfg = dataclasses.replace(cfg, fuse_input_mode="origin")
    video, _ = random_video(cfg)
    images = torch.as_tensor(video, device=dev)
    n_clip = cfg.vision.num_layers + cfg.vision.select_layer + 1
    origin = {}
    with torch.no_grad():
        for impl, want in (("auto", {"vit_attention": n_clip}), ("xla", {})):
            _sync(dev)
            reset_launches()
            t0 = time.perf_counter()
            tokens, attn = visual_pipeline(model, ocfg, images=images, attn_impl=impl)
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_launches()
            expect_launches(counts, want)
            if not (bool(torch.isfinite(tokens).all()) and bool(attn.all())
                    and tokens.shape == (1, cfg.num_visual_tokens - cfg.num_frames
                                         + video.shape[1], cfg.llama.hidden_size)):
                raise AssertionError(f"18c {impl}: tokens {tuple(tokens.shape)} not finite "
                                     f"or of the wrong shape")
            origin[impl] = {"tokens": tokens.float().cpu(), "counts": counts}
            log(f"  18c origin pipeline attn_impl={impl!r}: {video.shape[1]} frames -> tokens "
                f"{tuple(tokens.shape)}, wall {wall:.1f} ms, launches "
                f"{({k: v for k, v in counts.items() if v})}")
    log(f"  18c kernel vs plain route: tokens rel L2 "
        f"{_rel(origin['auto']['tokens'], origin['xla']['tokens']):.3e}")
    return {"lita": lita, "cfg": hcfg, "ocfg": ocfg, "batch": batch, "eps": eps, "z": z,
            "runs": runs, "origin": origin, "images": images}


def phase_hoi_7b_reference(model, hoi: dict) -> dict:
    """18b and 18c's reference, once phase 4 has left the model in fp32:
    the same computations on the plain routes with every weight in fp32 (the
    LITA-HOI heads cast from the same values). Phase 4's rule: the bf16
    kernel route may lie at most BF16_VS_PLAIN x as far from the fp32
    reference as the bf16 plain route, for 18b's decoder hidden states over
    the valid tokens and the gradients that reached the HOI encoder and
    projector through the decoder (B3, B3b), and for 18c's tokens (B2).
    Returns the kernel routes' launch counts."""
    lita, cfg = hoi["lita"], hoi["cfg"]
    # phase 4 cast the decoder under inference_mode, which leaves inference
    # tensors that autograd cannot save for the backward: make them normal
    with torch.no_grad():
        for module in lita.llama.modules():
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, torch.nn.Parameter(p.detach().clone(),
                                                         requires_grad=False))
    lita.float()
    ref = _lita_route(lita, cfg, hoi["batch"], hoi["eps"], hoi["z"], "xla")
    low = hoi["runs"]
    checks = {}
    for what in ("hidden", "grads"):
        d_k, d_p = _rel(low["flash"][what], ref[what]), _rel(low["auto"][what], ref[what])
        checks[f"18b {what}"] = (d_k, d_p)
    for what in ("loss", "hand", "contact"):
        k, p, r = (torch.as_tensor(x[what]) for x in (low["flash"], low["auto"], ref))
        log(f"  18b {what} from the fp32 plain route: bf16 flash {_rel(k, r):.3e}, "
            f"bf16 plain {_rel(p, r):.3e}")
    with torch.no_grad():
        tokens, _ = visual_pipeline(model, hoi["ocfg"], images=hoi["images"].float(),
                                    attn_impl="xla")
    tok32 = tokens.float().cpu()
    checks["18c tokens"] = (_rel(hoi["origin"]["auto"]["tokens"], tok32),
                            _rel(hoi["origin"]["xla"]["tokens"], tok32))
    for what, (d_k, d_p) in checks.items():
        ok = np.isfinite(d_k) and d_k <= BF16_VS_PLAIN * d_p
        log(f"  {what} relative L2 from the fp32 plain route: kernels {d_k:.3e}, plain "
            f"{d_p:.3e} (ratio {d_k / d_p if d_p else float('nan'):.3f}, limit "
            f"{BF16_VS_PLAIN}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: the kernel route lies {d_k:.3e} from the fp32 "
                                 f"reference, limit {BF16_VS_PLAIN * d_p:.3e}")
    counts = {}
    for part in (low["flash"]["counts"], hoi["origin"]["auto"]["counts"]):
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
    return {k: v for k, v in counts.items() if v}


def phase_hoi_cli(device: str = "cuda", epochs: int = 2, extra=()) -> dict:
    """18a: the hoi-forecast training CLI (`handsonvlm_torch.train.hoi_train
    .main`) at its defaults (embed 512, 6 encoder and 4 decoder blocks, 8
    heads, CVAE hidden 512 / latent 256, batch 128; `extra` flags override)
    over write_ek_fixture's EK100 layout with the train clip's label (1
    train, 4 validation clips; each batch draws 128 clips with
    replacement): `--epochs 2 --eval-every 1`, then the same command again,
    which restores step 2 and runs its epochs from epoch 0 with the
    restored step (the JAX CLI's behaviour). Each epoch's losses, the
    validation ADE / FDE / WDE, the step ms and the walls are printed."""
    import contextlib
    import io

    from handsonvlm_torch.train import hoi_train

    root = tempfile.mkdtemp(prefix="handsonvlm_hoi_")
    env = os.environ.get("HANDSONVLM_DATA_ROOT")
    runs = []
    try:
        write_ek_fixture(os.path.join(root, "ek"), n_val=4, train_label=True)
        os.environ["HANDSONVLM_DATA_ROOT"] = os.path.join(root, "ek")
        argv = ["--epochs", str(epochs), "--eval-every", "1", "--device", device,
                "--output-dir", os.path.join(root, "run"), *extra]
        for run in range(2):
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                hoi_train.main(argv)
            wall = time.perf_counter() - t0
            lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
            for x in lines:
                log(f"  18a run {run}: {json.dumps(x)}")
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
            log(f"  18a run {run}: wall {wall:.2f} s, peak {peak:.3f} GiB")
            train = [x for x in lines if "total_loss" in x]
            val = [x for x in lines if "val/ade" in x]
            if [x["epoch"] for x in train] != list(range(epochs)) or len(val) != epochs:
                raise AssertionError(f"18a run {run}: epochs {train}, evaluations {val}")
            if not all(np.isfinite(x[k]) for x in train for k in ("total_loss", "step_ms")) or \
                    not all(np.isfinite(x[k]) for x in val for k in ("val/ade", "val/fde")):
                raise AssertionError(f"18a run {run}: non-finite losses or metrics")
            restored = [x["restored_step"] for x in lines if "restored_step" in x]
            if restored != ([] if run == 0 else [epochs]):
                raise AssertionError(f"18a run {run}: restored {restored}")
            runs.append({"wall": wall, "train": train, "val": val})
        steps = sorted(int(d) for d in os.listdir(os.path.join(root, "run", "ckpt"))
                       if d.isdigit())
        if steps != list(range(1, 2 * epochs + 1)):
            raise AssertionError(f"18a: checkpoints at steps {steps}")
        log(f"  18a checkpoints at steps {steps}: the second run went on from step {epochs}")
    finally:
        if env is None:
            os.environ.pop("HANDSONVLM_DATA_ROOT", None)
        else:
            os.environ["HANDSONVLM_DATA_ROOT"] = env
        shutil.rmtree(root, ignore_errors=True)
    return {"runs": runs}


# ---------------------------------------------------------------------------
# Phase 19: parallelism (tensor-parallel decode, FSDP2 training, the ring,
# the evaluation over the ranks)
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)  # the groups phase 19a cuts the 7B shapes for, on one card
PAR_NEW_TOKENS = 32  # greedy tokens of the world run's tensor-parallel decode
PAR_PROFILE_STEPS = 8  # decode steps traced for the device time
SFT_LAYERS_ONE_CARD = 16  # full SFT's depth when one card holds it all
# the tiled layout's fallback at 7B (NB = 43 divides neither 2 nor 4); the
# flat layout splits every projection (22016 / 4 = 5504 = 43 x 128)
TP_FALLBACKS = {"tiled": ["wgu"], "flat": []}


def check_tp_shards() -> None:
    """19a: the tensor-parallel shards at 7B's shapes, rank by rank on this
    card: each rank's column shard of the four fused int4 projections
    (tiled: B4b at m = 1, B5b at m = PREFILL_ROWS; flat: B4c, B5a), its
    outputs concatenated, against the unsharded kernel on the whole weight,
    by phase 2's int4 rule; each rank's 8 of 32 heads (16 of 32 at tp = 2)
    through B1 over the bf16 cache and B6 over the int8 cache, T = 1 and T
    = 5, concatenated over the heads, against the unsharded kernel, by
    phase 2's attention rule. A weight the JAX package's rule leaves whole
    is counted; at 7B only the tiled wgu may be."""
    cfg = get_config("7b").llama
    gen = torch.Generator(device="cuda").manual_seed(19)
    errs = []
    fallbacks = {(layout, tp): set() for layout in TP_FALLBACKS for tp in TP_SIZES}
    for name, (din, dout) in int4_projection_shapes(cfg).items():
        w4t, gst = _int4_stack(din, dout, 1, gen)
        w4, gs = untile_int4_stacked(w4t, gst)
        layouts = {"tiled": (w4t, gst, int4_gemv_tiled, int4_matmul_prefill_tiled),
                   "flat": (w4, gs, int4_gemv_flat, int4_matmul_prefill)}
        for layout, (w, s, gemv, prefill) in layouts.items():
            for m, fn in ((1, gemv), (PREFILL_ROWS, prefill)):
                x = _rand(gen, (1, m, din), torch.bfloat16)
                want = fn(x, w, s, 0)
                for tp in TP_SIZES:
                    parts = [shard_int4_stacked(w, s, r, tp) for r in range(tp)]
                    if parts[0] is None:
                        fallbacks[(layout, tp)].add(name)
                        continue
                    got = torch.cat([fn(x, *p, 0) for p in parts], dim=-1)
                    _check_int4(f"19a {layout} {name} m={m} tp={tp}: {tp} column shards "
                                f"({w.shape[1] // tp if w.dim() == 5 else dout // tp} "
                                f"{'tiles' if w.dim() == 5 else 'columns'} each) vs unsharded",
                                got, want, torch.bfloat16, errs)
    for (layout, tp), names in fallbacks.items():
        log(f"  19a {layout} tp={tp}: unsharded on every rank (the JAX rule's fallback): "
            f"{sorted(names) or 'none'}")
        if sorted(names) != TP_FALLBACKS[layout]:
            raise AssertionError(f"19a {layout} tp={tp}: fallbacks {sorted(names)}, expected "
                                 f"{TP_FALLBACKS[layout]}")

    L, B, S, K, D = 2, 1, 520, cfg.kv_heads, cfg.head_dim_
    ck, cv = (_rand(gen, (L, B, S, K, D), torch.bfloat16) for _ in range(2))
    k8, ks = _quantize_kv_rows(ck)
    v8, vs = _quantize_kv_rows(cv)
    ks, vs = ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()
    for tw in (1, SPEC_K + 1):
        q = _rand(gen, (B, tw, cfg.num_heads, D), torch.bfloat16)
        want = decode_attention_stacked(q, ck, cv, 1, DECODE_LEN)
        want_q = decode_attention_stacked_q(q, k8, v8, ks, vs, 1, DECODE_LEN)
        for tp in TP_SIZES:
            def part(t, r, dim):
                n = t.shape[dim] // tp
                return t.narrow(dim, r * n, n).contiguous()

            got = torch.cat([decode_attention_stacked(
                part(q, r, 2), part(ck, r, 3), part(cv, r, 3), 1, DECODE_LEN)
                for r in range(tp)], dim=2)
            _check(f"19a B1 T={tw} tp={tp}: {cfg.num_heads // tp} of {cfg.num_heads} heads a "
                   "rank vs unsharded", got, want, torch.bfloat16, errs)
            got = torch.cat([decode_attention_stacked_q(
                part(q, r, 2), part(k8, r, 3), part(v8, r, 3), part(ks, r, 2),
                part(vs, r, 2), 1, DECODE_LEN) for r in range(tp)], dim=2)
            _check(f"19a B6 T={tw} tp={tp}: {cfg.num_heads // tp} of {cfg.num_heads} heads a "
                   "rank vs unsharded", got, want_q, torch.bfloat16, errs)


def _heads_fb(q, k, v, dy):
    """B3 forward and B3b backward of causal flash attention: (out, dq, dk, dv)."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out, _ = flash_attention(q, k, v, causal=True)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dy))


def _fused_fb(x, w8, sc, a, b, dy):
    """B10a forward and B10b dx of a fused QLoRA projection (layer 0)."""
    xg = x.clone().requires_grad_()
    y = int8_lora_matmul_stacked(xg, w8, sc, a, b, LORA_ALPHA / LORA_R, 0)
    return y.detach(), torch.autograd.grad(y, xg, dy)[0]


def _col(t, r, tp, dim=-1):
    """Rank r's contiguous 1/tp of `t` along `dim`, as a contiguous tensor
    (differentiable: a leaf's gradient lands in the leaf)."""
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).contiguous()


def check_tp_train_shards() -> None:
    """19a, training: the kernels of tensor parallelism inside training on
    each rank's slices at 7B's shapes and 2048 rows, rank by rank on this
    card, tp = 2 and 4, against the unsharded call:
    - B3 forward and B3b backward on 16 and 8 of 32 heads, each rank's
      outputs and gradients concatenated over the heads, by phase 2's
      attention rule (`_check`; the gradients by `_check_grad`);
    - B5b (forward) and B7b (dx) on each rank's column tiles of the four
      fused int4 projections (the tiled wgu, 43 tiles, stays whole: the
      JAX rule's fallback), the outputs concatenated by phase 2's int4
      rule, the dx partials summed by the script (`_check_partials`: the
      rule with a bf16 step for each partial, which its kernel rounds);
    - B9 (f32 out) and B10a / B10b (the LoRA term at r = 128) on each rank's
      slices of the seven int8 projections: q / k / v / gate / up by output
      columns (outputs concatenated, B10b's dx partials summed), o / down
      by input rows (the partial outputs summed, B10b's dx concatenated),
      by the same rules;
    - one decoder layer at 7B's widths, dense bf16 with LoRA r = 128 over
      its seven projections, forward and backward from each rank's slices
      (`_tp_layer_by_hand`: Megatron's cuts, the row partials summed in
      f32), against the unsharded layer (`apply_llama`): the output, the
      input gradient and every parameter's gradient (the slices
      concatenated) by phase 4's rule against the fp32 plain layer
      (`_check_tp_layer`)."""
    cfg = get_config("7b").llama
    gen = torch.Generator(device="cuda").manual_seed(191)
    errs = []
    bf16, T = torch.bfloat16, TRAIN_ROWS
    h, hd = cfg.num_heads, cfg.head_dim_
    q, k, v, dy = (_rand(gen, (1, T, h, hd), bf16) for _ in range(4))
    want = _heads_fb(q, k, v, dy)
    for tp in TP_SIZES:
        parts = [_heads_fb(*(_col(t, r, tp, 2) for t in (q, k, v, dy))) for r in range(tp)]
        got = [torch.cat([p[i] for p in parts], dim=2) for i in range(4)]
        what = f"T={T} tp={tp}: {h // tp} of {h} heads a rank vs unsharded"
        _check(f"19a B3 {what}", got[0], want[0], bf16, errs)
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            _check_grad(f"19a B3b {name} {what}", g, w, None, bf16, errs)

    for name, (din, dout) in int4_projection_shapes(cfg).items():
        w4t, gst = _int4_stack(din, dout, 1, gen)
        x, g = _rand(gen, (1, T, din), bf16), _rand(gen, (1, T, dout), bf16)
        want_y = int4_matmul_prefill_tiled(x, w4t, gst, 0)
        want_dx = int4_matmul_T_tiled(g, w4t, gst, 0)
        for tp in TP_SIZES:
            parts = [shard_int4_stacked(w4t, gst, r, tp) for r in range(tp)]
            if parts[0] is None:
                log(f"  19a B5b / B7b {name} tp={tp}: {w4t.shape[1]} tiles stay whole on every "
                    "rank (the JAX rule's fallback)")
                continue
            y = torch.cat([int4_matmul_prefill_tiled(x, *p, 0) for p in parts], dim=-1)
            dx = [int4_matmul_T_tiled(_col(g, r, tp), *p, 0) for r, p in enumerate(parts)]
            what = f"{name} m={T} tp={tp}: {w4t.shape[1] // tp} column tiles a rank"
            _check_int4(f"19a B5b {what}, concatenated", y, want_y, bf16, errs)
            _check_partials(f"19a B7b dx {what}, partials summed", dx, want_dx, errs)
        del w4t, gst

    r_ = LORA_R
    for name, (din, dout) in projection_shapes(cfg).items():
        w8, sc = quantize_stacked_int8(0.02 * torch.randn((1, din, dout), generator=gen,
                                                          device="cuda"))
        a = 0.02 * torch.randn((din, r_), generator=gen, device="cuda")
        b = 0.02 * torch.randn((r_, dout), generator=gen, device="cuda")
        x, g = _rand(gen, (T, din), bf16), _rand(gen, (T, dout), bf16)
        want_9 = int8_matmul(x, w8[0], sc[0])
        want_y, want_dx = _fused_fb(x, w8, sc, a, b, g)
        row = name in ("wo", "w_down")
        for tp in TP_SIZES:
            if row:
                y9 = sum(int8_matmul(_col(x, r, tp), _col(w8[0], r, tp, 0), sc[0])
                         for r in range(tp))
                outs = [_fused_fb(_col(x, r, tp), _col(w8, r, tp, 1), sc, _col(a, r, tp, 0),
                                  b, g) for r in range(tp)]
                y = [o[0] for o in outs]
                dx = torch.cat([o[1] for o in outs], dim=-1)
                cut = f"{din // tp} input rows a rank"
            else:
                y9 = torch.cat([int8_matmul(x, _col(w8[0], r, tp), _col(sc[0], r, tp))
                                for r in range(tp)], dim=-1)
                outs = [_fused_fb(x, _col(w8, r, tp), _col(sc, r, tp), a, _col(b, r, tp),
                                  _col(g, r, tp)) for r in range(tp)]
                y = torch.cat([o[0] for o in outs], dim=-1)
                dx = [o[1] for o in outs]
                cut = f"{dout // tp} output columns a rank"
            what = f"{name} {din}->{dout} m={T} tp={tp}: {cut}"
            _check_int4(f"19a B9 {what}", y9, want_9, torch.float32, errs)
            for kernel, got, want in ((f"B10a r={r_}", y, want_y), (f"B10b dx r={r_}", dx, want_dx)):
                if isinstance(got, list):
                    _check_partials(f"19a {kernel} {what}, partials summed", got, want, errs)
                else:
                    _check_int4(f"19a {kernel} {what}, concatenated", got, want, bf16, errs)
        del w8, sc

    _check_tp_layer(cfg, gen, errs)


def _tp_layer_by_hand(w, lora, cfg, hidden, cos, sin, tp):
    """One dense decoder layer with LoRA from `tp` ranks' slices of the
    whole weights `w` ({name: HF (dout, din) weight}, the norms) and
    adapters `lora` ({target: (a, b)}), on one card: each rank's q / k / v
    / gate / up from its output rows (its heads, B3 / B3b on them), its o /
    down partials from its input columns, the LoRA terms cut alike, the
    partials summed in f32 and rounded once, as `_layer` does over a model
    group. The slices are views of `w`, so the gradients land there."""
    eps, hd, f = cfg.rms_norm_eps, cfg.head_dim_, cfg.intermediate_size
    b, t, _ = hidden.shape
    scale = LORA_ALPHA / LORA_R

    def lora_layer(r, names):  # rank r's adapter views: b cut for a column target, a for a row
        out = {}
        for n in names:
            a, bb = lora[n]
            out[n] = {"a": _col(a, r, tp, 0) if n in ("wo", "w_down") else a,
                      "b": bb if n in ("wo", "w_down") else _col(bb, r, tp, 1)}
        return out

    def column(x, r, name):
        return (torch.nn.functional.linear(x, _col(w[name], r, tp, 0))
                + lora_delta(lora_layer(r, [name]), name, x, scale))

    def row(x, r, name):
        return (linear_f32(x, _col(w[name], r, tp, 1))
                + lora_delta(lora_layer(r, [name]), name, x, scale, out_dtype=torch.float32))

    # a rank's copy of x: its gradient summed over the ranks in f32 and
    # rounded once, as `copy_to_model`'s all-reduce does
    x32 = rms_norm(hidden, w["input_layernorm"], eps).float()
    part = 0.0
    for r in range(tp):
        x = x32.to(hidden.dtype)
        q = apply_rope(column(x, r, "wq").reshape(b, t, -1, hd), cos, sin)
        kx = apply_rope(column(x, r, "wk").reshape(b, t, -1, hd), cos, sin)
        vx = column(x, r, "wv").reshape(b, t, -1, hd)
        out = attention(q, kx, vx, causal=True, impl="auto").reshape(b, t, -1)
        part = part + row(out, r, "wo")
    hidden = hidden + part.to(hidden.dtype)
    x32 = rms_norm(hidden, w["post_attention_layernorm"], eps).float()
    part = 0.0
    for r in range(tp):
        x = x32.to(hidden.dtype)
        gu = torch.nn.functional.silu(column(x, r, "w_gate")) * column(x, r, "w_up")
        part = part + row(gu, r, "w_down")
    hidden = hidden + part.to(hidden.dtype)
    return rms_norm(hidden, w["norm"], eps)


def _check_tp_layer(cfg, gen, errs, rows: int = TRAIN_ROWS, device: str = "cuda") -> None:
    """19a's decoder layer (see `check_tp_train_shards`): the output, the
    input gradient and each parameter's gradient by phase 4's rule, at
    most BF16_VS_PLAIN x as far from the fp32 plain layer (relative L2) as
    the unsharded bf16 layer's; each tensor's worst element against
    `_grad_limit`'s per-element limit (the unsharded layer's) is logged,
    not held: two bf16 paths through a whole layer (softmax, SiLU, the
    norms between the roundings) differ by more than one kernel's rounding
    (on the CPU at 512 wide, 512 rows: wq's worst element 1.32 x the
    limit, every tensor's L2 ratio 1.02-1.05). `device="cpu"` runs the
    plain routes (a rehearsal at a small config)."""
    from handsonvlm_torch.models.llama import _PROJ

    bf16, T = torch.bfloat16, rows
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    llama = Llama(cfg1, device=device, dtype=bf16)
    llama.init_weights(gen)
    lora = init_lora(gen, cfg1, LORA_R, LORA_ALPHA, device=device)
    with torch.no_grad():  # b ~ 0.02 N(0, 1): every adapter has a gradient
        for ad in lora.adapters.values():
            ad.b.normal_(0.0, 0.02, generator=gen)
    hidden = torch.randn((1, T, cfg.hidden_size), generator=gen, device=device).to(bf16)
    hidden.requires_grad_()
    dy = torch.randn((1, T, cfg.hidden_size), generator=gen, device=device).to(bf16)
    positions = torch.arange(T, device=device)[None]
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)

    lp = llama.layers[0]
    leaves = {n: getattr(getattr(lp, sub), lin).weight for n, (sub, lin) in _PROJ.items()}
    leaves.update(input_layernorm=lp.input_layernorm.weight,
                  post_attention_layernorm=lp.post_attention_layernorm.weight,
                  norm=llama.norm.weight)
    adapters = {n: (ad.a[0], ad.b[0]) for n, ad in lora.adapters.items()}
    names = ["out", "dx"] + list(leaves) + [f"{n}.{f}" for n in lora.adapters for f in "ab"]
    params = list(leaves.values()) + [p for ad in lora.adapters.values() for p in (ad.a, ad.b)]

    def unsharded(impl):
        out, _ = apply_llama(llama, cfg1, inputs_embeds=hidden, lora=lora, attn_impl=impl)
        grads = torch.autograd.grad(out, [hidden] + params, dy.to(out.dtype))
        return dict(zip(names, [out.detach()] + list(grads)))

    want = unsharded("auto")
    llama.float()  # the fp32 plain layer: phase 4's reference
    kept, hidden = hidden, hidden.detach().float().requires_grad_()
    want32 = unsharded("xla")
    llama.to(bf16)
    hidden = kept
    for tp in TP_SIZES:
        w = {n: t.detach().clone().requires_grad_() for n, t in leaves.items()}
        ad = {n: (a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_())
              for n, (a, b) in adapters.items()}
        x = hidden.detach().clone().requires_grad_()
        reset_launches()
        got_out = _tp_layer_by_hand(w, ad, cfg1, x, cos, sin, tp)
        ad_leaves = [t for pair in ad.values() for t in pair]
        g = torch.autograd.grad(got_out, [x] + list(w.values()) + ad_leaves, dy)
        counts = read_launches()
        if device == "cuda" and (counts["flash_attention"] != tp
                                 or counts["flash_attention_bwd"] != tp):
            raise AssertionError(f"19a layer tp={tp}: B3 {counts['flash_attention']}, B3b "
                                 f"{counts['flash_attention_bwd']} launches, expected {tp} each")
        got = dict(zip(names, [got_out.detach()] + list(g)))
        for name, gv in got.items():
            wv = want[name].reshape(gv.shape)
            w32 = want32[name].reshape(gv.shape)
            # (1, rows, heads of 128, 128) for _grad_limit: a row of a matrix, or a token
            t_rows = gv.shape[-2] if gv.dim() > 1 else 1
            width = 128 if gv.shape[-1] % 128 == 0 else gv.shape[-1]
            gv4, wv4 = (t.float().reshape(1, t_rows, -1, width) for t in (gv, wv))
            worst = float(((gv4 - wv4).abs() / _grad_limit(wv4, GRAD_RTOL[bf16])).max())
            d_tp, d_u = _rel(gv, w32), _rel(wv, w32)
            ok = bool(torch.isfinite(gv).all()) and d_tp <= BF16_VS_PLAIN * d_u
            errs.append(float((gv.float() - wv.float()).abs().max()))
            log(f"  19a layer tp={tp} {name} {tuple(gv.shape)} (slices of {tp} ranks summed by "
                f"hand): relative L2 from the fp32 plain layer {d_tp:.3e}, the unsharded bf16 "
                f"layer's {d_u:.3e} (ratio {d_tp / d_u:.3f}, limit {BF16_VS_PLAIN}); against "
                f"the unsharded layer max_abs_err={errs[-1]:.3e}, worst element {worst:.3f} x "
                f"_grad_limit's {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"19a layer tp={tp} {name}: farther from the fp32 layer "
                                     "than the unsharded bf16 layer allows")
    del llama, lora
    _free(torch.device(device))


def _limit(dtype, d_plain: float) -> float:
    """Phase 4's limit on a path's distance from the fp32 reference: in
    bf16 BF16_VS_PLAIN x the bf16 plain path's, in fp32 FP32_REL_L2."""
    return FP32_REL_L2 if dtype == torch.float32 else BF16_VS_PLAIN * d_plain


def _say(rank: int):
    return log if rank == 0 else (lambda _msg: None)


def _peak_gib(device) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")


def _reset_peak(device) -> None:
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _device_ms(fn, steps: int, device, top: int = 0):
    """(compute, NCCL, heaviest) device ms per step of fn() (which runs
    `steps` steps) from a torch.profiler trace: the self time of the CUDA
    kernels other than NCCL's, and of NCCL's apart (they run on a stream
    of their own and include the wait for the other ranks), and the `top`
    most expensive kernels as (name, ms a step, calls); NaN off the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return float("nan"), float("nan"), []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side spans of host ranges (`nccl:all_reduce`, `Optimizer.step#...`)
    # cover kernels that are counted on their own: only kernels are summed
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges
               and not getattr(e, "is_user_annotation", False)]
    nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower())
    total = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    heavy = [(e.key[:60], e.self_device_time_total / 1e3 / steps, e.count)
             for e in kernels[:top]]
    return (total - nccl) / 1e3 / steps, nccl / 1e3 / steps, heavy


def _cache_bytes(cfg, kv_heads: int, max_len: int, kv_quant) -> int:
    n = cfg.llama.num_layers * max_len * kv_heads * cfg.llama.head_dim_
    if kv_quant:
        return 2 * n + 2 * 4 * n // cfg.llama.head_dim_
    return 2 * n * 2


def _tp_decode(rank: int, world: int, quantize, kv_quant, device, preset,
               new_tokens: int = PAR_NEW_TOKENS) -> dict:
    """19b decode: the 7B model (`random:7b`, `quantize`) on every rank.
    Rank 0 first runs it unsharded on its card: the greedy prefill + 4
    steps of phase 4 through the kernels, the plain path fed the same
    tokens, the fp32 reference (the weights cast, or dequantized, to fp32,
    plain path), and a 32-token greedy decode. Then every rank cuts its
    shard (`shard_llama_tp`) and runs the same greedy prefill + 4 steps fed
    the unsharded run's tokens (phase 4's rule: its final hidden at most
    BF16_VS_PLAIN x as far from the reference as the plain path's) and a
    32-token greedy decode (its tokens against the unsharded stream, the
    common prefix logged; step wall, device time, tok/s, collectives per
    step, bytes per rank). The launches of both tensor-parallel runs are
    exact. Returns rank 0's launch counts of those runs."""
    import copy

    import torch.distributed as dist

    from handsonvlm_torch.parallel import tp as tp_mod

    say = _say(rank)
    label = f"{quantize or 'bf16'}{' + kv8' if kv_quant else ''}"
    tp = TPGroup.world() if world > 1 else None
    model, cfg, tokenizer = load_pretrained_model(f"random:{preset}", preset, device,
                                                  quantize=quantize)
    video, frame_map = random_video(cfg)
    args = _greedy_args(model, cfg, tokenizer, video, frame_map)
    ids, images = args[2], args[3]
    gen_args = dict(max_new_tokens=new_tokens, temperature=0.0, eos_token_id=-1,
                    frame_map=frame_map, kv_quant=kv_quant)
    fed = [None]
    with torch.inference_mode():
        if rank == 0:
            h_u, tok_u = _greedy_decode(*args, "auto", kv_quant=kv_quant)
            h_p, _ = _greedy_decode(*args, "xla", fed=tok_u, kv_quant=kv_quant)
            ref = copy.deepcopy(model)
            if quantize:
                dequantize_llama(ref.llama, cfg.llama, torch.float32)
            ref.float()
            h_ref, tok_ref = _greedy_decode(ref, *args[1:], "xla", fed=tok_u, kv_quant=kv_quant)
            del ref
            _free(device)
            stream_u = sampler.generate_host(model, cfg, ids, images,
                                             torch.Generator(device=device), **gen_args)
            fed = [tok_u]
        if world > 1:
            dist.broadcast_object_list(fed, src=0)
        shard_llama_tp(model.llama, cfg.llama, rank, world)
        _free(device)
        layout = model.llama.tp_layout
        say(f"  19b {label} tp={world}: heads split {layout.heads}, int4 splits "
            f"{layout.int4 or 'dense'}, fallbacks {layout.fallbacks or 'none'}")

        reset_launches()
        h_tp, tok_tp = _greedy_decode(*args, "auto", fed=fed[0], kv_quant=kv_quant, tp=tp)
        counts = read_launches()
        if rank == 0:
            expect_launches(counts, serving_launches(model, cfg, kv_quant, 4, 1, 0))
        launches = dict(counts)

        stamps = []
        c0 = tp_mod.COLLECTIVES
        reset_launches()
        _reset_peak(device)
        t0 = time.perf_counter()
        stream = sampler.generate_host(model, cfg, ids, images, torch.Generator(device=device),
                                       on_token=lambda _t: stamps.append(time.perf_counter()),
                                       tp=tp, **gen_args)
        _sync(device)
        wall = time.perf_counter() - t0
        counts = read_launches()
        n = int(stream.num_tokens[0])
        steps = n - 1
        coll = (tp_mod.COLLECTIVES - c0) / max(steps + 1, 1)
        if rank == 0:
            expect_launches(counts, serving_launches(model, cfg, kv_quant, steps, 1, 0))
        for k, v in counts.items():
            launches[k] += v

        # decode steps alone: wall (host, synchronized) and device time
        max_len = ids.shape[1] + cfg.num_visual_tokens - 1 + PAR_PROFILE_STEPS + 2
        _, cache, mask = sampler.prefill(model, cfg, ids, images, max_len,
                                         frame_map=frame_map, kv_quant=kv_quant, tp=tp)
        index = cache.index
        tok = torch.tensor([int(stream.sequences[0, 0])], device=device)
        wp = torch.zeros((1, 2, 2), device=device)

        def steps_fn():
            cache.index = index
            t, w = tok, wp
            for _ in range(PAR_PROFILE_STEPS):
                t, w, _c = sampler.decode_step(model, cfg, cache, mask, t, w, None,
                                               temperature=0.0, tp=tp)

        steps_fn()
        _sync(device)
        t1 = time.perf_counter()
        steps_fn()
        _sync(device)
        step_ms = (time.perf_counter() - t1) * 1e3 / PAR_PROFILE_STEPS
        dev_ms, nccl_ms, _ = _device_ms(steps_fn, PAR_PROFILE_STEPS, device)
        kv_heads = layout.kv_heads(cfg.llama.kv_heads)
        cache_b = _cache_bytes(cfg, kv_heads, ids.shape[1] + cfg.num_visual_tokens
                               + new_tokens, kv_quant)
        tok_s = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else float("nan")
        say(f"  19b {label} tp={world}: {n} greedy tokens in {wall:.3f} s, decode "
            f"{tok_s:.2f} tok/s; a decode step {step_ms:.2f} ms wall, {dev_ms:.3f} ms device "
            f"in compute kernels ({dev_ms / step_ms:.1%} busy) and {nccl_ms:.3f} ms in NCCL's "
            f"(their waits included), {coll:.1f} collectives a step (prefill's "
            "included in the mean over the run's forwards); per rank: weights "
            f"{model_bytes(model) / 2**30:.3f} GiB (decoder {model_bytes(model.llama) / 2**30:.3f}), "
            f"cache {cache_b / 2**20:.1f} MiB for {kv_heads} kv heads; peak "
            f"{_peak_gib(device):.3f} GiB")
        if rank == 0:
            d_tp, d_u, d_p = _rel(h_tp, h_ref), _rel(h_u, h_ref), _rel(h_p, h_ref)
            same = int(np.argmin(np.append(stream.sequences[0] == stream_u.sequences[0], False)))
            say(f"  19b {label}: greedy tokens (fed the unsharded run's): unsharded kernels "
                f"{tok_u[:4]}, tp={world} {tok_tp[:4]}, fp32 plain {tok_ref[:4]}; "
                f"{new_tokens}-token streams agree on their first {same} tokens")
            limit = _limit(model.llama.embed_tokens.weight.dtype, d_p)
            say(f"  19b {label}: final hidden relative L2 from the fp32 plain path: tp={world} "
                f"{d_tp:.3e}, unsharded kernels {d_u:.3e}, plain {d_p:.3e} (limit "
                f"{limit:.3e})")
            toks = stream.sequences[0, :n]
            if n != new_tokens or toks.min() < 0 or toks.max() >= cfg.llama.vocab_size:
                raise AssertionError(f"19b {label}: bad stream {toks}")
            if not (np.isfinite(d_tp) and d_tp <= limit):
                raise AssertionError(f"19b {label} tp={world}: the final hidden lies {d_tp:.3e} "
                                     f"from the fp32 reference, limit {limit:.3e}")
    del model, cache
    _free(device)
    return launches


def _rows_batch(cfg, n: int, rows: int = TRAIN_ROWS) -> dict:
    """`n` samples of `rows` rows (train_batch with seeds 0..n-1), the
    frames' slot map shared."""
    parts = [train_batch(cfg, rows, seed=i) for i in range(n)]
    return {k: parts[0][k] if k == "frame_map" else np.concatenate([p[k] for p in parts])
            for k in parts[0]}


FSDP_LOSS_RTOL = 1e-2  # the sharded step-0 loss against one card's, both bf16
FSDP_NORM_RTOL = 5e-2  # its grad_norm (bf16 gradients reduce-scattered in bf16)
# the step-1 loss: bf16 weights after one Adam step, whose update is about
# lr x sign(g) an element, so an element whose gradient sign differs
# between the two reductions moves the other way
FSDP_LOSS1_RTOL = 5e-2


def _one_card_steps(model, cfg, batch, eps0, eps1, freeze=("vision",)) -> tuple:
    """One card's unsharded reference of the sharded steps 0 and 1:
    step 0's loss and grad_norm (forward + backward of `batch`, CVAE draws
    `eps0`), the same AdamW step, then step 1's loss (a forward, draws
    `eps1`). The optimizer's moments exist only after the backward, so a
    7B model whose training step does not fit one card fits here.
    `freeze`: the frozen top-level modules (full SFT: the CLIP tower)."""
    device = model.llama.embed_tokens.weight.device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=freeze)
    opt.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, cfg, batch, eps=eps0, attn_impl="auto", remat="full")
    loss.backward()
    loss0, norm0 = float(loss.detach()), float(opt.step())
    opt.zero_grad(set_to_none=True)
    del loss
    with torch.no_grad():
        loss1, _ = loss_fn(model, cfg, batch, eps=eps1, attn_impl="auto", remat=False)
    return loss0, norm0, float(loss1)


def _fsdp_sft(rank: int, world: int, device, preset, rows: int) -> dict:
    """19b FSDP: full SFT (the CLIP tower frozen) of the 7B model at its
    widths, all 32 layers on 2 or more ranks, SFT_LAYERS_ONE_CARD on one,
    sharded by FSDP2 over the ranks, 2 steps on a global batch of one
    2048-row sample a rank; per step the loss, wall ms, tokens/s and peak
    GiB a rank, launches exact; the bytes a rank holds. Before sharding,
    rank 0 runs the whole global batch's two steps on its card alone
    (`_one_card_steps`, the same CVAE draws): the sharded step 0's loss
    and grad_norm lie within FSDP_LOSS_RTOL / FSDP_NORM_RTOL of its, step
    1's loss within FSDP_LOSS1_RTOL. After the steps, the gather a checkpoint makes (the whole model and
    Adam moments to rank 0's CPU, one tensor at a time) is timed, with its
    peak a rank; nothing is written."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel.partition import full_state_dict

    say = _say(rank)
    base = get_config(preset)
    layers = base.llama.num_layers if world > 1 else min(SFT_LAYERS_ONE_CARD,
                                                          base.llama.num_layers)
    cfg = dataclasses.replace(base, llama=dataclasses.replace(base.llama, num_layers=layers))
    model = build_model(cfg, device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    full = model_bytes(model)
    batch = _rows_batch(cfg, world, rows)
    eps = [draw_eps(model, cfg, world, step_generator(0, i, device)) for i in range(2)]
    if rank == 0:  # the reference updates its weights: the model is built again
        ref = _one_card_steps(model, cfg, batch, *eps)
        del model
        _free(device)
        model = build_model(cfg, device)
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    if dist.is_initialized():
        dist.barrier()
    mesh = create_mesh(device=device.type)
    shard_model(model, mesh)
    _free(device)
    opt = make_optimizer(model, TRAIN_LR)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="auto", remat="full", mesh=mesh)
    held = bytes_per_rank(model)
    cut = layers < base.llama.num_layers
    say(f"  19b FSDP full SFT at {preset} widths, {layers} layers"
        f"{f' (cut from {base.llama.num_layers}: their states do not fit one card)' if cut else ''}"
        f", {world} rank(s), {world} x {rows} rows: the whole model "
        f"{full / 2**30:.3f} GiB; a rank holds parameters {held['params'] / 2**30:.3f} GiB "
        f"(its shards and the replicated ones), buffers {held['buffers'] / 2**30:.3f} GiB")
    want = _train_launches(cfg, rows)
    launches = {}
    for i in range(2):
        reset_launches()
        _reset_peak(device)
        t0 = time.perf_counter()
        m = step(state, batch, 0, eps=eps[i])
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        peak = _peak_gib(device)
        counts = read_launches()
        launched = {k: v for k, v in counts.items() if v}
        moments = sum(t.to_local().numel() * t.element_size() if hasattr(t, "to_local")
                      else t.numel() * t.element_size()
                      for st in opt.state.values() for t in st.values())
        say(f"  19b FSDP step {i}: loss {m['loss']:.4f} (text {m['text_loss']:.4f}, traj "
            f"{m['traj_loss']:.4f}, kl {m['traj_kl_loss']:.4f}), grad_norm {m['grad_norm']:.4f}; wall "
            f"{wall:.1f} ms, {world * rows / wall * 1e3:.1f} tokens/s, peak {peak:.3f} "
            f"GiB a rank (Adam moments {moments / 2**30:.3f} GiB a rank); launches {launched}")
        if rank == 0 and device.type == "cuda" and launched != want:
            raise AssertionError(f"19b FSDP: launches {launched}, expected {want}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"19b FSDP: metrics not finite: {m}")
        if rank == 0:
            checks = [("loss", m["loss"], ref[2 * i], FSDP_LOSS1_RTOL if i else FSDP_LOSS_RTOL)]
            if i == 0:
                checks.append(("grad_norm", m["grad_norm"], ref[1], FSDP_NORM_RTOL))
            say(f"  19b FSDP step {i} against one card's unsharded step on the same "
                f"{world} x {rows} rows: " + ", ".join(
                    f"{k} {v:.6f} / {r:.6f} (rel {abs(v - r) / abs(r):.3e}, limit {tol:.0e})"
                    for k, v, r, tol in checks))
            if any(abs(v - r) > tol * abs(r) for _, v, r, tol in checks):
                raise AssertionError(f"19b FSDP: step {i} departs from the one-card reference")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    _reset_peak(device)
    t0 = time.perf_counter()
    whole = full_state_dict(model), opt.state_dict()
    _sync(device)
    gather_s = time.perf_counter() - t0
    host = sum(t.numel() * t.element_size() for t in whole[0].values()) + sum(
        t.numel() * t.element_size() for st in whole[1]["state"].values() for t in st.values())
    say(f"  19b FSDP checkpoint gather (whole model and moments to rank 0's CPU, not "
        f"written): {gather_s:.2f} s, {host / 2**30:.3f} GiB on this rank's host, peak "
        f"{_peak_gib(device):.3f} GiB a rank")
    del model, opt, state, whole
    _free(device)
    return launches


def _seq_parallel(rank: int, world: int, device, preset, rows_a_rank: int) -> dict:
    """19b ring: LoRA r=128 over the bf16 7B base on one sample of 2048 x N
    rows, `--seq-parallel N`: FSDP2 over a ('data', 'seq') mesh of 1 x N,
    each rank 2048 rows, ring attention over the N ranks. Rank 0 first runs
    the same rows on its card alone: the flash route (B3 / B3b) in bf16,
    then the weights cast to fp32 (the flash route in fp32, the reference),
    the adapters' gradients of one step each. The ring step's gradients
    (the same CVAE draws) may lie at most BF16_VS_PLAIN x as far from the
    reference as the one-card bf16 route's; its wall and peak a rank beside
    the one-card forward + backward's; launches exact."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel.partition import full_tensor

    say = _say(rank)
    rows = rows_a_rank * world
    model, cfg, _ = load_pretrained_model(f"random:{preset}", preset, device)
    r = LORA_R if preset == "7b" else 2
    gen = torch.Generator(device=device).manual_seed(1)
    model.lora = init_lora(gen, cfg.llama, r, 2.0 * r, device=device)
    with torch.no_grad():  # b ~ 0.02 N(0, 1), so that every adapter has a gradient
        for ad in model.lora.adapters.values():
            ad.b.normal_(0.0, 0.02, generator=gen)
    batch = train_batch(cfg, rows)
    eps = draw_eps(model, cfg, 1, step_generator(0, 0, device))
    if rank == 0:
        make_optimizer(model, TRAIN_LR, freeze_top_keys=("vision", "llama"))
        _reset_peak(device)
        t0 = time.perf_counter()
        g_one = _lora_grads(model, cfg, batch, eps, "auto")
        _sync(device)
        one_ms = (time.perf_counter() - t0) * 1e3
        one_peak = _peak_gib(device)
        base = [child for name, child in model.named_children() if name != "lora"]
        dtype = model.llama.embed_tokens.weight.dtype
        for child in base:  # bf16 -> fp32 -> bf16 is exact; the adapters stay f32
            child.float()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        g_32 = _lora_grads(model, cfg32, batch, eps.float(), "auto")
        for child in base:
            child.to(dtype)
        model.zero_grad(set_to_none=True)
        _free(device)
    mesh = create_mesh(seq=world, device=device.type)
    shard_model(model, mesh)
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=("vision", "llama"))
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="auto", remat="full", mesh=mesh,
                           seq_mesh=mesh if world > 1 else None)
    reset_launches()
    _reset_peak(device)
    t0 = time.perf_counter()
    m = step(state, batch, 0, eps=eps)
    _sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    peak = _peak_gib(device)
    counts = read_launches()
    g_ring = torch.cat([full_tensor(p.grad).float().flatten() for p in model.lora.parameters()])
    want = {"vit_attention": cfg.vision.num_layers + cfg.vision.select_layer + 1}
    if world == 1:  # no ring: the one-card route, B3 / B3b
        want = _train_launches(cfg, rows)
    launched = {k: v for k, v in counts.items() if v}
    say(f"  19b ring LoRA r={r} step, {rows} rows over {world} rank(s) ({rows_a_rank} a "
        f"rank): loss {m['loss']:.4f}, wall {wall:.1f} ms, {rows / wall * 1e3:.1f} tokens/s, "
        f"peak {peak:.3f} GiB a rank; launches {launched}")
    if rank == 0:
        d_r, d_1 = _rel(g_ring, g_32), _rel(g_one, g_32)
        limit = _limit(model.llama.embed_tokens.weight.dtype, d_1)
        say(f"  19b one card, the same {rows} rows (flash route, forward + backward): wall "
            f"{one_ms:.1f} ms, peak {one_peak:.3f} GiB")
        say(f"  19b adapter gradients ({g_ring.numel()} values), relative L2 from the fp32 "
            f"reference: ring {d_r:.3e}, one-card flash {d_1:.3e} (ratio "
            f"{d_r / d_1 if d_1 else float('nan'):.3f}; limit {limit:.3e})")
        if device.type == "cuda" and launched != want:
            raise AssertionError(f"19b ring: launches {launched}, expected {want}")
        if not (np.isfinite(d_r) and d_r <= limit):
            raise AssertionError(f"19b ring: gradients lie {d_r:.3e} from the reference, limit "
                                 f"{limit:.3e}")
    if dist.is_initialized():
        dist.barrier()
    del model, opt, state
    _free(device)
    return counts


# 19b's tensor parallelism inside training: (mode, (data, model)) on N ranks
TP_TRAIN_QUANT = {"sft": None, "lora": None, "int4": "int4", "int8": "int8",
                  "int8_fused": "int8_fused"}


def tp_train_runs(world: int) -> list:
    """Full SFT at (1, N) and, from 4 ranks, (2, N/2); LoRA r = 128 over
    bf16 and QLoRA int4 / int8 / int8_fused at (1, N)."""
    runs = [("sft", (1, world))]
    if world >= 4 and world % 2 == 0:
        runs.append(("sft", (2, world // 2)))
    return runs + [(m, (1, world)) for m in ("lora", "int4", "int8", "int8_fused")]


def _tp_train_launches(cfg, rows, mode) -> dict:
    """A rank's launches of one step: its heads' B3 / B3b (one call a layer
    whatever its share), and each projection's kernel once a call on its
    slice, or whole where the rule leaves it whole (phase 14's counts)."""
    extra = {"int4": dict(int4_matmul_prefill_tiled=8, int4_matmul_T_tiled=4),
             "int8": dict(int8_matmul=14),
             "int8_fused": dict(int8_stacked_fwd=14, int8_stacked_bwd=7)}.get(mode, {})
    return _train_launches(cfg, rows, **extra)


def _tp_train(rank: int, world: int, device, preset, rows: int, mode: str, shape) -> dict:
    """19b TP: one run of tensor parallelism inside training, the model
    `random:<preset>` at its widths (all its layers; quantized on the card
    for QLoRA), LoRA r = 128 (b ~ 0.02 N(0, 1)) but under full SFT, on a
    ('data', 'model') mesh of `shape`: each rank cuts its Megatron slices
    (`shard_for_training`), FSDP2 shards them over 'data', 2 steps on a
    global batch of `shape[0]` samples of `rows` rows. Rank 0 first runs
    the unsharded step on its card alone (`_one_card_steps`, the same
    batch and CVAE draws): step 0's loss and grad_norm lie within
    FSDP_LOSS_RTOL / FSDP_NORM_RTOL of its. Per step: wall ms, tokens/s,
    peak GiB a rank, collectives, launches (exact); a rank's bytes; on the
    card a third step traced (compute and NCCL device ms)."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel import tp as tp_mod

    say = _say(rank)
    label = f"19b TP {mode} {shape[0]}x{shape[1]}"
    model, cfg, _ = load_pretrained_model(f"random:{preset}", preset, device,
                                          quantize=TP_TRAIN_QUANT[mode])
    freeze = ("vision",) if mode == "sft" else ("vision", "llama")
    r = LORA_R if preset == "7b" else 2
    if mode != "sft":
        gen = torch.Generator(device=device).manual_seed(1)
        model.lora = init_lora(gen, cfg.llama, r, 2.0 * r, device=device)
        with torch.no_grad():
            for ad in model.lora.adapters.values():
                ad.b.normal_(0.0, 0.02, generator=gen)
    batch = _rows_batch(cfg, shape[0], rows)
    eps = [draw_eps(model, cfg, shape[0], step_generator(0, i, device)) for i in range(2)]
    if rank == 0:  # the reference updates its trainable weights: they are put back
        kept = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.split(".")[0] not in freeze + ("llama",)}
        ref = _one_card_steps(model, cfg, batch, *eps, freeze=freeze)
        if mode == "sft":  # the whole decoder trained: the model is built again
            del model
            _free(device)
            model, _, _ = load_pretrained_model(f"random:{preset}", preset, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in kept:
                    p.copy_(kept[n])
        del kept
        model.zero_grad(set_to_none=True)
        _free(device)
    if dist.is_initialized():
        dist.barrier()
    mesh = create_mesh(data=shape[0], model=shape[1], device=device.type)
    layout = shard_for_training(model, cfg, model_group(mesh))
    shard_model(model, mesh)
    _free(device)
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=freeze)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="auto", remat="full", mesh=mesh)
    held = bytes_per_rank(model)
    say(f"  {label}: heads split {layout.heads}, MLP split {layout.mlp}, int4 splits "
        f"{layout.int4 or '-'}, int8 splits {layout.int8 or '-'}, fallbacks "
        f"{layout.fallbacks or 'none'}; a rank holds parameters "
        f"{held['params'] / 2**30:.3f} GiB, buffers {held['buffers'] / 2**30:.3f} GiB")
    want = _tp_train_launches(cfg, rows, mode)
    launches = {}
    for i in range(2):
        reset_launches()
        _reset_peak(device)
        c0 = tp_mod.COLLECTIVES
        t0 = time.perf_counter()
        m = step(state, batch, 0, eps=eps[i])
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
        peak = _peak_gib(device)
        counts = read_launches()
        launched = {k: v for k, v in counts.items() if v}
        say(f"  {label} step {i}: loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}; wall "
            f"{wall:.1f} ms, {shape[0] * rows / wall * 1e3:.1f} tokens/s, peak {peak:.3f} GiB a "
            f"rank, {tp_mod.COLLECTIVES - c0} collectives a rank (the model group's; FSDP's "
            f"and the step's sums apart); launches {launched}")
        if device.type == "cuda" and launched != want:
            raise AssertionError(f"{label}: rank {rank} launches {launched}, expected {want}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: metrics not finite: {m}")
        if rank == 0 and i == 0:
            checks = [("loss", m["loss"], ref[0], FSDP_LOSS_RTOL),
                      ("grad_norm", m["grad_norm"], ref[1], FSDP_NORM_RTOL)]
            say(f"  {label} step 0 against one card's unsharded step on the same "
                f"{shape[0]} x {rows} rows: " + ", ".join(
                    f"{k} {v:.6f} / {r_:.6f} (rel {abs(v - r_) / abs(r_):.3e}, limit {tol:.0e})"
                    for k, v, r_, tol in checks))
            if any(abs(v - r_) > tol * abs(r_) for _, v, r_, tol in checks):
                raise AssertionError(f"{label}: step 0 departs from the one-card reference")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    if device.type == "cuda":  # a third step traced: where a step's time goes
        dev_ms, nccl_ms, heavy = _device_ms(lambda: step(state, batch, 0, eps=eps[1]), 1,
                                            device, top=8)
        say(f"  {label} a step traced: {dev_ms:.1f} ms device in compute kernels "
            f"({dev_ms / wall:.1%} of step 1's wall) and {nccl_ms:.1f} ms in NCCL's (their "
            "waits included); the top kernels (ms, calls): " + "; ".join(
                f"{k} {ms:.1f} ({n})" for k, ms, n in heavy))
    if dist.is_initialized():
        dist.barrier()
    del model, opt, state
    _free(device)
    return launches


def tp_cli_argv(preset: str, out: str, steps: int, batch: int, device: str = "cuda") -> list:
    """The train CLI's arguments of 19b's run: QLoRA int8_fused r = 128 (2
    at a small preset) over `--synthetic 4`."""
    r = LORA_R if preset == "7b" else 2
    return ["--model-path", f"random:{preset}", "--preset", preset, "--device", device,
            "--qlora", "int8_fused", "--lora-r", str(r), "--lora-alpha", str(2.0 * r),
            "--synthetic", "4", "--samples-per-epoch", "4", "--batch-size", str(batch),
            "--max-steps", str(steps), "--log-every", "1", "--output-dir", out]


def _tp_cli(rank: int, world: int, preset: str, out: str, device: str) -> None:
    """19b CLI: the train CLI's main() on the ranks as torchrun starts it,
    `--model-axis 2` (a world / 2 x 2 mesh), 2 steps and a checkpoint."""
    t0 = time.perf_counter()
    state = train_cli.main(tp_cli_argv(preset, out, 2, world // 2, device)
                           + ["--model-axis", "2"])
    _sync(torch.device(device, torch.cuda.current_device()) if device == "cuda"
          else torch.device(device))
    _say(rank)(f"  19b CLI --model-axis 2 --qlora int8_fused over {world} ranks: step "
               f"{state.step} in {time.perf_counter() - t0:.2f} s (model build and "
               "checkpoint included)")


def _parallel_rank(rank: int, world: int, device: str = "cuda", preset: str = "7b",
                   rows: int = TRAIN_ROWS, new_tokens: int = PAR_NEW_TOKENS) -> dict:
    """One rank of phase 19b (NCCL, one card a rank; gloo on the CPU at a
    small preset for the rehearsal); returns its launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device(device)
    say = _say(rank)
    launches = {name: 0 for name in WRAPPERS}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for quantize, kv_quant in ((None, None), ("int4", "int8")):
        t0 = time.perf_counter()
        add(_tp_decode(rank, world, quantize, kv_quant, device, preset, new_tokens))
        say(f"  19b decode {quantize or 'bf16'} wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    add(_fsdp_sft(rank, world, device, preset, rows))
    say(f"  19b FSDP wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    add(_seq_parallel(rank, world, device, preset, rows))
    say(f"  19b ring wall {time.perf_counter() - t0:.2f} s")
    if world == 1:
        say("  19b TP training needs two cards or more (a model group of one rank is the "
            "unsharded step): 19a stands for it on this card, its kernels on every rank's "
            "slices and a layer from the slices, summed by hand")
        return launches
    for mode, shape in tp_train_runs(world):
        t0 = time.perf_counter()
        add(_tp_train(rank, world, device, preset, rows, mode, shape))
        say(f"  19b TP {mode} {shape[0]}x{shape[1]} wall {time.perf_counter() - t0:.2f} s")
    return launches


def phase_parallel(device: str = "cuda", preset: str = "7b", ranks: int = 0,
                   rows: int = TRAIN_ROWS, new_tokens: int = PAR_NEW_TOKENS) -> dict:
    """Phase 19: 19a on this card, then 19b over every card (`ranks`: that
    many), one NCCL rank each (a rank that fails fails the phase), then 19c
    (over the ranks when they are two or more and even, else on one). On
    the CPU (`device="cpu"`, gloo ranks, a small `preset`, `rows` and
    `new_tokens`) 19b and 19c run, their kernels' plain versions in place
    of the kernels. Returns rank 0's launches of 19b's and 19c's runs."""
    if device == "cuda":
        log("phase 19a: the tensor-parallel shards at 7B's shapes, rank by rank on one card")
        t0 = time.perf_counter()
        check_tp_shards()
        log("phase 19a, training: B3 / B3b on each rank's heads, B5b / B7b / B9 / B10a / B10b "
            "on its slices, a layer from the slices, at 2048 rows")
        check_tp_train_shards()
        log(f"  phase 19a wall {time.perf_counter() - t0:.2f} s")
    n = ranks or torch.cuda.device_count()
    log(f"phase 19b: the world run over {n} rank(s): {preset} tensor-parallel decode (bf16, "
        "int4 + kv8), FSDP2 full SFT, the ring (--seq-parallel) LoRA step"
        + (", tensor parallelism inside training (full SFT, LoRA, QLoRA int4 / int8 / "
           "int8_fused) and the train CLI with --model-axis 2" if n > 1 else ""))
    _free(torch.device(device))
    t0 = time.perf_counter()
    launches = spawn(_parallel_rank, n, device, preset, rows, new_tokens, device=device,
                     timeout=1500)[0]
    log(f"  phase 19b wall {time.perf_counter() - t0:.2f} s")
    if n > 1 and n % 2 == 0:
        phase_tp_cli(n, device, preset)
    t0 = time.perf_counter()
    if n > 1 and n % 2 == 0:
        log(f"phase 19c: the train CLI's --eval-every over {n} ranks: {preset} steered, "
            f"QLoRA int8_fused and full SFT cut over ('data', 'model') meshes, one step, the "
            f"sharded evaluation of {EVAL_CLIPS} EK clips against one card's, the next step; "
            "then the CLI under torchrun with --model-axis 2 --eval-every 1")
        counts = phase_eval_parallel(n, device, preset, rows, new_tokens)
    else:
        log(f"phase 19c on one card: the one-rank evaluation of the steered {preset} model, "
            f"{EVAL_CLIPS} EK clips, per-clip draws")
        counts = phase_eval_one_card(device, preset, new_tokens)
    log(f"  phase 19c wall {time.perf_counter() - t0:.2f} s")
    for k, v in counts.items():
        launches[k] += v
    return launches


def phase_tp_cli(n: int, device: str = "cuda", preset: str = "7b") -> None:
    """19b CLI: the train CLI under `n` ranks with `--model-axis 2` (QLoRA
    int8_fused, 2 steps, a checkpoint), then resumed in this process on one
    card (`--max-steps 3` prints `resumed from step 2`): the checkpoint of
    the cut model is the one-rank layout. The directory (a 7B checkpoint)
    is removed after."""
    import contextlib
    import io
    import tempfile

    out = tempfile.mkdtemp(prefix="hv_tp_cli_")
    try:
        t0 = time.perf_counter()
        spawn(_tp_cli, n, preset, out, device, device=device, timeout=900)
        log(f"  19b CLI over {n} ranks wall {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            state = train_cli.main(tp_cli_argv(preset, out, 3, n // 2, device))
        resumed = "resumed from step 2" in text.getvalue()
        log(f"  19b CLI resumed on one rank: {'resumed from step 2' if resumed else 'NOT resumed'}"
            f", step {state.step} in {time.perf_counter() - t0:.2f} s")
        if not resumed or state.step != 3:
            raise AssertionError("19b CLI: the one-rank run did not resume the ranks' checkpoint")
        del state
    finally:
        shutil.rmtree(out, ignore_errors=True)
        _free(torch.device(device))


# ---------------------------------------------------------------------------
# phase 19c: the train CLI's --eval-every over several ranks
# ---------------------------------------------------------------------------

EVAL_CLIPS, EVAL_SEED = 4, 19  # the clips 19c decodes and its draws' seed
# the head's steering (steer_to_hand): every token's embedding holds
# STEER_C on residual coordinate 0, which no layer writes, and the head
# reads it alone with weight +STEER_U for <hand_traj>, -STEER_U for the rest
STEER_C, STEER_U = 16.0, 64.0
EVAL_REL = 2e-2  # 19c's ADE / FDE / WDE against the one-card evaluation, relative
# 19c's waypoints (every clip's pred_samples) against the one-card
# evaluation, max abs, by device: above the readings of sound runs (bf16
# on the card, fp32 in the CPU rehearsal), below those of the planted
# fault (`_slice_fault`; the readings in PERF.md §6)
EVAL_ABS = {"cuda": 0.1, "cpu": 1e-4}


def eval_runs(world: int, every_base: bool = False) -> list:
    """19c's runs: full SFT at (1, N) and QLoRA int8_fused r = 128 at (2,
    N/2); with `every_base` also LoRA r = 128 over bf16 and QLoRA int4 /
    int8 at (1, N), for each base's memory."""
    return ([("sft", (1, world)), ("int8_fused", (2, world // 2) if world >= 4 else (world, 1))]
            + [(mode, (1, world)) for mode in ("lora", "int4", "int8") if every_base])


@torch.no_grad()
def steer_to_hand(model, cfg) -> None:
    """Make a dense random model answer <hand_traj> at every step, whatever
    its weights elsewhere (quantize it after): the output row 0 of every o
    / down projection is zeroed, so no layer writes residual coordinate 0,
    which every token's embedding sets to STEER_C; the head reads that
    coordinate alone, +STEER_U for <hand_traj> and -STEER_U for every other
    token, so at every position <hand_traj> leads by 2 STEER_U x the final
    hidden's coordinate 0 (STEER_C over the residual's rms, plus the hand
    token's coordinate encoding, within +-1). Adapters attached later keep
    the rule with `steer_adapters`."""
    for lp in model.llama.layers:
        lp.self_attn.o_proj.weight[0].zero_()
        lp.mlp.down_proj.weight[0].zero_()
    model.llama.embed_tokens.weight[:, 0] = STEER_C
    head = model.llama.lm_head.weight
    head.zero_()
    head[:, 0] = -STEER_U
    head[cfg.hand_token_id, 0] = STEER_U


@torch.no_grad()
def steer_adapters(lora) -> None:
    """The o / down adapters' output column 0 zeroed (`steer_to_hand`'s rule)."""
    for name in ("wo", "w_down"):
        lora.adapters[name].b[..., 0] = 0.0


def _eval_preset(preset: str) -> str:
    """The EK layout's frames are 224 px: the tiny rehearsal takes tiny224."""
    return "tiny224" if preset == "tiny" else preset


def _ek_dataset(root: str, tokenizer):
    """The EK100 validation clips of the layout under `root` (the train
    CLI's `--eval-every` dataset)."""
    from handsonvlm_torch.data.epic_dataset import EpicConversationDataset
    from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name

    os.environ["HANDSONVLM_DATA_ROOT"] = root
    os.environ["HANDSONVLM_ASSETS_DIR"] = os.path.join(root, "assets")
    hoi = get_epic_hoi_dataset_by_name("ek100", "validation", load_images=True,
                                       rephrase_rate=0.0, use_percentage=1.0)
    return EpicConversationDataset(tokenizer, hoi, deterministic=True)


def _eval_launches(cfg, mode, prefills: int, decode_steps: int) -> dict:
    """A rank's launches of an evaluation that made `prefills` prefills and
    `decode_steps` decode steps: B2 once a CLIP layer a prefill, B1 once a
    layer a decode step over the rank's heads; by the base, on the rank's
    slices (or whole where the cut leaves it whole), B10a (int8_fused) or
    B9 (int8) once a projection a layer a forward, B4b once a fused int4
    projection a layer a decode step and B5b a prefill (the prompts stay
    under FLASH_MIN_T: no B3)."""
    n_layers = cfg.llama.num_layers
    want = {"vit_attention": (cfg.vision.num_layers + cfg.vision.select_layer + 1) * prefills,
            "decode_attention_stacked": n_layers * decode_steps}
    if mode == "int8_fused":
        want["int8_stacked_fwd"] = 7 * n_layers * (prefills + decode_steps)
    if mode == "int8":
        want["int8_matmul"] = 7 * n_layers * (prefills + decode_steps)
    if mode == "int4":
        want["int4_gemv_tiled"] = 4 * n_layers * decode_steps
        want["int4_matmul_prefill_tiled"] = 4 * n_layers * prefills
    return {k: v for k, v in want.items() if v}


def _timed_eval(label, model, cfg, tokenizer, dataset, mesh, new_tokens, device, mode,
                rank=0, groups=1, say=log) -> dict:
    """One evaluation of EVAL_CLIPS clips at `new_tokens` (every rank of
    `mesh` calls it; the records gathered on every rank): wall, decode
    tok/s of this rank's group, peak GiB, collectives a forward, launches
    exact against the forwards this rank's group made."""
    from handsonvlm_torch.parallel import tp as tp_mod
    from handsonvlm_torch.parallel.tp import tp_size
    from torch.distributed.tensor import DTensor

    tp = model_group(mesh)
    group = rank // tp_size(tp)
    # what eval_model allocates: the FSDP-sharded parameters whole over 'data'
    copy = sum(p.numel() * p.element_size() for p in model.parameters()
               if isinstance(p, DTensor))
    reset_launches()
    _reset_peak(device)
    c0 = tp_mod.COLLECTIVES
    t0 = time.perf_counter()
    res = evaluate_sharded(model, cfg, tokenizer, dataset, mesh, seed=EVAL_SEED,
                           limit=EVAL_CLIPS, max_new_tokens=new_tokens)
    _sync(device)
    wall = time.perf_counter() - t0
    peak = _peak_gib(device)
    counts = {k: v for k, v in read_launches().items() if v}
    mine = [v for i, v in res["val_info"].items() if i % groups == group]
    prefills = len(mine)
    tokens = sum(int(v["num_tokens"]) for v in mine)
    steps = tokens - prefills
    per_fwd = (tp_mod.COLLECTIVES - c0) / max(prefills + steps, 1)
    hand = sum(int((np.asarray(v["gen_ids"]) == cfg.hand_token_id).sum())
               for v in res["val_info"].values())
    every = sum(len(v["gen_ids"]) for v in res["val_info"].values())
    say(f"  {label}: {len(res['val_info'])} clips x {new_tokens} new tokens over {groups} eval "
        f"group(s), n={res['n']} with a trajectory, ADE {res['ade']:.6f} FDE {res['fde']:.6f} "
        f"WDE {res['wde']:.6f}, <hand_traj> {hand} of {every} tokens; wall {wall:.3f} s, "
        f"decode {tokens / wall:.2f} tok/s a group ({prefills} clips, {tokens} tokens on rank {rank}'s group), peak {peak:.3f} GiB a "
        f"rank, eval copy {copy / 2**30:.3f} GiB a rank, {per_fwd:.1f} collectives a forward "
        f"(prefills included); launches {counts}")
    want = _eval_launches(cfg, mode, prefills, steps)
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"{label}: rank {rank} launches {counts}, expected {want}")
    return res


def _steered_model(mode: str, preset: str, device):
    """19c's model: `random:<preset>` steered to <hand_traj>, then
    quantized for QLoRA (`TP_TRAIN_QUANT`, as the builder quantizes it) and,
    but under full SFT, LoRA r = 128 with b ~ 0.02 N(0, 1)."""
    model, cfg, tokenizer = load_pretrained_model(f"random:{preset}", preset, device)
    steer_to_hand(model, cfg)
    quantize_model(model, cfg, TP_TRAIN_QUANT[mode])
    if mode != "sft":
        r = LORA_R if preset == "7b" else 2
        gen = torch.Generator(device=device).manual_seed(1)
        model.lora = init_lora(gen, cfg.llama, r, 2.0 * r, device=device)
        with torch.no_grad():
            for ad in model.lora.adapters.values():
                ad.b.normal_(0.0, 0.02, generator=gen)
        steer_adapters(model.lora)
    return model, cfg, tokenizer


def _eval_gap(got, want) -> tuple:
    """(clips whose generated ids differ, the waypoints' max abs gap over
    every clip's samples, ADE / FDE / WDE relative gaps) of two
    evaluations of the same clips."""
    if list(got["val_info"]) != list(want["val_info"]):
        raise AssertionError(f"clips {list(got['val_info'])} against {list(want['val_info'])}")
    ids = [i for i, w in want["val_info"].items()
           if not np.array_equal(got["val_info"][i]["gen_ids"], w["gen_ids"])]
    gap = max(float(np.abs(got["val_info"][i]["pred_samples"] - w["pred_samples"]).max())
              for i, w in want["val_info"].items())
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("ade", "fde", "wde")}
    return ids, gap, rel


def _eval_held(label, got, want, limit, say) -> str | None:
    """19c's rule: the same n (> 0), every clip's generated ids equal, its
    waypoints within `limit` (EVAL_ABS), ADE / FDE / WDE within EVAL_REL.
    Returns what failed (the caller raises it once its control has
    printed), or None."""
    ids, gap, rel = _eval_gap(got, want)
    say(f"  {label} against one card's evaluation of the whole state: n {got['n']} / "
        f"{want['n']}, clips with other ids {ids}, waypoints max abs {gap:.3e} (limit "
        f"{limit:.0e}), " + ", ".join(f"{k} rel {v:.3e}" for k, v in rel.items())
        + f" (limit {EVAL_REL:.0e})")
    if not (got["n"] == want["n"] > 0 and not ids and gap <= limit
            and all(v <= EVAL_REL for v in rel.values())):
        return f"{label}: the sharded evaluation departs from one card's"
    return None


@contextlib.contextmanager
def _slice_fault(model, rank: int):
    """19c's control: within it, rank 1 of a model group that is the world
    holds rank 0's slices of a dense cut decoder (a cut made for the wrong
    rank; the FSDP shards over a 'data' axis of one are the whole slices);
    its own slices are put back after. Every rank enters it."""
    import torch.distributed as dist

    with torch.no_grad():
        slices = [model.llama.get_parameter(k).to_local() for k in model.llama.tp_cuts]
        kept = [t.clone() for t in slices]
        for t in slices:
            first = t.clone()
            dist.broadcast(first, src=0)
            if rank == 1:
                t.copy_(first)
    try:
        yield
    finally:
        with torch.no_grad():
            for t, k in zip(slices, kept):
                t.copy_(k)


def _tp_eval(rank: int, world: int, device, preset, rows: int, mode: str, shape, root: str,
             new_tokens: int) -> dict:
    """19c: one run of the train CLI's evaluation over several ranks. The
    steered model (`_steered_model`); rank 0 first runs the unsharded steps
    0 and 1 on its card alone (`_one_card_steps`). Then every rank cuts its
    slices on a ('data', 'model') mesh of `shape`, FSDP2 shards them, and
    the run takes step 0 (held to the one-card step as 19b holds it); the
    whole state after it goes to rank 0's card, whose evaluation of it is
    the reference; then the sharded evaluation (`evaluate_sharded`: the
    clips split over the data groups, each on its model group's slices,
    launches exact on every rank: `_eval_held` against the reference);
    under full SFT at (1, N) the control, the evaluation again with a
    wrong slice planted (`_slice_fault`), which the rule must refuse,
    the slices put back; and step 1 (its loss within FSDP_LOSS1_RTOL of
    the one-card step 1: neither evaluation left the training state
    altered). Returns the rank's launches of the sharded evaluation."""
    import torch.distributed as dist

    from handsonvlm_torch.parallel.partition import full_state_dict

    say = _say(rank)
    label = f"19c {mode} {shape[0]}x{shape[1]}"
    model, cfg, tokenizer = _steered_model(mode, preset, device)
    dataset = _ek_dataset(root, tokenizer)
    freeze = ("vision",) if mode == "sft" else ("vision", "llama")
    # the tiny224 rehearsal's frames take 356 rows: its samples are longer
    batch = _rows_batch(cfg, shape[0], max(rows, cfg.num_visual_tokens + 64))
    eps = [draw_eps(model, cfg, shape[0], step_generator(0, i, device)) for i in range(2)]
    if rank == 0:  # the reference updates its trainable weights: they are put back
        kept = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.split(".")[0] not in freeze + ("llama",)}
        ref = _one_card_steps(model, cfg, batch, *eps, freeze=freeze)
        if mode == "sft":  # the whole decoder trained: the model is built again
            del model
            _free(device)
            model, _, _ = _steered_model(mode, preset, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in kept:
                    p.copy_(kept[n])
        del kept
        model.zero_grad(set_to_none=True)
        _free(device)
    if dist.is_initialized():
        dist.barrier()
    mesh = create_mesh(data=shape[0], model=shape[1], device=device.type)
    if model_group(mesh) is not None:
        shard_for_training(model, cfg, model_group(mesh))
    shard_model(model, mesh)
    _free(device)
    opt = make_optimizer(model, TRAIN_LR, freeze_top_keys=freeze)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="auto", remat="full", mesh=mesh)
    launches = {}
    for i in range(2):
        m = step(state, batch, 0, eps=eps[i])
        _sync(device)
        if rank == 0:
            checks = [("loss", m["loss"], ref[2 * i], FSDP_LOSS1_RTOL if i else FSDP_LOSS_RTOL)]
            if i == 0:
                checks.append(("grad_norm", m["grad_norm"], ref[1], FSDP_NORM_RTOL))
            say(f"  {label} step {i}{' (after the evaluation)' if i else ''} against one "
                f"card's: " + ", ".join(
                    f"{k} {v:.6f} / {r_:.6f} (rel {abs(v - r_) / abs(r_):.3e}, limit {t:.0e})"
                    for k, v, r_, t in checks))
            if any(abs(v - r_) > t * abs(r_) for _, v, r_, t in checks):
                raise AssertionError(f"{label}: step {i} departs from the one-card reference")
        if i:
            break
        whole = full_state_dict(model)
        if rank == 0:  # the reference: one card's evaluation of the whole state
            one = build_model(cfg, device, quantize=TP_TRAIN_QUANT[mode])
            if mode != "sft":
                one.lora = LoRA(cfg.llama, r=model.lora.adapters["wq"].a.shape[-1],
                                device=device)
            one.load_state_dict(whole)
            del whole
            ref_eval = _timed_eval(f"{label} one-card reference", one, cfg, tokenizer,
                                   dataset, None, new_tokens, device, mode, say=say)
            del one
        else:
            del whole
        _free(device)
        if dist.is_initialized():
            dist.barrier()
        res = _timed_eval(label, model, cfg, tokenizer, dataset, mesh, new_tokens, device,
                          mode, rank, world // shape[1], say)
        launches = read_launches()
        held = _eval_held(label, res, ref_eval, EVAL_ABS[device.type], say) if rank == 0 \
            else None
        if mode == "sft" and shape[0] == 1:  # the control: a wrong slice fails the rule
            with _slice_fault(model, rank):
                bad = evaluate_sharded(model, cfg, tokenizer, dataset, mesh, seed=EVAL_SEED,
                                       limit=EVAL_CLIPS, max_new_tokens=new_tokens)
            if rank == 0:
                ids, gap, rel = _eval_gap(bad, ref_eval)
                say(f"  {label} planted fault (rank 1 on rank 0's slices) against one card's: "
                    f"n {bad['n']}, clips with other ids {ids}, waypoints max abs {gap:.3e}, "
                    + ", ".join(f"{k} rel {v:.3e}" for k, v in rel.items()))
                if not ids and gap <= EVAL_ABS[device.type]:
                    raise AssertionError(f"{label}: 19c's rule passes a wrong slice")
        if held:
            raise AssertionError(held)
    if dist.is_initialized():
        dist.barrier()
    del model, opt, state
    _free(device)
    return launches


def _eval_rank(rank: int, world: int, device: str, preset: str, rows: int, root: str,
               new_tokens: int, every_base: bool = False) -> dict:
    """One rank of phase 19c; returns its launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device(device)
    if device.type == "cpu":  # the rehearsal's gloo ranks share the host's cores
        torch.set_num_threads(1)
    launches = {name: 0 for name in WRAPPERS}
    for mode, shape in eval_runs(world, every_base):
        t0 = time.perf_counter()
        for k, v in _tp_eval(rank, world, device, _eval_preset(preset), rows, mode, shape,
                             root, new_tokens).items():
            launches[k] += v
        _say(rank)(f"  19c {mode} {shape[0]}x{shape[1]} wall {time.perf_counter() - t0:.2f} s")
    return launches


def _with_ek_layout(fn):
    """Run fn(root) over an EK100 layout (write_ek_fixture, EVAL_CLIPS
    validation clips) in a temporary directory, removed after, with the
    data-root variables put back."""
    root = tempfile.mkdtemp(prefix="handsonvlm_ek_")
    env = {k: os.environ.get(k) for k in ("HANDSONVLM_DATA_ROOT", "HANDSONVLM_ASSETS_DIR")}
    try:
        write_ek_fixture(root, n_val=EVAL_CLIPS)
        return fn(root)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def phase_eval_parallel(n: int, device: str = "cuda", preset: str = "7b",
                        rows: int = TRAIN_ROWS, new_tokens: int = PAR_NEW_TOKENS,
                        every_base: bool = False) -> dict:
    """19c: the train CLI's evaluation over `n` ranks (one NCCL rank a
    card), `eval_runs(n, every_base)` (`_tp_eval`) over the EK layout, then
    the train CLI itself under torchrun (`_torchrun_eval_cli`). Returns
    rank 0's launches of the sharded evaluations."""
    t0 = time.perf_counter()

    def run(root):
        launches = spawn(_eval_rank, n, device, preset, rows, root, new_tokens, every_base,
                         device=device, timeout=1200)[0]
        log(f"  19c runs wall {time.perf_counter() - t0:.2f} s")
        _torchrun_eval_cli(n, device, _eval_preset(preset), root)
        return launches

    return _with_ek_layout(run)


def _torchrun_eval_cli(n: int, device: str, preset: str, root: str) -> None:
    """19c CLI: `torchrun --nproc-per-node n -m handsonvlm_torch.train.train`
    with `--model-axis 2 --eval-every 1 --eval-samples 4` (QLoRA int8_fused,
    one step over --synthetic) over the EK layout `root`: it must print one
    `eval/*` line (the random head is not steered: n may be 0)."""
    out = tempfile.mkdtemp(prefix="hv_eval_cli_")
    try:
        argv = tp_cli_argv(preset, out, 1, n // 2, device) + [
            "--model-axis", "2", "--eval-every", "1", "--eval-samples", str(EVAL_CLIPS)]
        env = dict(os.environ, HANDSONVLM_DATA_ROOT=root,
                   HANDSONVLM_ASSETS_DIR=os.path.join(root, "assets"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", str(n), "-m", "handsonvlm_torch.train.train",
                               *argv], env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        evals = [m for m in lines if "eval/n" in m]
        log(f"  19c CLI under torchrun, {n} ranks, --model-axis 2 --eval-every 1 --eval-samples "
            f"{EVAL_CLIPS}: exit {proc.returncode}, wall {wall:.2f} s (model build, step, "
            f"evaluation, checkpoint); eval lines {evals}")
        if proc.returncode != 0 or len(evals) != 1:
            raise AssertionError("19c CLI: torchrun run failed or printed other than one eval "
                                 f"line\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_eval_one_card(device: str = "cuda", preset: str = "7b",
                        new_tokens: int = PAR_NEW_TOKENS) -> dict:
    """19c on one card: the one-rank evaluation of the steered bf16 model
    (`random:<preset>`) over the EK layout, per-clip draws, n > 0, scores
    finite, launches exact."""
    device = torch.device(device)
    preset = _eval_preset(preset)

    def run(root):
        model, cfg, tokenizer = _steered_model("sft", preset, device)
        res = _timed_eval("19c one card (bf16, steered)", model, cfg, tokenizer,
                          _ek_dataset(root, tokenizer), None, new_tokens, device, "sft")
        launches = read_launches()
        if not (res["n"] > 0 and all(np.isfinite(res[k]) for k in ("ade", "fde", "wde"))):
            raise AssertionError(f"19c one card: n {res['n']}, scores {res}")
        del model
        _free(device)
        return launches

    return _with_ek_layout(run)


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
    log("phase 18b/18c: LITA-HOI over the 7B decoder (loss, backward, rollout; plain and "
        "flash routes) and the origin visual pipeline at CLIP-L, bf16")
    t0 = time.perf_counter()
    hoi = phase_hoi_7b(model, cfg)
    log(f"  phase 18b/18c bf16 wall {time.perf_counter() - t0:.2f} s")
    log("phase 4: bf16 kernel path against plain path at 7B, chat and long prompt")
    h_dense, tok_dense, launches["decode_attention"] = phase_kernel_vs_plain(
        model, cfg, tokenizer, video, frame_map, long_text=long_text)
    log("phase 18b/18c reference: the same on the plain routes in fp32")
    t0 = time.perf_counter()
    hoi_launches = phase_hoi_7b_reference(model, hoi)
    log(f"  phase 18b/18c reference wall {time.perf_counter() - t0:.2f} s")
    del model, hoi
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
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 16: the EK100 eval CLI at 7B over an on-disk EK100 layout: bf16 serial, "
        "int4 + kv8 reasoning batched, bf16 speculative")
    phase_ek_cli()
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 17: the HTTP serving stack at 7B: controller, bf16 worker (continuous "
        "batching, speculative, two LoRA adapters), web server, test_message; int4 + kv8 "
        "worker with the dynamic batcher")
    t0 = time.perf_counter()
    phase_serving()
    log(f"  phase 17 wall {time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 18a: the hoi-forecast training CLI at the reference width (embed 512, batch "
        "128): 2 epochs with evaluation, then a resumed run")
    t0 = time.perf_counter()
    phase_hoi_cli()
    log(f"  phase 18a wall {time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    parallel = phase_parallel()

    launches["flash_attention"] += train.pop("flash_attention")
    launches.update(train)
    for name, n in hoi_launches.items():
        launches[name] += n
    for name, n in parallel.items():
        launches[name] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
