"""The Hopper kernels against their plain versions, on the card.

The `cuda` tests skip where torch.cuda.is_available() is false. This file
imports no jax, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py

Tolerance, kernel vs plain version (max abs): attention 1e-2 in bf16
(rounding of the output, and of p in the plain vit version), 1e-4 in fp32
(summation order). The int4 and int8 matmuls: 2e-3 x max|y| plus one bf16
rounding step of the element in bf16 (both sides round f32 sums taken in
another order to bf16, and a sum next to a rounding boundary lands one step
apart), 1e-4 x max|y| in fp32 (summation order). The flat int4 kernels
(B4c, B5a) give the tiled ones' bits (B4b, B5b) on the same weight, and a
GEMV's rows (B4b, B9) are bit-equal alone and in a window. The backward
kernels: B3b's gradients within 2e-2 (bf16) or 1e-4 (fp32) of max|want|
(p and ds are rounded as in the plain version, the sums taken in another
order), B7a / B7b under the int4 rule, and every wrapper on an input that
requires grad either carries the plain version's gradient or raises. The
fused QLoRA matmuls B10a / B10b round their outputs to bf16 whatever the
input dtype, so they take the int4 rule in bf16 for every input. The fused
decode MLP B11 rounds xn and act to bf16 but keeps an fp32 residual: bf16
rows take the int4 rule, fp32 rows 3e-4 x max|y| with no per-element term.
"""

import numpy as np
import pytest
import torch

from handsonvlm_torch.models.llama import _quantize_kv_rows
from handsonvlm_torch.ops.cache_ops import gather_cache_blocks, gather_cache_blocks_ref
from handsonvlm_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ref,
    decode_attention_stacked,
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.ops.attention import attention_xla
from handsonvlm_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from handsonvlm_torch.ops.int8_matmul import (
    _launch_int8,
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
    int4_matmul_stacked,
    int4_matmul_T_flat,
    int4_matmul_T_flat_ref,
    int4_matmul_T_tiled,
    int4_matmul_T_tiled_ref,
    int8_matmul,
    int8_matmul_ref,
    maybe_int8_matmul,
    quantize_int4,
    quantize_stacked_int8,
    tile_int4_stacked,
    untile_int4_stacked,
)
from handsonvlm_torch.ops.fused_decode import (
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
)
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref

# (L, B, S, H, K, D, T, layer, length, mask)
DECODE_CASES = {
    "layer0": (3, 2, 48, 4, 4, 16, 1, 0, 37, None),
    "last_layer": (3, 2, 48, 4, 4, 16, 1, 2, 37, None),
    "gqa_h8_k2": (2, 2, 48, 8, 2, 16, 1, 1, 40, None),
    "left_pad_and_hole": (2, 2, 48, 4, 4, 16, 1, 0, 45, "pad_hole"),
    "length_1": (2, 1, 48, 4, 4, 16, 1, 1, 1, None),
    "length_block_edge": (2, 1, 48, 4, 4, 16, 1, 0, 16, None),
    "length_past_block_edge": (2, 1, 48, 4, 4, 16, 1, 0, 17, None),
    "length_full": (2, 1, 48, 4, 4, 16, 1, 0, 48, None),
    "window_t4": (2, 2, 48, 8, 2, 16, 4, 1, 30, "pad_hole"),
    "all_masked_row": (2, 2, 48, 4, 4, 16, 1, 1, 37, "dead_row"),
    "masked_first_split": (2, 1, 96, 4, 4, 16, 2, 1, 90, "long_pad"),
}


def decode_inputs(L, B, S, H, K, D, T, mask_kind, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    ck = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    cv = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = np.ones((B, S), bool)
        mask[:, :5] = False  # left pad
        mask[:, 20:26] = False  # interior hole
        if mask_kind == "dead_row":
            mask[1] = False
        if mask_kind == "long_pad":  # a whole 32-key tile and more
            mask[:, :40] = False
    return q, ck, cv, mask


def fragmented_mask(B, S, length):
    """(B, S) key masks as continuous batching leaves them, valid keys below
    `length` only: row 3 of every 4 is dead; of the others, rows 0 mod 3
    have a leading pad and an interior hole of 512 keys, rows 1 mod 3 a
    40-key hole inside one block, rows 2 mod 3 two islands (the first block
    and a quarter of the cache empty). The rows list different counts of
    256-key blocks."""
    mask = np.zeros((B, S), bool)
    for r in range(B):
        if r % 4 == 3:
            continue
        if r % 3 == 0:
            mask[r, 7:length] = True
            mask[r, 256:768] = False
        elif r % 3 == 1:
            mask[r, :length] = True
            mask[r, 300:340] = False
        else:
            mask[r, 512:600] = True
            mask[r, length - 90:length] = True
    return mask


def left_moving_table(rng, b, nk):
    """(b, nk) int32 tables as compaction builds them: row r keeps a random
    ascending subset of its blocks at the front (table[r, j] >= j) and
    leaves the rest where they are."""
    table = np.tile(np.arange(nk, dtype=np.int32), (b, 1))
    for r in range(b):
        m = int(rng.integers(0, nk + 1))
        table[r, :m] = np.sort(rng.choice(nk, size=m, replace=False))
    return table


def quantize_cache(ck, cv):
    """A float (L, B, S, K, D) cache -> int8 k, v and their (L, B, K, S)
    scales, as models/llama.quantize_kv_cache lays them out."""
    k8, ks = _quantize_kv_rows(ck)
    v8, vs = _quantize_kv_rows(cv)
    return k8, v8, ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()


# (din, dout) of the tiny preset's and the 7B preset's fused projections
INT4_SHAPES = {
    "tiny_wqkv": (64, 192), "tiny_w_down": (128, 64),
    "7b_wqkv": (4096, 12288), "7b_wo": (4096, 4096), "7b_wgu": (4096, 22016),
    "7b_w_down": (11008, 4096),
}


def int4_weights(din, dout, layers, device, seed):
    """Random (layers, din, dout) weights, quantized and tiled as
    models/llama.quantize_llama_int4 does: (w4t, gst)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    packed = [quantize_int4(0.02 * torch.randn((din, dout), generator=gen, device=device))
              for _ in range(layers)]
    return tile_int4_stacked(torch.stack([p[0] for p in packed]),
                             torch.stack([p[1] for p in packed]))


def assert_int4_close(got, want, dtype):
    got, want = got.float(), want.float()
    bound = (2e-3 if dtype == torch.bfloat16 else 1e-4) * want.abs().max()
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.abs()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


CUDA_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=0), torch.float32: dict(atol=1e-4, rtol=0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_decode_attention_kernel(cuda, case, dtype):
    L, B, S, H, K, D, T, layer, length, mask_kind = DECODE_CASES[case]
    q, ck, cv, mask = decode_inputs(L, B, S, H, K, D, T, mask_kind, seed=len(case))
    q, ck, cv = (torch.from_numpy(x).to(cuda, dtype) for x in (q, ck, cv))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = decode_attention_stacked.LAUNCHES
    got = decode_attention_stacked(q, ck, cv, layer, length, key_mask=t_mask)
    torch.cuda.synchronize()
    assert decode_attention_stacked.LAUNCHES == before + 1
    want = decode_attention_stacked_ref(q, ck, cv, layer, length, key_mask=t_mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 17, 2, 64), (10, 257, 16, 64)])
def test_vit_attention_kernel(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    before = vit_attention.LAUNCHES
    got = vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), vit_attention_ref(q, k, v).float(),
                               **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_decode_attention_q_kernel(cuda, case, dtype):
    L, B, S, H, K, D, T, layer, length, mask_kind = DECODE_CASES[case]
    q, ck, cv, mask = decode_inputs(L, B, S, H, K, D, T, mask_kind, seed=len(case))
    k8, v8, ks, vs = (x.to(cuda) for x in quantize_cache(torch.from_numpy(ck),
                                                         torch.from_numpy(cv)))
    q = torch.from_numpy(q).to(cuda, dtype)
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = decode_attention_stacked_q.LAUNCHES
    got = decode_attention_stacked_q(q, k8, v8, ks, vs, layer, length, key_mask=t_mask)
    torch.cuda.synchronize()
    assert decode_attention_stacked_q.LAUNCHES == before + 1
    want = decode_attention_stacked_q_ref(q, k8, v8, ks, vs, layer, length, key_mask=t_mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 8, 127])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_gemv_kernel(cuda, shape, m, dtype):
    w4t, gst = int4_weights(*INT4_SHAPES[shape], 2, cuda, seed=m)
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    x = torch.randn((m, INT4_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
    before = int4_gemv_tiled.LAUNCHES
    got = int4_gemv_tiled(x, w4t, gst, 1)
    torch.cuda.synchronize()
    assert int4_gemv_tiled.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (m, INT4_SHAPES[shape][1])
    assert_int4_close(got, int4_gemv_tiled_ref(x, w4t, gst, 1), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [128, 200, 391])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_prefill_kernel(cuda, shape, m, dtype):
    w4t, gst = int4_weights(*INT4_SHAPES[shape], 2, cuda, seed=m)
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    x = torch.randn((1, m, INT4_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
    before = int4_matmul_prefill_tiled.LAUNCHES
    got = int4_matmul_prefill_tiled(x, w4t, gst, 1)
    torch.cuda.synchronize()
    assert int4_matmul_prefill_tiled.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (1, m, INT4_SHAPES[shape][1])
    assert_int4_close(got, int4_matmul_prefill_tiled_ref(x, w4t, gst, 1), dtype)


# (shape, seq_axis, block_k): 7B-like k/v planes, scale planes, and a plane
# whose blocks are not a multiple of 16 bytes (the byte-copy path)
GATHER_CASES = {
    "kv": ((2, 3, 512, 4, 32), 2, 128),
    "scales": ((2, 3, 4, 512), 3, 128),
    "odd_bytes": ((2, 2, 64, 1, 5), 2, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_cache_blocks_kernel(cuda, case, dtype):
    shape, seq_axis, bk = GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    c = torch.from_numpy(rng.integers(-100, 100, size=shape)).to(cuda, dtype)
    table = left_moving_table(rng, shape[1], shape[seq_axis] // bk)
    want = gather_cache_blocks_ref(c.clone(), table, block_k=bk, seq_axis=seq_axis)
    ptr = c.data_ptr()
    before = gather_cache_blocks.LAUNCHES
    got = gather_cache_blocks(c, table, block_k=bk, seq_axis=seq_axis)
    torch.cuda.synchronize()
    assert gather_cache_blocks.LAUNCHES == before + 1
    assert got.data_ptr() == ptr  # in place
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tw", [1, 4])
def test_decode_attention_fragmented_kernel(cuda, tw, quant, dtype):
    L, B, S, H, K, D, length = 2, 8, 1024, 8, 2, 64, 1000
    q, ck, cv, _ = decode_inputs(L, B, S, H, K, D, tw, None, seed=tw + quant)
    mask = torch.from_numpy(fragmented_mask(B, S, length)).to(cuda)
    q = torch.from_numpy(q).to(cuda, dtype)
    if quant:
        cache = [x.to(cuda) for x in quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))]
        got = decode_attention_stacked_q(q, *cache, 1, length, key_mask=mask)
        want = decode_attention_stacked_q_ref(q, *cache, 1, length, key_mask=mask)
    else:
        ck, cv = (torch.from_numpy(x).to(cuda, dtype) for x in (ck, cv))
        got = decode_attention_stacked(q, ck, cv, 1, length, key_mask=mask)
        want = decode_attention_stacked_ref(q, ck, cv, 1, length, key_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    assert not bool(got[3].any())  # a dead row gives 0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_bit_equal_across_compaction(cuda, quant):
    """The kernel's output for a live row is bit-equal after its blocks
    move to lower indices (B8) and another row's plane is emptied."""
    L, B, S, H, K, D, bk = 1, 2, 1024, 8, 2, 64, 256
    q, ck, cv, _ = decode_inputs(L, B, S, H, K, D, 1, None, seed=7)
    q = torch.from_numpy(q).to(cuda, torch.bfloat16)
    if quant:
        cache = [x.to(cuda) for x in quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))]
        attend = decode_attention_stacked_q
    else:
        cache = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (ck, cv)]
        attend = decode_attention_stacked
    mask = np.zeros((B, S), bool)
    mask[0, 300:700] = True
    mask[0, 900:990] = True
    mask[1, :990] = True
    out = attend(q, *cache, 0, 990, key_mask=torch.from_numpy(mask).to(cuda))
    table = np.array([[1, 2, 3, 3], [0, 1, 2, 3]])
    for plane, axis in zip(cache, (2, 2, 3, 3)):
        gather_cache_blocks(plane, table, block_k=bk, seq_axis=axis)
    moved = np.zeros_like(mask)
    moved[0, 300 - bk:990 - bk] = mask[0, 300:990]
    got = attend(q, *cache, 0, 990 - bk, key_mask=torch.from_numpy(moved).to(cuda))
    assert torch.equal(got[0], out[0])


# (B, T, S, H, K, D, causal, q_offset, mask): tiny shapes on the f32-FMA path
# (D = 16) and the tensor-core path (bf16 at D = 64 / 128 / 256), ragged
# lengths, GQA, a prefill at a cache index, and the 7B long-prompt shape
FLASH_CASES = {
    "tiny_d16_offset": (2, 37, 50, 4, 4, 16, True, 13, "left_pad"),
    "gqa_d64": (2, 70, 70, 8, 2, 64, True, 0, None),
    "noncausal_hole_d64": (1, 65, 130, 4, 4, 64, False, 0, "hole"),
    "d128_at_index": (1, 300, 512, 4, 4, 128, True, 100, "left_pad"),
    "d256_gqa": (1, 100, 100, 2, 1, 256, True, 0, None),
    "7b_2304_over_2560": (1, 2304, 2560, 32, 32, 128, True, 0, "left_pad"),
}


def flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed):
    """q (B, T, H, D), k/v (B, S, K, D) and a key mask (B, S): the keys a
    prefill of T rows at cache index `q_offset` has written, less a left
    pad ("left_pad") or an interior hole ("hole")."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = np.zeros((B, S), bool)
        mask[:, :min(S, q_offset + T)] = True
        if mask_kind == "left_pad":
            mask[:, :5] = False
        elif mask_kind == "right_pad":  # a training row's padded tail
            mask[:, max(1, min(S, q_offset + T) - 13):] = False
        else:
            mask[:, 40:110] = False  # a whole 64-key tile and more
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_attention_kernel(cuda, case, dtype):
    """Output and logsumexp against the plain version. Rows with no valid
    key (the left pad under causal masking) give 0 / NEG_INF in both."""
    B, T, S, H, K, D, causal, q_offset, mask_kind = FLASH_CASES[case]
    q, k, v, mask = flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed=len(case))
    q = torch.from_numpy(q).to(cuda, dtype)
    # k, v as views of one layer of a stacked cache: read in place
    ck, cv = (torch.from_numpy(np.stack([x, x + 1.0])).to(cuda, dtype)[0] for x in (k, v))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = flash_attention.LAUNCHES
    got, lse = flash_attention(q, ck, cv, key_mask=t_mask, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    want, want_lse = flash_attention_ref(q, ck, cv, key_mask=t_mask, causal=causal,
                                         q_offset=q_offset)
    assert got.shape == (B, T, H, D) and lse.shape == (B, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    # logsumexp is fp32 in both; bf16 inputs only round q and k
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_strided_views(cuda):
    """The first n positions of a cache layer, as a view, give what a
    contiguous copy gives."""
    q, k, v, _ = flash_inputs(2, 90, 200, 4, 4, 128, 0, None, seed=1)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v))
    got, lse = flash_attention(q, k[:, :96], v[:, :96], q_offset=6)
    want, want_lse = flash_attention(q, k[:, :96].contiguous(), v[:, :96].contiguous(),
                                     q_offset=6)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_grad(cuda):
    """The logsumexp output refuses a gradient (it is the backward's input,
    not a differentiable output); the attention output takes one."""
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    out, lse = flash_attention(q, q, q)
    assert out.requires_grad and not lse.requires_grad


# (B, T, S, H, K, D, causal, q_offset, mask): the backward's cases
FLASH_BWD_CASES = {
    "d128_causal": (1, 200, 200, 4, 4, 128, True, 0, None),
    "d128_q_offset": (1, 100, 300, 4, 4, 128, True, 200, None),
    "d128_right_pad": (2, 150, 150, 4, 4, 128, True, 0, "right_pad"),
    "d64_left_pad_dead_rows": (2, 77, 77, 4, 4, 64, True, 0, "left_pad"),
    "gqa_d64": (2, 70, 70, 8, 2, 64, True, 0, None),
    "noncausal_hole_d64": (1, 65, 130, 4, 4, 64, False, 0, "hole"),
    "fma_d32_gqa": (1, 45, 60, 4, 2, 32, True, 15, None),
    "7b_2048": (1, 2048, 2048, 32, 32, 128, True, 0, "right_pad"),
}


def assert_grad_close(got, want, dtype, name, want32=None):
    """Gradients per element: |got - want| <= rtol x (|want| + the rms of
    want's row over the last axis) + 2^-12 x the rms of its block of 64
    rows (the token axis of (B, N, heads, D), the first of (N, D)). rtol is
    2^-6 in bf16 (two rounding steps of the element: p and ds are rounded
    alike in both, the f32 sums taken in another order are rounded once,
    and now and then a ds lands one step apart; plus two steps of the
    row's typical entry, for an entry that cancels) or 1e-4 in fp32; the floor holds a row that cancels whole to f32 noise
    (a causal first query row: p = 1 on its one key, so dp = delta but for
    the sums' order). With `want32`, the plain version in fp32 on the same
    inputs, also the relative L2 rule: got at most 1.2 x want's distance
    from it."""
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    w = want if want.dim() == 4 else want.reshape(1, want.shape[0], 1, -1)
    ms = w.pow(2).mean(-1)  # (B, N, H)
    block = torch.arange(ms.shape[1], device=want.device) // 64
    sums = torch.zeros((ms.shape[0], int(block[-1]) + 1, ms.shape[2]),
                       device=want.device).index_add_(1, block, ms)
    local = (sums / torch.bincount(block)[None, :, None])[:, block]
    limit = (rtol * (w.abs() + ms.sqrt()[..., None])
             + 2.0 ** -12 * local.sqrt()[..., None]).reshape(want.shape)
    diff = (got - want).abs()
    assert bool((diff <= limit).all()), (name, float(diff.max()),
                                        float((diff / limit.clamp(min=1e-30)).max()))
    if want32 is not None:
        d_got = float((got - want32).norm() / want32.norm())
        d_want = float((want - want32).norm() / want32.norm())
        assert d_got <= 1.2 * d_want, (name, d_got, d_want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES), ids=list(FLASH_BWD_CASES))
def test_flash_attention_bwd_kernel(cuda, case, dtype):
    """B3b (the dq and dk/dv kernels) against `flash_attention_bwd_ref` on
    the forward's own output and logsumexp; dO is zero on rows with no
    valid key, as a loss leaves them, and both give those rows dq = 0."""
    B, T, S, H, K, D, causal, q_offset, mask_kind = FLASH_BWD_CASES[case]
    q, k, v, mask = flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed=len(case))
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    out, lse = flash_attention(q, k, v, key_mask=t_mask, causal=causal, q_offset=q_offset)
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    do = torch.where((lse > -1e29).transpose(1, 2)[..., None], do, 0.0).to(dtype)
    before = flash_attention_bwd.LAUNCHES
    got = flash_attention_bwd(q, k, v, out, lse, do, key_mask=t_mask, causal=causal,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_bwd.LAUNCHES == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, key_mask=t_mask, causal=causal,
                                   q_offset=q_offset)
    want32 = [None] * 3
    if dtype == torch.bfloat16:
        want32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse, do.float(),
                                         key_mask=t_mask, causal=causal, q_offset=q_offset)
    for name, g, w, w32, x in zip(("dq", "dk", "dv"), got, want, want32, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert_grad_close(g, w, dtype, name, w32)
    dead = (lse <= -1e29).transpose(1, 2)  # (B, T, H)
    assert not bool(got[0][dead].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [16, 200])
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_transpose_kernel(cuda, shape, layout, m, dtype):
    """B7b (tiled) and B7a (flat) against their plain versions: dy @
    dequant(W)^T with dy and the weights rounded to bf16 in both; the two
    layouts give the same bits on the same weight."""
    din, dout = INT4_SHAPES[shape]
    w4t, gst = int4_weights(din, dout, 2, cuda, seed=m + 7)
    w4, gs = untile_int4_stacked(w4t, gst)
    gen = torch.Generator(device=cuda).manual_seed(m)
    dy = torch.randn((m, dout), generator=gen, device=cuda).to(dtype)
    fn, ref, w, s = ((int4_matmul_T_tiled, int4_matmul_T_tiled_ref, w4t, gst)
                     if layout == "tiled" else (int4_matmul_T_flat, int4_matmul_T_flat_ref, w4, gs))
    before = fn.LAUNCHES
    got = fn(dy, w, s, 1)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (m, din)
    assert_int4_close(got, ref(dy, w, s, 1), dtype)
    other = int4_matmul_T_flat(dy, w4, gs, 1) if layout == "tiled" else int4_matmul_T_tiled(
        dy, w4t, gst, 1)
    assert torch.equal(got, other)


def _grad_cases(device):
    """wrapper name -> (kernel call, plain call, inputs that require grad):
    every wrapper of the port's kernels at a small shape."""
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    w4t, gst = int4_weights(128, 256, 2, device, seed=1)
    w4, gs = untile_int4_stacked(w4t, gst)
    w8, sc = quantize_stacked_int8(0.02 * rnd(1, 128, 256))
    q, k, v = rnd(2, 40, 4, 64), rnd(2, 40, 4, 64), rnd(2, 40, 4, 64)
    ck, cv = rnd(2, 2, 64, 4, 64), rnd(2, 2, 64, 4, 64)
    x16, x200 = rnd(16, 128), rnd(200, 128)
    q1 = q[:, :1].contiguous()
    k8, v8, ks, vs = quantize_cache(ck, cv)
    a8, b8 = 0.02 * rnd(128, 8), 0.1 * rnd(8, 256)
    wg, wu, wd = mlp_weights(256, 512, device, seed=2)
    nrm = torch.ones((2, 256), device=device)
    return {
        "vit_attention": (lambda a, b, c: vit_attention(a, b, c),
                          lambda a, b, c: vit_attention_ref(a, b, c), (q, k, v)),
        "flash_attention": (lambda a, b, c: flash_attention(a, b, c)[0],
                            lambda a, b, c: attention_xla(a, b, c), (q, k, v)),
        # the plain routes: the dispatchers' `plain`, B7's plain version as
        # the backward
        "int4_gemv_tiled": (lambda a: int4_gemv_tiled(a, w4t, gst, 1),
                            lambda a: int4_matmul_stacked(a, w4t, gst, 1, plain=True), (x16,)),
        "int4_gemv_flat": (lambda a: int4_gemv_flat(a, w4, gs, 1),
                           lambda a: int4_matmul_stacked(a, w4, gs, 1, plain=True), (x16,)),
        "int4_matmul": (lambda a: int4_matmul(a, w4[1], gs[1]),
                        lambda a: maybe_int8_matmul(a, {"w4": w4[1], "gscale": gs[1]},
                                                    plain=True), (x16,)),
        "int4_matmul_prefill_tiled": (
            lambda a: int4_matmul_prefill_tiled(a, w4t, gst, 1),
            lambda a: int4_matmul_stacked(a, w4t, gst, 1, plain=True), (x200,)),
        "int4_matmul_prefill": (lambda a: int4_matmul_prefill(a, w4, gs, 1),
                                lambda a: int4_matmul_stacked(a, w4, gs, 1, plain=True),
                                (x200,)),
        "int8_matmul": (lambda a: int8_matmul(a, w8[0], sc[0]),
                        lambda a: int8_matmul_ref(a, w8[0], sc[0]), (x16,)),
        # the fused QLoRA fronts: B10a forward, B10b backward (the plain
        # route: the plain versions of both)
        "int8_matmul_stacked": (lambda a: int8_matmul_stacked(a, w8, sc, 0),
                                lambda a: int8_matmul_stacked(a, w8, sc, 0, plain=True), (x200,)),
        "int8_lora_matmul_stacked": (
            lambda x, a, b: int8_lora_matmul_stacked(x, w8, sc, a, b, 2.0, 0),
            lambda x, a, b: int8_lora_matmul_stacked(x, w8, sc, a, b, 2.0, 0, plain=True),
            (x200, a8, b8)),
        # no backward: decoding and cache ops, and the backward kernels
        "decode_attention_stacked": (
            lambda a: decode_attention_stacked(a, ck, cv, 1, 30), None, (q1,)),
        "decode_attention_stacked_q": (
            lambda a: decode_attention_stacked_q(a, k8, v8, ks, vs, 1, 30), None, (q1,)),
        "decode_attention": (lambda a: decode_attention(a, ck[1], cv[1], 30), None,
                             (q1,)),
        "gather_cache_blocks": (
            lambda a: gather_cache_blocks(a, np.tile(np.arange(2), (2, 1)), block_k=32),
            None, (ck.clone(),)),
        "flash_attention_bwd": (
            lambda a: flash_attention_bwd(a, k, v, q, torch.zeros((2, 4, 40), device=device),
                                          q), None, (q,)),
        "int4_matmul_T_tiled": (lambda a: int4_matmul_T_tiled(a, w4t, gst, 1), None,
                                (rnd(16, 256),)),
        "int4_matmul_T_flat": (lambda a: int4_matmul_T_flat(a, w4, gs, 1), None,
                               (rnd(16, 256),)),
        "int8_stacked_fwd": (lambda a: int8_stacked_fwd(a.to(torch.bfloat16), w8, sc, 0), None,
                             (x16,)),
        "int8_stacked_bwd": (lambda a: int8_stacked_bwd(a.to(torch.bfloat16), w8, sc, 0), None,
                             (rnd(16, 256),)),
        "fused_mlp_stacked": (lambda a: fused_mlp_stacked(a, nrm, wg, wu, wd, 1), None,
                              (rnd(2, 256),)),
    }


GRAD_WRAPPERS = ("vit_attention", "flash_attention", "int4_gemv_tiled", "int4_gemv_flat",
                 "int4_matmul", "int4_matmul_prefill_tiled", "int4_matmul_prefill",
                 "int8_matmul", "decode_attention_stacked", "decode_attention_stacked_q",
                 "decode_attention", "gather_cache_blocks", "flash_attention_bwd",
                 "int4_matmul_T_tiled", "int4_matmul_T_flat", "int8_matmul_stacked",
                 "int8_lora_matmul_stacked", "int8_stacked_fwd", "int8_stacked_bwd",
                 "fused_mlp_stacked")
# wrappers whose gradient is rounded to bf16 by the contract (B10b's dx):
# held by the int4 / int8 rule in bf16, not the f32 gradient rule
BF16_GRADS = ("int8_matmul_stacked", "int8_lora_matmul_stacked")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAD_WRAPPERS)
def test_kernel_wrapper_carries_or_refuses_grad(cuda, name):
    """Every kernel wrapper, on a CUDA input that requires grad: either its
    output carries the plain version's gradient (an autograd Function whose
    backward is a kernel or plain torch), or it raises, naming the missing
    backward; none returns a graph-less output."""
    kernel, plain, inputs = _grad_cases(cuda)[name]
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    if plain is None:
        with pytest.raises(RuntimeError, match="has no backward"):
            kernel(*leaves)
        with torch.no_grad():
            kernel(*[x.detach() for x in inputs])
        return
    out = kernel(*leaves)
    assert out.grad_fn is not None
    dy = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda)
    got = torch.autograd.grad(out, leaves, dy)
    ref_leaves = [x.detach().clone().requires_grad_() for x in inputs]
    want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, dy)
    for g, w in zip(got, want):
        if name in BF16_GRADS:
            assert_int4_close(g, w, torch.bfloat16)
        else:
            assert_grad_close(g, w, torch.float32, name)


SINGLE_CASES = {name: c for name, c in DECODE_CASES.items() if c[6] == 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SINGLE_CASES), ids=list(SINGLE_CASES))
def test_decode_attention_single_kernel(cuda, case, dtype):
    """Kernel B12 over one layer's own cache, the stacked kernel's cases."""
    L, B, S, H, K, D, T, layer, length, mask_kind = SINGLE_CASES[case]
    q, ck, cv, mask = decode_inputs(L, B, S, H, K, D, T, mask_kind, seed=len(case))
    q, ck, cv = (torch.from_numpy(x).to(cuda, dtype) for x in (q, ck, cv))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = decode_attention.LAUNCHES
    got = decode_attention(q, ck[layer], cv[layer], length, key_mask=t_mask)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES == before + 1 and got.shape == q.shape
    want = decode_attention_ref(q, ck[layer], cv[layer], length, key_mask=t_mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    if mask_kind == "dead_row":
        assert not bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 33, 450, 2304, 4096])
def test_decode_attention_single_kernel_7b(cuda, length, dtype):
    gen = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn((1, 32, 128), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((1, 4608, 32, 128), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    got = decode_attention(q, k, v, length)
    want = decode_attention_ref(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["7b_wqkv", "7b_wo", "7b_w_down", "tiny_wqkv"])
def test_int4_gemv_kernel_row_is_the_same_alone_and_in_a_window(cuda, shape, dtype):
    """Row i of a 5-row call is bit-equal to that row alone: the splits of
    the contraction do not depend on the row count, so a verify window's
    rows see what sequential decode steps see."""
    w4t, gst = int4_weights(*INT4_SHAPES[shape], 2, cuda, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((5, INT4_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
    window = int4_gemv_tiled(x, w4t, gst, 1)
    for i in range(5):
        assert torch.equal(int4_gemv_tiled(x[i:i + 1], w4t, gst, 1)[0], window[i])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["kv", "kv8"])
def test_decode_attention_kernel_row_is_the_same_alone_and_in_a_window(cuda, quant):
    """Row tq of a T = 5 window at cache length n is bit-equal to a single
    query at length n - 4 + tq (what a sequential step at that position
    attends), when both list the same blocks."""
    L, B, S, H, K, D, T, n = 2, 1, 1024, 8, 2, 64, 5, 700
    q, ck, cv, _ = decode_inputs(L, B, S, H, K, D, T, None, seed=11)
    q = torch.from_numpy(q).to(cuda, torch.bfloat16)
    if quant:
        cache = [x.to(cuda) for x in quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))]
        attend = decode_attention_stacked_q
    else:
        cache = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (ck, cv)]
        attend = decode_attention_stacked
    window = attend(q, *cache, 1, n)
    for tq in range(T):
        alone = attend(q[:, tq:tq + 1], *cache, 1, n - (T - 1) + tq)
        assert torch.equal(alone[:, 0], window[:, tq])


# (din, dout) of tiny and 7B per-projection matrices, and a ragged one (d not
# a multiple of the 64-row step, n not a multiple of the 64- or 256-column
# tiles)
INT8_SHAPES = {
    "tiny_wq": (64, 64), "tiny_w_gate": (64, 128), "tiny_w_down": (128, 64),
    "7b_wq": (4096, 4096), "7b_w_gate": (4096, 11008), "7b_w_down": (11008, 4096),
    "ragged": (136, 208),
}


def int8_weights(din, dout, layers, device, seed):
    """Random (layers, din, dout) weights quantized as
    models/llama.quantize_llama does: (w8, scale)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return quantize_stacked_int8(0.02 * torch.randn((layers, din, dout), generator=gen,
                                                    device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 5, 8, 24, 25, 127, 391])
@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_int8_matmul_kernel(cuda, shape, m, dtype):
    """B9 on either side of its threshold (INT8_TC_MIN_M = 25: a bf16 x
    takes the tensor cores from there), f32 out and x's dtype out."""
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 2, cuda, seed=m)
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    x = torch.randn((1, m, din), generator=gen, device=cuda).to(dtype)
    before = int8_matmul.LAUNCHES
    got = int8_matmul(x, w8[1], sc[1])
    same_dtype = int8_matmul(x, w8[1], sc[1], dtype)
    torch.cuda.synchronize()
    assert int8_matmul.LAUNCHES == before + 2
    assert got.dtype == torch.float32 and got.shape == (1, m, dout)
    assert same_dtype.dtype == dtype
    assert_int4_close(got, int8_matmul_ref(x, w8[1], sc[1]), torch.float32)
    assert_int4_close(same_dtype, int8_matmul_ref(x, w8[1], sc[1], dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tensor_cores", [False, True], ids=["gemv", "tensor_cores"])
@pytest.mark.parametrize("m", [8, 64, 200])
@pytest.mark.parametrize("shape", ["7b_wq", "tiny_w_down", "ragged"])
def test_int8_matmul_kernel_paths(cuda, shape, m, tensor_cores):
    """Each of B9's two paths, forced, on either side of the dispatch's
    threshold (a bf16 x; an f32 x takes the GEMV at any m)."""
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 1, cuda, seed=m)
    x = torch.randn((m, din), generator=torch.Generator(device=cuda).manual_seed(m),
                    device=cuda).to(torch.bfloat16)
    got = _launch_int8(x, w8[0], sc[0], torch.float32, tensor_cores=tensor_cores)
    assert_int4_close(got, int8_matmul_ref(x, w8[0], sc[0]), torch.float32)
    if tensor_cores:
        with pytest.raises(TypeError, match="bf16"):
            _launch_int8(x.float(), w8[0], sc[0], torch.float32, tensor_cores=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_down", "tiny_wq", "ragged"])
def test_int8_matmul_kernel_row_is_the_same_alone_and_in_a_window(cuda, shape, dtype):
    """Row i of a 5-row B9 call is bit-equal to that row alone: the splits
    of the contraction do not depend on the row count."""
    w8, sc = int8_weights(*INT8_SHAPES[shape], 2, cuda, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((5, INT8_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
    window = int8_matmul(x, w8[0], sc[0], dtype)
    for i in range(5):
        assert torch.equal(int8_matmul(x[i:i + 1], w8[0], sc[0], dtype)[0], window[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_flat_kernels_are_bit_equal_to_tiled(cuda, shape, dtype):
    """B4c and B5a over the flat layout (the tiled one's inverse permute)
    give B4b's and B5b's bits on the same weight, and agree with their
    plain versions."""
    w4t, gst = int4_weights(*INT4_SHAPES[shape], 2, cuda, seed=5)
    w4, gs = untile_int4_stacked(w4t, gst)
    gen = torch.Generator(device=cuda).manual_seed(6)
    for m, flat, tiled, ref in ((1, int4_gemv_flat, int4_gemv_tiled, int4_gemv_flat_ref),
                                (5, int4_gemv_flat, int4_gemv_tiled, int4_gemv_flat_ref),
                                (127, int4_gemv_flat, int4_gemv_tiled, int4_gemv_flat_ref),
                                (128, int4_matmul_prefill, int4_matmul_prefill_tiled,
                                 int4_matmul_prefill_ref),
                                (391, int4_matmul_prefill, int4_matmul_prefill_tiled,
                                 int4_matmul_prefill_ref)):
        x = torch.randn((1, m, INT4_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
        before = flat.LAUNCHES
        got = flat(x, w4, gs, 1)
        torch.cuda.synchronize()
        assert flat.LAUNCHES == before + 1
        assert torch.equal(got, tiled(x, w4t, gst, 1))
        assert_int4_close(got, ref(x, w4, gs, 1), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 5, 391])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_matmul_kernel(cuda, shape, m, dtype):
    """B4a: one flat matrix, the GEMV at any row count."""
    din, dout = INT4_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(m)
    w4, gs = quantize_int4(0.02 * torch.randn((din, dout), generator=gen, device=cuda))
    x = torch.randn((m, din), generator=gen, device=cuda).to(dtype)
    before = int4_matmul.LAUNCHES
    got = int4_matmul(x, w4, gs)
    torch.cuda.synchronize()
    assert int4_matmul.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (m, dout)
    assert_int4_close(got, int4_matmul_ref(x, w4, gs), dtype)


# ---------------------------------------------------------------------------
# B10a / B10b: the fused QLoRA matmuls; B11: the fused decode MLP
# ---------------------------------------------------------------------------


def _qlora_operands(shape, m, r, device, seed, backward):
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 2, device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((m, dout if backward else din), generator=gen, device=device)
    lhs = rhs = None
    if r:
        lhs = 0.1 * torch.randn((m, r), generator=gen, device=device)
        rhs = 0.1 * torch.randn((din, r) if backward else (r, dout), generator=gen,
                                device=device)
    return x.to(torch.bfloat16), w8, sc, lhs, rhs


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 5, 128], ids=["base", "r5", "r128"])
@pytest.mark.parametrize("m", [1, 200])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_gate", "7b_w_down", "ragged"])
def test_qlora_fwd_kernel(cuda, shape, m, r):
    """B10a, with and without the LoRA epilogue (an odd rank and the
    reference's 128), on either side of the 64-row tile, ragged n."""
    x2, w8, sc, u_s, b = _qlora_operands(shape, m, r, cuda, m + r, backward=False)
    before = int8_stacked_fwd.LAUNCHES
    got = int8_stacked_fwd(x2, w8, sc, 1, u_s, b)
    torch.cuda.synchronize()
    assert int8_stacked_fwd.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, w8.shape[2])
    assert_int4_close(got, int8_stacked_fwd_ref(x2, w8, sc, 1, u_s, b), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 5, 128], ids=["base", "r5", "r128"])
@pytest.mark.parametrize("m", [1, 200])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_gate", "7b_w_down", "ragged"])
def test_qlora_bwd_kernel(cuda, shape, m, r):
    """B10b: g @ (bf16(w8) * bf16(s))^T with the v_s @ a^T epilogue."""
    g2, w8, sc, v_s, a = _qlora_operands(shape, m, r, cuda, m + r + 7, backward=True)
    before = int8_stacked_bwd.LAUNCHES
    got = int8_stacked_bwd(g2, w8, sc, 1, v_s, a)
    torch.cuda.synchronize()
    assert int8_stacked_bwd.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, w8.shape[1])
    assert_int4_close(got, int8_stacked_bwd_ref(g2, w8, sc, 1, v_s, a), torch.bfloat16)


# B11's fp32 rows: a share of max|y| alone (see test_fused_mlp_kernel)
B11_FP32_TOL = 3e-4


def mlp_weights(d, f, device, seed, layers=2):
    """A layer stack's MLP weights as the fused decode kernel takes them:
    the int4 decoder's fused gate|up leaf split into gate and up tiles of
    256 columns, and w_down tiled."""
    w4t, gst = int4_weights(d, 2 * f, layers, device, seed=seed)
    wg, wu = split_wgu_tiled({"w4t": w4t, "gst": gst}, f)
    w4t, gst = int4_weights(f, d, layers, device, seed=seed + 1)
    return wg, wu, {"w4t": w4t, "gst": gst}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", ["small", "7b"])
def test_fused_mlp_kernel(cuda, shape, b, dtype):
    """B11 over a layer's MLP half: 1-8 rows (the kernel's row count rounds
    up to 1, 2, 4 or 8), at a small width and at 7B (d 4096, f 11008). Both
    versions round xn and act to bf16 whatever h's dtype, so an f32 row
    differs where an act element's f32 sum, taken in another order, lands
    on the other side of a rounding boundary: a bf16 step of that element
    times its down weights (at 7B, B = 8: 1.1e-4 x max|y| on an H100). The
    fp32 gate, B11_FP32_TOL x max|y| and no per-element term, fails a kernel
    that rounds the residual h to bf16 (2^-9 x |h|)."""
    d, f = {"small": (256, 512), "7b": (4096, 11008)}[shape]
    wg, wu, wd = mlp_weights(d, f, cuda, seed=b)
    gen = torch.Generator(device=cuda).manual_seed(b + 1)
    h = torch.randn((b, d), generator=gen, device=cuda).to(dtype)
    nrm = (1.0 + 0.1 * torch.randn((2, d), generator=gen, device=cuda)).to(torch.bfloat16)
    before = fused_mlp_stacked.LAUNCHES
    got = fused_mlp_stacked(h, nrm, wg, wu, wd, 1)
    torch.cuda.synchronize()
    assert fused_mlp_stacked.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    want = fused_mlp_stacked_ref(h, nrm, wg, wu, wd, 1)
    if dtype == torch.bfloat16:
        assert_int4_close(got, want, torch.bfloat16)
    else:
        err = float((got - want).abs().max())
        assert bool(torch.isfinite(got).all())
        assert err <= B11_FP32_TOL * float(want.abs().max()), err
