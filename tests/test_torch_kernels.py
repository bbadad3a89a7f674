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
rows take the int4 rule, fp32 rows 3e-4 x max|y| with no per-element term;
each of its two kernels alone: act by the int4 rule in bf16, the down
kernel over that act by the int4 rule in the rows' dtype.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from handsonvlm_torch.models.llama import _quantize_kv_rows
from handsonvlm_torch.ops.cache_ops import gather_cache_blocks, gather_cache_blocks_ref
from handsonvlm_torch.ops.decode_attention import (
    HEAD_SIZES,
    decode_attention,
    decode_attention_ref,
    decode_attention_stacked,
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
    decode_attention_stacked_ref,
    max_splits,
)
from handsonvlm_torch.ops.attention import attention_xla
from handsonvlm_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from handsonvlm_torch.ops.int8_matmul import (
    ROW_TILES,
    _launch_int8,
    _transpose_geometry,
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
    int8_tc_plan,
    maybe_int8_matmul,
    prefill_split,
    quantize_int4,
    quantize_stacked_int8,
    tile_int4_stacked,
    tiled_shapes,
    transpose_plan,
    untile_int4_stacked,
)
from handsonvlm_torch.ops import fused_decode
from handsonvlm_torch.ops.fused_decode import (
    fused_mlp_part,
    fused_mlp_stacked,
    fused_mlp_stacked_ref,
    split_wgu_tiled,
)
from handsonvlm_torch.ops.qlora_fused import (
    ADAPTER_STAGE,
    int8_lora_matmul_stacked,
    int8_matmul_stacked,
    int8_stacked_bwd,
    int8_stacked_bwd_ref,
    int8_stacked_fwd,
    int8_stacked_fwd_ref,
    qlora_bwd_plan,
    qlora_geometry,
)
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref
from handsonvlm_torch.parallel.tp import shard_int4_stacked

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
@pytest.mark.parametrize("heads", [2, 16])
@pytest.mark.parametrize("t", [1, 17, 50, 64, 65, 257])
def test_vit_attention_kernel_tile_edges(cuda, t, heads, dtype):
    """B2 where its tiles are ragged: one key, a tail of keys past a 16- or
    64-key chunk, query slices past T, and the main path's 10 frames."""
    shape = (10 if t == 257 else 3, t, heads, 64)
    gen = torch.Generator(device=cuda).manual_seed(t + heads)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    before = vit_attention.LAUNCHES
    got = vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert vit_attention.LAUNCHES == before + 1
    assert got.shape == shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), vit_attention_ref(q, k, v).float(),
                               **CUDA_TOL[dtype])


@pytest.mark.cuda
def test_vit_attention_kernel_refuses_bf16_past_resident_keys(cuda):
    """The bf16 kernel holds every key of a (frame, head) in shared memory:
    past 832 tokens the wrapper refuses; f32 streams its keys at any T."""
    q = torch.zeros((1, 833, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="832"):
        vit_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert vit_attention(q, q, q).shape == q.shape


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
@pytest.mark.parametrize("m", [128, 129, 200, 391, 2048])
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


# 7B's fused projections cut for tensor parallelism (parallel/tp.py): each
# rank's column shard at tp = 2 and 4; the tiled wgu (43 tiles) stays whole
TP_SHARDS = [(shape, tp) for shape in ("7b_wqkv", "7b_wo", "7b_wgu", "7b_w_down")
             for tp in (2, 4)]
TP_INT4 = {("tiled", 1): (int4_gemv_tiled, int4_gemv_tiled_ref),
           ("flat", 1): (int4_gemv_flat, int4_gemv_flat_ref),
           ("tiled", 391): (int4_matmul_prefill_tiled, int4_matmul_prefill_tiled_ref),
           ("flat", 391): (int4_matmul_prefill, int4_matmul_prefill_ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 391])
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("shape, tp", TP_SHARDS)
def test_int4_kernels_on_tp_column_shards(cuda, shape, tp, layout, m):
    """B4b / B4c (decode row) and B5b / B5a (a 391-row prefill) on each
    rank's column shard of a 7B projection: each shard against its plain
    version, the shards' outputs concatenated against the unsharded
    kernel's, by the int4 rule; the tiled wgu is not cut."""
    din, dout = INT4_SHAPES[shape]
    w4t, gst = int4_weights(din, dout, 1, cuda, seed=tp)
    w, s = (w4t, gst) if layout == "tiled" else untile_int4_stacked(w4t, gst)
    parts = [shard_int4_stacked(w, s, r, tp) for r in range(tp)]
    if (layout, shape) == ("tiled", "7b_wgu"):
        assert parts[0] is None
        return
    fn, ref = TP_INT4[(layout, m)]
    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((1, m, din), generator=gen, device=cuda).to(torch.bfloat16)
    outs = []
    for part in parts:
        assert part[0].shape[-1 if layout == "flat" else 1] * tp == w.shape[-1 if layout ==
                                                                            "flat" else 1]
        got = fn(x, *part, 0)
        assert_int4_close(got, ref(x, *part, 0), torch.bfloat16)
        outs.append(got)
    assert_int4_close(torch.cat(outs, dim=-1), fn(x, w, s, 0), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t", [1, 5])
def test_decode_attention_kernels_on_tp_head_shards(cuda, t, quant):
    """B1 (bf16 cache) and B6 (int8 cache) on each of 4 ranks' 8 of 32
    heads at 7B's head size: each shard against its plain version, the
    shards' outputs concatenated over the heads against the unsharded
    kernel's."""
    L, B, S, H, K, D, tp = 2, 1, 520, 32, 32, 128, 4
    q, ck, cv, _ = decode_inputs(L, B, S, H, K, D, t, None, seed=t)
    q = torch.from_numpy(q).to(cuda, torch.bfloat16)
    ck, cv = torch.from_numpy(ck).to(cuda), torch.from_numpy(cv).to(cuda)
    if quant:
        cache = quantize_cache(ck, cv)
        fn, ref = decode_attention_stacked_q, decode_attention_stacked_q_ref
        axes = (3, 3, 2, 2)
    else:
        cache = (ck.to(torch.bfloat16), cv.to(torch.bfloat16))
        fn, ref = decode_attention_stacked, decode_attention_stacked_ref
        axes = (3, 3)
    n = H // tp
    outs = []
    for r in range(tp):
        part = [c.narrow(a, r * n, n).contiguous() for c, a in zip(cache, axes)]
        ql = q[:, :, r * n:(r + 1) * n].contiguous()
        got = fn(ql, *part, 1, 450)
        torch.testing.assert_close(got.float(), ref(ql, *part, 1, 450).float(),
                                   **CUDA_TOL[torch.bfloat16])
        outs.append(got)
    torch.testing.assert_close(torch.cat(outs, dim=2).float(), fn(q, *cache, 1, 450).float(),
                               **CUDA_TOL[torch.bfloat16])


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
    pad ("left_pad"), a right pad ("right_pad"), an interior hole ("hole")
    or a wider one ("wide_hole")."""
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
        elif mask_kind == "wide_hole":  # whole 64-key tiles and a 128-key block
            mask[:, 40:300] = False
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
@pytest.mark.parametrize("m", [1, 16, 200, 2048])
@pytest.mark.parametrize("layout", ["tiled", "flat"])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_transpose_kernel(cuda, shape, layout, m, dtype):
    """B7b (tiled) and B7a (flat) against their plain versions: dy @
    dequant(W)^T with dy and the weights rounded to bf16 in both; the two
    layouts give the same bits on the same weight, and a second call the
    same bits as the first (row tiles 16 / 104 / 128, split-K at small m)."""
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
    assert torch.equal(got, fn(dy, w, s, 1))


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
@pytest.mark.parametrize("m", [1, 5, 8, 9, 24, 25, 103, 104, 105, 127, 128, 129, 391, 2048])
@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_int8_matmul_kernel(cuda, shape, m, dtype):
    """B9 on either side of its threshold (INT8_TC_MIN_M = 9: a bf16 x
    takes the tensor cores from there) and at the edges of the tensor
    cores' row tiles (104, 128), f32 out and x's dtype out."""
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
@pytest.mark.parametrize("m", [25, 103, 104, 105, 128, 129, 391, 2048])
@pytest.mark.parametrize("shape", ["ragged", "7b_w_gate", "7b_w_down"])
def test_int8_matmul_tensor_cores_tile_edges(cuda, shape, m):
    """B9's tensor cores at the edges of their row tiles and split plans
    (ragged: d = 136 ends in a half k16 step, n = 208 in a part of a
    256-column block; 7b_w_gate: n = 11008 = 43 x 256; 7b_w_down: d = 11008
    split over the contraction), f32 and bf16 out, and the same bits from a
    second call."""
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 1, cuda, seed=m + 2)
    x = torch.randn((m, din), generator=torch.Generator(device=cuda).manual_seed(m),
                    device=cuda).to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = _launch_int8(x, w8[0], sc[0], out_dtype, tensor_cores=True)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, dout)
        assert_int4_close(got, int8_matmul_ref(x, w8[0], sc[0], out_dtype), out_dtype)
        assert torch.equal(got, _launch_int8(x, w8[0], sc[0], out_dtype, tensor_cores=True))


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


# the GEMV's tile edges (csrc/gemv.cuh: 128-column blocks, 8-row tiles,
# splits of the contraction merged in a cluster): int4 (din, dout) with BN =
# 208 (a 128-column block and a part of one), 7B w_down (86 groups in four
# splits, the last of 20), tiny w_down (n = BN = 64, half a block); int8
# ragged (d = 136: a 64-row stage and a part of one; n = 208), (1000, 400)
# (d not a multiple of a split, n = 3 x 128 + 16), 7B w_down (172 stages)
GEMV_EDGES = {
    "int4_bn208": ("int4", 384, 208), "int4_7b_w_down": ("int4", 11008, 4096),
    "int4_tiny_w_down": ("int4", 128, 64), "int4_tiny_wqkv": ("int4", 64, 192),
    "int8_ragged": ("int8", 136, 208), "int8_1000x400": ("int8", 1000, 400),
    "int8_7b_w_down": ("int8", 11008, 4096), "int8_tiny_wq": ("int8", 64, 64),
}
GEMV_KINDS = ("int4_tiled", "int4_flat", "int4_matmul", "int8")


def _gemv_call(kind, din, dout, device, seed):
    """(fn(x), plain(x)) of one GEMV entry point over a random weight of
    (din, dout): B4b, B4c, B4a or B9's GEMV route at any m (x's dtype out)."""
    if kind == "int8":
        w8, sc = int8_weights(din, dout, 1, device, seed)
        return (lambda x: _launch_int8(x, w8[0], sc[0], x.dtype, tensor_cores=False),
                lambda x: int8_matmul_ref(x, w8[0], sc[0], x.dtype))
    w4t, gst = int4_weights(din, dout, 2, device, seed)
    w4, gs = untile_int4_stacked(w4t, gst)
    return {"int4_tiled": (lambda x: int4_gemv_tiled(x, w4t, gst, 1),
                           lambda x: int4_gemv_tiled_ref(x, w4t, gst, 1)),
            "int4_flat": (lambda x: int4_gemv_flat(x, w4, gs, 1),
                          lambda x: int4_gemv_flat_ref(x, w4, gs, 1)),
            "int4_matmul": (lambda x: int4_matmul(x, w4[1], gs[1]),
                            lambda x: int4_matmul_ref(x, w4[1], gs[1]))}[kind]


def _gemv_edge_calls(case, device, seed):
    """The GEMV entry points of an edge case's kind, each as (name, fn, plain)."""
    kind, din, dout = GEMV_EDGES[case]
    kinds = ("int8",) if kind == "int8" else GEMV_KINDS[:3]
    return din, [(k, *_gemv_call(k, din, dout, device, seed)) for k in kinds]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(GEMV_EDGES))
def test_gemv_kernel_row_is_the_same_alone_and_in_any_window(cuda, case, dtype):
    """Row i of an m-row GEMV call (m = 2, 5, 8 in one row tile, 9 in two)
    is bit-equal to the same row alone, for B4b, B4c, B4a and B9 at the
    tile edges: the splits, the stage order and the merge order do not
    depend on m, and a row's products never mix with another row's."""
    din, calls = _gemv_edge_calls(case, cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((9, din), generator=gen, device=cuda).to(dtype)
    for name, fn, plain in calls:
        alone = [fn(x[i:i + 1])[0] for i in range(9)]
        for m in (2, 5, 8, 9):
            window = fn(x[:m])
            assert_int4_close(window, plain(x[:m]), dtype)
            for i in range(m):
                assert torch.equal(alone[i], window[i]), (name, m, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 17])
@pytest.mark.parametrize("case", list(GEMV_EDGES))
def test_gemv_kernel_tile_edges_and_same_bits_twice(cuda, case, m, dtype):
    """The GEMV at its tile edges (a part of a 128-column block, a part of
    a 64-row B9 stage, a short last split, more than one row tile) against
    the plain version, and two calls give the same bits."""
    din, calls = _gemv_edge_calls(case, cuda, seed=m)
    x = torch.randn((1, m, din), generator=torch.Generator(device=cuda).manual_seed(m + 9),
                    device=cuda).to(dtype)
    for name, fn, plain in calls:
        got = fn(x)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape[:2] == (1, m), name
        assert_int4_close(got, plain(x), dtype)
        assert torch.equal(got, fn(x)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 5, 9])
@pytest.mark.parametrize("kind", GEMV_KINDS)
def test_gemv_kernel_is_one_launch(cuda, kind, m, dtype):
    """A GEMV call launches one kernel, the GEMV body (its splits merge in
    the launch), and counts one launch."""
    fn, _ = _gemv_call(kind, 4096, 4096, cuda, seed=3)
    x = torch.randn((m, 4096), generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(dtype)
    wrapper = {"int4_tiled": int4_gemv_tiled, "int4_flat": int4_gemv_flat,
               "int4_matmul": int4_matmul, "int8": int8_matmul}[kind]
    fn(x)  # the build and the first launch's set-up are not the call's
    before = wrapper.LAUNCHES
    _, names = _launched_kernels(lambda: fn(x))
    assert wrapper.LAUNCHES == before + 1
    assert len(names) == 1 and "gemv_kernel" in next(iter(names)), names


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
@pytest.mark.parametrize("m", [128, 129, 200, 391, 2048])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_int4_prefill_flat_is_bit_equal_to_tiled(cuda, shape, m, dtype):
    """B5a gives B5b's bits on the same weight at every split count and
    tile width (64, 128 or 256 columns)."""
    w4t, gst = int4_weights(*INT4_SHAPES[shape], 2, cuda, seed=m + 3)
    w4, gs = untile_int4_stacked(w4t, gst)
    gen = torch.Generator(device=cuda).manual_seed(m + 4)
    x = torch.randn((m, INT4_SHAPES[shape][0]), generator=gen, device=cuda).to(dtype)
    before = int4_matmul_prefill.LAUNCHES
    got = int4_matmul_prefill(x, w4, gs, 0)
    torch.cuda.synchronize()
    assert int4_matmul_prefill.LAUNCHES == before + 1
    assert torch.equal(got, int4_matmul_prefill_tiled(x, w4t, gst, 0))
    assert_int4_close(got, int4_matmul_prefill_ref(x, w4, gs, 0), dtype)


@pytest.mark.parametrize("n", [64, 192, 4096, 12288, 22016])
@pytest.mark.parametrize("groups", [1, 32, 86])
@pytest.mark.parametrize("m", [128, 129, 200, 391, 2048, 2379])
def test_prefill_split_covers_the_groups(m, groups, n):
    """The prefill matmul's split-K plan (CPU): every group in exactly one
    split, at most eight splits of at least four groups, and a split only
    where it fills the card's block slots better than one pass."""
    splits, per = prefill_split(m, n, groups, 132)
    assert 1 <= splits <= 8 and (splits - 1) * per < groups <= splits * per
    assert splits == 1 or per >= 4
    blocks = -(-m // 128) * -(-n // 256)
    use = [b / (-(-b // 132) * 132) for b in (blocks, blocks * splits)]
    assert splits == 1 or use[1] > use[0] + 0.1 * (splits - 1)


@pytest.mark.parametrize("case", [
    # (plan, m, d, n, row tile, splits): the fastest of the plans timed at
    # the 7B projections on an H100 (PERF.md, section 6)
    ("int8", 391, 4096, 4096, 104, 2), ("int8", 391, 4096, 11008, 104, 1),
    ("int8", 391, 11008, 4096, 104, 2), ("int8", 2048, 4096, 4096, 128, 1),
    ("int8", 2048, 11008, 4096, 128, 1), ("int8", 2379, 4096, 4096, 104, 1),
    ("int8", 2379, 11008, 4096, 104, 1), ("transpose", 2048, 4096, 12288, 128, 1),
    ("transpose", 2048, 4096, 22016, 128, 1), ("transpose", 16, 4096, 4096, 16, 8),
], ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else None)
def test_wgmma_plan_takes_the_fastest_timed_plan(case):
    """The time model of B7's and B9's plans (CPU) picks, at the 7B
    projections, the row tile and split count that ran fastest on the card."""
    kind, m, d, n, rows, splits = case
    plan = int8_tc_plan(m, d, n, 132) if kind == "int8" else transpose_plan(m, n, d, 132)
    assert plan[:2] == (rows, splits)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("d", [64, 128, 4096, 11008])
@pytest.mark.parametrize("n", [64, 192, 4096, 12288, 22016])
@pytest.mark.parametrize("m", [1, 16, 200, 2048])
def test_transpose_plan_covers_the_contraction(m, n, d, n_sm):
    """B7's split-K plan (CPU): the splits take the 64-column stages of n
    once each, in order (split s the stages [s * per, (s + 1) * per)), at
    most sixteen of at least four stages."""
    rows, splits, per = transpose_plan(m, n, d, n_sm)
    stages = n // 64
    assert rows in ROW_TILES
    assert 1 <= splits <= 16 and (splits - 1) * per < stages <= splits * per
    assert splits == 1 or per >= 4
    covered = [k for s in range(splits) for k in range(s * per, min(stages, (s + 1) * per))]
    assert covered == list(range(stages))


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("n", [64, 208, 4096, 11008])
@pytest.mark.parametrize("d", [64, 136, 4096, 11008])
@pytest.mark.parametrize("m", [25, 104, 129, 391, 2048, 2379])
def test_int8_tc_plan_covers_the_contraction(m, d, n, n_sm):
    """B9's tensor-core split-K plan (CPU): splits of whole 64-row stages of
    d (the last may end past d, where TMA reads zeros) that cover d once,
    in order, at most sixteen of at least four stages each."""
    rows, splits, per = int8_tc_plan(m, d, n, n_sm)
    assert rows in ROW_TILES and per % 64 == 0
    assert 1 <= splits <= 16 and (splits - 1) * per < d <= splits * per
    assert splits == 1 or per >= 4 * 64


@pytest.mark.parametrize("m", [1, 16, 2048])
@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_transpose_plan_is_the_same_for_both_layouts(shape, m):
    """B7a and B7b plan alike (CPU): the flat layout's geometry is one tile
    of n columns, and the row tile, splits and stages per split come from
    the shapes alone, so both layouts of one weight take the same sums."""
    din, dout = INT4_SHAPES[shape]
    w4t = torch.zeros(tiled_shapes(din, dout, 2)[0], dtype=torch.int8)
    gst = torch.zeros(tiled_shapes(din, dout, 2)[1], dtype=torch.float32)
    w4, gs = untile_int4_stacked(w4t, gst)
    dy = torch.zeros((1, m, dout))
    tiled = _transpose_geometry(dy, w4t, gst, 1, 132)
    flat = _transpose_geometry(dy, w4, gs, 1, 132)
    assert tiled[0] == flat[0] == m and tiled[2:4] == flat[2:4]
    assert tiled[1] * tiled[4] == flat[1] * flat[4] == dout and flat[1] == 1
    assert tiled[5] == flat[5] == transpose_plan(m, dout, din, 132)


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


# B10a / B10b's row counts: one row, the split-K plan (16), the edges of the
# 104-row tile, a mid count and the largest tile (128 rows at 2048)
QLORA_ROWS = [1, 16, 104, 105, 200, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 5, 128], ids=["base", "r5", "r128"])
@pytest.mark.parametrize("m", QLORA_ROWS)
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_gate", "7b_w_down", "ragged"])
def test_qlora_fwd_kernel(cuda, shape, m, r):
    """B10a, with and without the LoRA term (an odd rank and the
    reference's 128), at the row tiles' edges and under split-K, ragged d
    and n."""
    x2, w8, sc, u_s, b = _qlora_operands(shape, m, r, cuda, m + r, backward=False)
    before = int8_stacked_fwd.LAUNCHES
    got = int8_stacked_fwd(x2, w8, sc, 1, u_s, b)
    torch.cuda.synchronize()
    assert int8_stacked_fwd.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, w8.shape[2])
    assert_int4_close(got, int8_stacked_fwd_ref(x2, w8, sc, 1, u_s, b), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 5, 128], ids=["base", "r5", "r128"])
@pytest.mark.parametrize("m", QLORA_ROWS)
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_gate", "7b_w_down", "ragged"])
def test_qlora_bwd_kernel(cuda, shape, m, r):
    """B10b: g @ (bf16(w8) * bf16(s))^T with the v_s @ a^T term, at the same
    row counts as B10a."""
    g2, w8, sc, v_s, a = _qlora_operands(shape, m, r, cuda, m + r + 7, backward=True)
    before = int8_stacked_bwd.LAUNCHES
    got = int8_stacked_bwd(g2, w8, sc, 1, v_s, a)
    torch.cuda.synchronize()
    assert int8_stacked_bwd.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, w8.shape[1])
    assert_int4_close(got, int8_stacked_bwd_ref(g2, w8, sc, 1, v_s, a), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True], ids=["B10a", "B10b"])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_down"])
def test_qlora_kernel_term_enters_once_under_split_k(cuda, shape, backward):
    """At 16 rows both kernels split the contraction and give the LoRA term
    a split of its own: the result agrees with the plain version (the term
    counted once: twice, or not at all, moves every element by the term's
    size, 0.1 x 0.1 x sqrt(r) ~ 0.1 against outputs ~ 1), and a second call
    on the same inputs gives the same bits (the merge adds the splits in a
    fixed order)."""
    m, r = 16, 128
    din, dout = INT8_SHAPES[shape]
    assert qlora_geometry(m, din, dout, r, _num_sms_of(cuda), backward)[2] > 1
    x2, w8, sc, lhs, rhs = _qlora_operands(shape, m, r, cuda, 11, backward=backward)
    fn, ref = ((int8_stacked_bwd, int8_stacked_bwd_ref) if backward
               else (int8_stacked_fwd, int8_stacked_fwd_ref))
    got = fn(x2, w8, sc, 0, lhs, rhs)
    torch.cuda.synchronize()
    want = ref(x2, w8, sc, 0, lhs, rhs)
    assert_int4_close(got, want, torch.bfloat16)
    term = (want.float() - ref(x2, w8, sc, 0).float()).abs().mean()
    assert float(term) > 1e-2  # the term is large enough to show a miscount
    assert torch.equal(got, fn(x2, w8, sc, 0, lhs, rhs))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B10a", "B10b", "B9", "B7b", "B3b"])
def test_tma_kernel_runs_first_in_a_fresh_thread(cuda, kernel):
    """A kernel fed by TMA builds its tensor maps with cuTensorMapEncodeTiled,
    which needs the device's context current on the calling thread: called
    as the first CUDA work of a new thread (as autograd's backward thread
    runs B10b first in a step of the fused QLoRA route, and B3b in a bf16
    LoRA step's attention), it still launches and agrees with its plain
    version."""
    import threading

    if kernel == "B3b":
        B, T, S, H, K, D, _, q_offset, _ = FLASH_BWD_CASES["gqa_d64"]
        q, k, v, _ = flash_inputs(B, T, S, H, K, D, q_offset, None, seed=24)
        q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v))
        out, lse = flash_attention(q, k, v)
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(25),
                         device=cuda).to(torch.bfloat16)
        args = (q, k, v, out, lse, do)
        fn, ref = flash_attention_bwd, flash_attention_bwd_ref
    din, dout = INT8_SHAPES["7b_wq"]
    w8, sc = int8_weights(din, dout, 2, cuda, seed=21)
    w4t, gst = int4_weights(din, dout, 2, cuda, seed=22)
    x = torch.randn((16, din), generator=torch.Generator(device=cuda).manual_seed(23),
                    device=cuda).to(torch.bfloat16)
    calls = {"B10a": (int8_stacked_fwd, int8_stacked_fwd_ref, (x, w8, sc, 1)),
             "B10b": (int8_stacked_bwd, int8_stacked_bwd_ref, (x, w8, sc, 1)),
             "B9": (int8_matmul, int8_matmul_ref, (x, w8[1], sc[1])),
             "B7b": (int4_matmul_T_tiled, int4_matmul_T_tiled_ref, (x, w4t, gst, 1))}
    if kernel != "B3b":
        fn, ref, args = calls[kernel]
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = fn(*args)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - handed to the test's thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    if kernel == "B3b":
        for name, g, w in zip(("dq", "dk", "dv"), got["out"], ref(*args)):
            assert_grad_close(g, w, torch.bfloat16, name)
        return
    assert_int4_close(got["out"], ref(*args), torch.float32 if kernel == "B9" else torch.bfloat16)


def _num_sms_of(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("backward", [False, True], ids=["B10a", "B10b"])
@pytest.mark.parametrize("r", [0, 5, 128])
@pytest.mark.parametrize("n", [64, 208, 4096, 11008])
@pytest.mark.parametrize("d", [136, 4096, 11008])
@pytest.mark.parametrize("m", [1, 16, 104, 2048])
def test_qlora_geometry_covers_the_contraction(m, d, n, r, backward):
    """B10a / B10b's launch geometry (CPU): B9's plan forward and B7's over
    int8 rows backward (splits of whole 64-deep stages that cover the
    contraction once, in order, at most sixteen of at least four stages),
    the rank padded to whole adapter stages, and under split-K one more f32
    partial for the term when there is one."""
    (rows, splits, per), rp, parts = qlora_geometry(m, d, n, r, 132, backward)
    assert rows in ROW_TILES
    stages = -(-(n if backward else d) // 64)
    per_stages = per if backward else per // 64
    assert backward or per % 64 == 0
    assert 1 <= splits <= 16 and (splits - 1) * per_stages < stages <= splits * per_stages
    assert splits == 1 or per_stages >= 4
    assert rp % ADAPTER_STAGE == 0 and r <= rp < r + ADAPTER_STAGE
    assert parts == (0 if splits == 1 else splits + (r > 0))
    if not backward:
        assert (rows, splits, per) == int8_tc_plan(m, d, n, 132)


@pytest.mark.parametrize("case", [
    # (m, d, n, row tile, splits): the plan's picks at the 7B projections
    (2048, 4096, 4096, 128, 1), (2048, 4096, 11008, 128, 1), (2048, 11008, 4096, 128, 1),
    (16, 4096, 4096, 16, 8), (16, 11008, 4096, 16, 3),
], ids=lambda c: "-".join(map(str, c)))
def test_qlora_bwd_plan_at_the_7b_projections(case):
    """B10b's plan (CPU) at the training shape takes B7's 128-row tile in one
    pass; at 16 rows it splits n as B7 does."""
    m, d, n, rows, splits = case
    assert qlora_bwd_plan(m, n, d, 132)[:2] == (rows, splits)


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
    """B11 over a layer's MLP half: 1-8 rows (mma's N = 8: rows past B are
    zero), at a small width and at 7B (d 4096, f 11008). Both
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


# B11's shapes (d, f): a small width, an f of 9 groups (gate / up tiles of
# gcd(f, 256) = 128 columns; the down phase's 9 groups in splits of 2, the
# last short) and 7B (d 4096, f 11008: down in 3 splits of 29 groups, the
# last 28)
MLP_SHAPES = {"small": (256, 512), "tile128_short_split": (256, 1152), "7b": (4096, 11008)}


def _mlp_case(shape, dtype, device, seed):
    d, f = MLP_SHAPES[shape]
    wg, wu, wd = mlp_weights(d, f, device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    h = torch.randn((8, d), generator=gen, device=device).to(dtype)
    nrm = (1.0 + 0.1 * torch.randn((2, d), generator=gen, device=device)).to(torch.bfloat16)
    return h, (nrm, wg, wu, wd, 1)


def assert_b11_kernels_close(h, args):
    """Each of B11's two kernels against its share of the plain version
    (fused_mlp_stacked_ref's roundings), and the call as the two in turn:
    gate/up's act against the plain act by the int4 rule in bf16 (an f32
    sum taken in another order may flip act's rounding by one bf16 step);
    down over the kernel's own act against the plain down product over the
    same act by the int4 rule in h's dtype (the sums' order alone); the
    call bit-equal to down(gate/up). A flip of act moves an fp32 output by
    a bf16 step of act times its down weights, which a max|y| gate over the
    whole call cannot tell from an error; each kernel alone it can."""
    nrm, wg, wu, wd, layer = args
    got = fused_mlp_stacked(h, *args)
    act = fused_mlp_part(h, *args, 1e-6, 1)
    out = fused_mlp_part(h, *args, 1e-6, 2, act=act)
    assert torch.equal(got, out)
    x = h.float()
    xn = (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * nrm[layer].float())
    xn = xn.to(torch.bfloat16).float()
    yg = torch.einsum("bd,jdc->bjc", xn, fused_decode._dequant_tiles(wg, layer).float())
    yu = torch.einsum("bd,jdc->bjc", xn, fused_decode._dequant_tiles(wu, layer).float())
    act_p = (F.silu(yg) * yu).to(torch.bfloat16).reshape(act.shape)
    assert_int4_close(act, act_p, torch.bfloat16)
    wdq = fused_decode._dequant_tiles(wd, layer).float()  # (NBd, f, BNd)
    down = torch.einsum("bf,kfn->bkn", act.float(), wdq).reshape(h.shape)
    assert_int4_close(out, (down + x).to(h.dtype), h.dtype)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(MLP_SHAPES))
def test_fused_mlp_kernel_row_is_the_same_alone_and_in_any_window(cuda, shape, dtype):
    """Row i of a B-row B11 call (B = 2, 5, 8) is bit-equal to the same row
    alone: the plan's splits do not depend on B, a row's norm sums in a
    fixed order, and mma's columns are independent. Each window's kernels
    hold against the plain version (assert_b11_kernels_close)."""
    h, args = _mlp_case(shape, dtype, cuda, seed=11)
    alone = [fused_mlp_stacked(h[i:i + 1], *args)[0] for i in range(8)]
    for b in (2, 5, 8):
        window = assert_b11_kernels_close(h[:b], args)
        for i in range(b):
            assert torch.equal(alone[i], window[i]), (b, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shape", list(MLP_SHAPES))
def test_fused_mlp_kernel_tile_edges_and_same_bits_twice(cuda, shape, b, dtype):
    """B11 at its tile and split edges: each kernel against the plain
    version, the bf16 call by test_fused_mlp_kernel's rule, and two calls
    give the same bits."""
    h, args = _mlp_case(shape, dtype, cuda, seed=b + 20)
    got = assert_b11_kernels_close(h[:b], args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h.shape[1])
    if dtype == torch.bfloat16:
        assert_int4_close(got, fused_mlp_stacked_ref(h[:b], *args), torch.bfloat16)
    assert torch.equal(got, fused_mlp_stacked(h[:b], *args))


@pytest.mark.cuda
@pytest.mark.parametrize("nrm_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_mlp_kernel_is_two_launches(cuda, b, dtype, nrm_dtype):
    """A B11 call is two launches by name, fused_mlp_gate_up_kernel then
    fused_mlp_down_kernel (the down kernel a programmatic dependent launch),
    and nothing else (the norm scale is read in bf16 or f32 as given), and
    counts one call."""
    d, f = MLP_SHAPES["7b"]
    wg, wu, wd = mlp_weights(d, f, cuda, seed=30)
    gen = torch.Generator(device=cuda).manual_seed(31)
    h = torch.randn((b, d), generator=gen, device=cuda).to(dtype)
    nrm = (1.0 + 0.1 * torch.randn((2, d), generator=gen, device=cuda)).to(nrm_dtype)
    fused_mlp_stacked(h, nrm, wg, wu, wd, 1)  # the build and the first launch's set-up
    before = fused_mlp_stacked.LAUNCHES
    _, names = _launched_kernels(lambda: fused_mlp_stacked(h, nrm, wg, wu, wd, 1))
    assert fused_mlp_stacked.LAUNCHES == before + 1
    assert len(names) == 2, names
    assert any("fused_mlp_gate_up_kernel" in n for n in names), names
    assert any("fused_mlp_down_kernel" in n for n in names), names
    assert_b11_kernels_close(h, (nrm, wg, wu, wd, 1))


# ---------------------------------------------------------------------------
# Where the Hopper designs of B3 (wgmma: 128 query rows a block in two
# warpgroups of 64, key tiles of 128, 64 at D = 256) and of the decode body
# (units of 16 keys of a 128-wide bf16 cache, 32-key tiles, 128- or 256-key
# listed blocks, splits, row groups of 8 query rows) cut their work.
# ---------------------------------------------------------------------------


def _flash_edge_cases():
    cases = {}
    for d in (64, 128, 256):
        bk = 64 if d == 256 else 128
        cases.update({
            f"d{d}_t127_s{bk + 1}_gqa_right_pad": (1, 127, bk + 1, 8, 2, d, True, 2, "right_pad"),
            f"d{d}_t129_s{2 * bk + 1}_off{bk - 37}_left_pad":
                (2, 129, 2 * bk + 1, 4, 4, d, True, bk - 37, "left_pad"),
            f"d{d}_t65_s{bk + 63}_noncausal_hole": (1, 65, bk + 63, 4, 4, d, False, 0, "hole"),
            f"d{d}_t200_s265_off65_gqa_hole": (1, 200, 265, 8, 2, d, True, 65, "hole"),
        })
    return cases


FLASH_EDGE_CASES = _flash_edge_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(FLASH_EDGE_CASES), ids=list(FLASH_EDGE_CASES))
def test_flash_attention_kernel_tile_edges(cuda, case, dtype):
    """B3 with T and S on either side of a query tile (128) and a key tile
    (128, or 64 at D = 256), q_offset a multiple of neither, a left pad, a
    right pad and an interior hole, GQA 4:1, D 64 / 128 / 256: output and
    logsumexp against the plain version, at test_flash_attention_kernel's
    tolerances; rows with no valid key give 0 / NEG_INF."""
    B, T, S, H, K, D, causal, q_offset, mask_kind = FLASH_EDGE_CASES[case]
    q, k, v, mask = flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed=len(case))
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = flash_attention.LAUNCHES
    got, lse = flash_attention(q, k, v, key_mask=t_mask, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    want, want_lse = flash_attention_ref(q, k, v, key_mask=t_mask, causal=causal,
                                         q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-5)
    dead = (want_lse <= -1e29).transpose(1, 2)  # (B, T, H)
    assert not bool(got[dead].any()) and bool((lse[want_lse <= -1e29] <= -1e29).all())


# Where B3b's Hopper design cuts its work: the dk/dv kernel takes 128 keys a
# block (64 a warpgroup) over 64-query tiles, the dq kernel 128 query rows
# a block (64 a warpgroup) over 64-key tiles.
def _flash_bwd_edge_cases():
    cases = {}
    for d in (64, 128):
        cases.update({
            f"d{d}_t63_s65_off2_gqa_right_pad": (1, 63, 65, 8, 2, d, True, 2, "right_pad"),
            f"d{d}_t129_s131_off2_left_pad_dead_rows":
                (2, 129, 131, 4, 4, d, True, 2, "left_pad"),
            f"d{d}_t127_s193_off91": (1, 127, 193, 4, 4, d, True, 91, None),
            f"d{d}_t65_s191_noncausal_hole": (1, 65, 191, 4, 4, d, False, 0, "hole"),
            f"d{d}_t200_s265_off65_gqa_hole": (1, 200, 265, 8, 2, d, True, 65, "hole"),
            f"d{d}_t200_s330_off130_masked_blocks":
                (1, 200, 330, 4, 4, d, True, 130, "wide_hole"),
        })
    # these take the f32 FMA kernels in bf16 too
    cases["fma_d32_gqa"] = (1, 70, 70, 4, 2, 32, True, 3, "right_pad")
    cases["fma_d128_unaligned"] = (1, 70, 70, 4, 4, 128, True, 0, None)
    return cases


FLASH_BWD_EDGE_CASES = _flash_bwd_edge_cases()


def _unaligned(x):
    """x's values at a base 2 bytes past a 16-byte boundary (bf16)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _launched_kernels(fn):
    """fn()'s result and the names of the CUDA kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # work queued before is not fn()'s
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(FLASH_BWD_EDGE_CASES), ids=list(FLASH_BWD_EDGE_CASES))
def test_flash_attention_bwd_kernel_tile_edges(cuda, case, dtype):
    """B3b with T and S on either side of its query and key tiles, q_offset
    a multiple of neither, a left pad with dead rows, a right pad, an
    interior hole and a hole that masks whole key tiles and a whole dk/dv
    block, GQA 4:1, D 64 / 128: dq, dk and dv against the plain version
    under test_flash_attention_bwd_kernel's rule. bf16 at D 64 / 128 with
    aligned bases launches the delta pass and the wgmma grid (dk/dv blocks,
    then dq blocks) and nothing else; D = 32, an unaligned base and f32 the
    two FMA kernels."""
    B, T, S, H, K, D, causal, q_offset, mask_kind = FLASH_BWD_EDGE_CASES[case]
    q, k, v, mask = flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed=len(case))
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    if "unaligned" in case:
        q = _unaligned(q)
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    out, lse = flash_attention(q, k, v, key_mask=t_mask, causal=causal, q_offset=q_offset)
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    # contiguous, as autograd hands it over: the wrapper copies any other dO
    do = torch.where((lse > -1e29).transpose(1, 2)[..., None], do, 0.0).to(dtype).contiguous()
    before = flash_attention_bwd.LAUNCHES
    got, names = _launched_kernels(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, key_mask=t_mask, causal=causal, q_offset=q_offset))
    assert flash_attention_bwd.LAUNCHES == before + 1
    wgmma = dtype == torch.bfloat16 and not case.startswith("fma")
    want_names = (("flash_bwd_delta_kernel", "flash_bwd_wgmma_kernel") if wgmma
                  else ("flash_bwd_dq_fma_kernel", "flash_bwd_dkv_fma_kernel"))
    assert len(names) == len(want_names), names
    assert all(any(w in n for n in names) for w in want_names), names
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
@pytest.mark.parametrize("case", ["7b_2048", "gqa_d64"])
def test_flash_attention_bwd_kernel_gives_the_same_bits_twice(cuda, case):
    """B3b is deterministic: two calls on the same inputs give the same bits
    for dq, dk and dv (no atomics; the GQA group's heads and the tiles are
    added in a fixed order)."""
    B, T, S, H, K, D, causal, q_offset, mask_kind = FLASH_BWD_CASES[case]
    q, k, v, mask = flash_inputs(B, T, S, H, K, D, q_offset, mask_kind, seed=3)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v))
    t_mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    out, lse = flash_attention(q, k, v, key_mask=t_mask, causal=causal, q_offset=q_offset)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(torch.bfloat16)
    first = flash_attention_bwd(q, k, v, out, lse, do, key_mask=t_mask, causal=causal,
                                q_offset=q_offset)
    second = flash_attention_bwd(q, k, v, out, lse, do, key_mask=t_mask, causal=causal,
                                 q_offset=q_offset)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# LITA-HOI's encode (models/lita_hoi.py): 8 clips of T frames x 5 streams,
# a key mask with holes inside the sequence (a stream missing at some
# frames), below one query tile; clip 1 also lacks its first 3 tokens, so
# its first query rows have no valid key (compared on valid rows only: the
# kernel and its plain version give 0 / NEG_INF there, attention_xla
# averages).
def hoi_stream_inputs(t, seed):
    rng = np.random.default_rng(seed)
    n = t * 5 if t == 10 else t
    q, k, v = (rng.normal(size=(8, n, 32, 128)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(8, n)) > 0.3
    mask[:, ::5] = True  # the global stream at every frame
    mask[1, :3] = False
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [10, 64], ids=["T50", "T64"])
def test_flash_attention_kernels_at_the_hoi_shapes(cuda, t, dtype):
    """B3 and B3b at LITA-HOI's encode shapes, T = S = 50 (10 frames x 5
    streams) and 64, causal, the stream-hole key mask: output and
    logsumexp at test_flash_attention_kernel's tolerances, dq / dk / dv by
    test_flash_attention_bwd_kernel's rule, on the rows with a valid key."""
    q, k, v, mask = hoi_stream_inputs(t, seed=t)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    t_mask = torch.from_numpy(mask).to(cuda)
    before = (flash_attention.LAUNCHES, flash_attention_bwd.LAUNCHES)
    out, lse = flash_attention(q, k, v, key_mask=t_mask)
    want, want_lse = flash_attention_ref(q, k, v, key_mask=t_mask)
    live = (want_lse > -1e29).transpose(1, 2)  # (B, T, H)
    assert not bool(live.all()) and bool(live[0].all())
    torch.testing.assert_close(out.float()[live], want.float()[live], **CUDA_TOL[dtype])
    torch.testing.assert_close(lse[want_lse > -1e29], want_lse[want_lse > -1e29],
                               atol=1e-3, rtol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(t)
    do = torch.randn(q.shape, generator=gen, device=cuda)
    do = torch.where(live[..., None], do, 0.0).to(dtype).contiguous()
    got = flash_attention_bwd(q, k, v, out, lse, do, key_mask=t_mask)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention_bwd.LAUNCHES) == (before[0] + 1,
                                                                        before[1] + 1)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, key_mask=t_mask)
    ref32 = [None] * 3
    if dtype == torch.bfloat16:
        ref32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse, do.float(),
                                        key_mask=t_mask)
    for name, g, w, w32 in zip(("dq", "dk", "dv"), got, ref, ref32):
        assert_grad_close(g, w, dtype, name, w32)


DECODE_EDGE_LENGTHS = [1, 15, 16, 17, 127, 128, 129, 255, 256, 257, 1000]


def _decode_edge_inputs(cuda, cache, b, s, h, kh, d, tw, seed):
    """q (B, T, H, D) in the query dtype, the cache as the wrapper takes it
    (bf16, f32, or int8 with its scales), and a mask with row 1 padded and
    holed (row 0 unmasked)."""
    q, ck, cv, _ = decode_inputs(2, b, s, h, kh, d, tw, None, seed=seed)
    mask = np.ones((b, s), bool)
    mask[1:, :5] = False
    mask[1:, 20:26] = False
    dtype = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.from_numpy(q).to(cuda, dtype)
    if cache == "int8":
        planes = [x.to(cuda) for x in quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))]
    else:
        planes = [torch.from_numpy(x).to(cuda, dtype) for x in (ck, cv)]
    return q, planes, torch.from_numpy(mask).to(cuda), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("tw", [1, 5, 8])
@pytest.mark.parametrize("length", DECODE_EDGE_LENGTHS)
def test_decode_attention_kernel_tile_edges(cuda, length, tw, groups, cache):
    """B1 (bf16, f32) and B6 (int8) with lengths on either side of a unit
    (16 keys of a 128-wide bf16 key), a tile (32), a listed block (128 and
    256) and across many splits (K = 2, B = 2: up to 66 splits of one
    tile); windows of 1, 5 and 8 rows (8 rows of 4 groups: 32 query rows,
    four row groups of a block each); G = 1 and 4. A window row whose keys
    all lie past its causal limit gives 0, as in the plain version."""
    B, S, K, D = 2, 1024, 2, 128
    q, planes, mask, dtype = _decode_edge_inputs(cuda, cache, B, S, K * groups, K, D, tw,
                                                 seed=length + tw)
    attend, ref = ((decode_attention_stacked_q, decode_attention_stacked_q_ref)
                   if cache == "int8" else (decode_attention_stacked, decode_attention_stacked_ref))
    before = attend.LAUNCHES
    got = attend(q, *planes, 1, length, key_mask=mask)
    torch.cuda.synchronize()
    assert attend.LAUNCHES == before + 1
    want = ref(q, *planes, 1, length, key_mask=mask)
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("tw", range(1, 9))
def test_decode_attention_kernel_windows(cuda, tw, groups, cache):
    """B1 / B6 at every window size T = 1..8 (G x T query rows: one row
    group of a block up to 8 rows, then two to four), 257 keys: one past a
    listed block, across split boundaries."""
    B, S, K, D, length = 2, 1024, 2, 128, 257
    q, planes, mask, dtype = _decode_edge_inputs(cuda, cache, B, S, K * groups, K, D, tw,
                                                 seed=tw + groups)
    attend, ref = ((decode_attention_stacked_q, decode_attention_stacked_q_ref)
                   if cache == "int8" else (decode_attention_stacked, decode_attention_stacked_ref))
    got = attend(q, *planes, 0, length, key_mask=mask)
    want = ref(q, *planes, 0, length, key_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("tw", [1, 4])
@pytest.mark.parametrize("d", HEAD_SIZES)
def test_decode_attention_kernel_head_sizes(cuda, d, tw, cache):
    """B1 / B6 at every head size the body takes (a key is d / 8 lanes:
    2 at d = 16, 32 at d = 256), GQA 2:1, a padded second row."""
    B, S, K, length = 2, 600, 2, 555
    q, planes, mask, dtype = _decode_edge_inputs(cuda, cache, B, S, 2 * K, K, d, tw, seed=d)
    attend, ref = ((decode_attention_stacked_q, decode_attention_stacked_q_ref)
                   if cache == "int8" else (decode_attention_stacked, decode_attention_stacked_ref))
    got = attend(q, *planes, 0, length, key_mask=mask)
    want = ref(q, *planes, 0, length, key_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("length", DECODE_EDGE_LENGTHS)
def test_decode_attention_single_kernel_tile_edges(cuda, length, groups, dtype):
    """B12 (no block table: every 32-key tile below `length`) at the same
    lengths, G = 1 and 4, with a padded and holed second row."""
    B, S, K, D = 2, 1024, 2, 128
    q, (k, v), mask, _ = _decode_edge_inputs(cuda, "f32", B, S, K * groups, K, D, 1,
                                             seed=length)
    q, k, v = (x.to(dtype) for x in (q, k[1], v[1]))
    before = decode_attention.LAUNCHES
    got = decode_attention(q, k, v, length, key_mask=mask)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES == before + 1
    want = decode_attention_ref(q, k, v, length, key_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.parametrize("kh,b", [(32, 1), (32, 8), (8, 1), (2, 2), (40, 16)])
def test_decode_split_count_covers_the_card(kh, b):
    """The decode body's split count: the fewest splits per (kv head, row)
    whose blocks cover a 132-SM card twice, one where the (kv head, row)
    pairs alone do, and never more than a cluster holds (8)."""
    n = max_splits(132, kh, b)
    assert 1 <= n <= 8
    assert kh * b * n >= 2 * 132 or n == 8
    assert n == 1 or kh * b * (n - 1) < 2 * 132


# ---------------------------------------------------------------------------
# Tensor parallelism inside training: the kernels on a rank's slices
# ---------------------------------------------------------------------------


def _slice(t, r, tp, dim):
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 4])
def test_flash_attention_on_a_head_slice(cuda, tp, dtype):
    """B3 and B3b on each rank's H/tp heads (causal, 2048 rows, 8 heads of
    128, GQA 2 kv heads a rank at tp = 2): the ranks' outputs and
    gradients concatenated over the heads against the unsharded call, by
    the attention and gradient rules."""
    B, T, H, K, D = 1, 2048, 8, 4 if tp == 2 else 8, 128
    gen = torch.Generator(device=cuda).manual_seed(19 + tp)
    q = torch.randn((B, T, H, D), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((B, T, K, D), generator=gen, device=cuda).to(dtype) for _ in range(2))
    dy = torch.randn((B, T, H, D), generator=gen, device=cuda).to(dtype)

    def run(q, k, v, dy):
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        out, _ = flash_attention(q, k, v, causal=True)
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), dy))

    want = run(q, k, v, dy)
    before = (flash_attention.LAUNCHES, flash_attention_bwd.LAUNCHES)
    parts = [run(*(_slice(x, r, tp, 2) for x in (q, k, v, dy))) for r in range(tp)]
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention_bwd.LAUNCHES) == (
        before[0] + tp, before[1] + tp)
    got = [torch.cat([p[i] for p in parts], dim=2) for i in range(4)]
    torch.testing.assert_close(got[0].float(), want[0].float(), **CUDA_TOL[dtype])
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert_grad_close(g, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_down"])
def test_int8_matmul_row_slices_summed(cuda, shape, tp):
    """B9 (f32 out, 2048 rows) on each rank's input rows of a row-parallel
    projection: the ranks' partial products summed against the unsharded
    call, by the int8 rule."""
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 1, cuda, seed=tp)
    x = torch.randn((2048, din), generator=torch.Generator(device=cuda).manual_seed(tp),
                    device=cuda).to(torch.bfloat16)
    before = int8_matmul.LAUNCHES
    got = sum(int8_matmul(_slice(x, r, tp, 1), _slice(w8[0], r, tp, 0), sc[0])
              for r in range(tp))
    torch.cuda.synchronize()
    assert int8_matmul.LAUNCHES == before + tp
    assert_int4_close(got, int8_matmul(x, w8[0], sc[0]), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shape", ["7b_wq", "7b_w_down"])
def test_qlora_fused_row_slices_summed(cuda, shape, tp):
    """B10a and B10b through the fused QLoRA front (r = 128) on each rank's
    input rows of a row-parallel projection, its adapter's a cut alike:
    the ranks' bf16 partial outputs summed (`assert_partials_close`), and
    their dx (each the rank's rows of the whole dx) concatenated by the
    int4 rule in bf16, against the unsharded call."""
    din, dout = INT8_SHAPES[shape]
    w8, sc = int8_weights(din, dout, 1, cuda, seed=tp + 5)
    gen = torch.Generator(device=cuda).manual_seed(tp + 5)
    x = torch.randn((2048, din), generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn((2048, dout), generator=gen, device=cuda).to(torch.bfloat16)
    a = 0.02 * torch.randn((din, 128), generator=gen, device=cuda)
    b = 0.02 * torch.randn((128, dout), generator=gen, device=cuda)

    def run(x, w8, a):
        xg = x.clone().requires_grad_()
        y = int8_lora_matmul_stacked(xg, w8, sc, a, b, 2.0, 0)
        return y.detach(), torch.autograd.grad(y, xg, dy)[0]

    want = run(x, w8, a)
    parts = [run(_slice(x, r, tp, 1), _slice(w8, r, tp, 1), _slice(a, r, tp, 0))
             for r in range(tp)]
    assert_partials_close([p[0] for p in parts], want[0])
    assert_int4_close(torch.cat([p[1] for p in parts], dim=-1), want[1], torch.bfloat16)


def assert_partials_close(parts, want):
    """bf16 partial products (each rounded by its kernel) summed in f32
    against the unsharded call: the int4 rule with one bf16 step for each
    partial and for the whole (2^-7 x (sum |partial| + |want|)), as a
    partial may exceed the sum."""
    got = sum(p.float() for p in parts)
    want = want.float()
    bound = 2e-3 * want.abs().max() + 2.0 ** -7 * (sum(p.float().abs() for p in parts)
                                                   + want.abs())
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
