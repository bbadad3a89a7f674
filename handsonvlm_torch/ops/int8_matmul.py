"""Weight-only int4 / int8 quantization and the quantized matmuls.

Port of `handsonvlm_tpu/ops/int8_matmul.py`, for the quantized decoders
(`--int4`, `--int8`) and the weight layouts the JAX package's decoder takes:

- `quantize_int8` / `quantize_lm_head` / `quantize_stacked_int8`:
  per-column symmetric int8 (the int8 decoder's projections and the head).
- `quantize_int4` / `unpack_int4` / `tile_int4_stacked`: group-wise
  symmetric int4 (group 128, gcd fallback for small dims), two nibbles per
  byte (row r of a group with row r + g/2; the low nibble biased by +8),
  optionally re-laid out into contiguous (NB, G, g/2, BN) tiles per layer
  with BN frozen by `pick_block_n`. Bytes and scales are bit-identical to
  the JAX package's, so a checkpoint quantized by either package loads in
  the other.
- The kernels, each a wrapper that launches its hand-written Hopper kernel
  for CUDA tensors and runs its plain version (`*_ref`) for CPU tensors.
  There is no fallback: on a CUDA tensor a wrapper launches its kernel or
  raises. `<wrapper>.LAUNCHES` counts launches.
  - B9 `int8_matmul` (`csrc/int8_matmul.cu`): x @ (w8 * scale), f32
    accumulation, the GEMV (`csrc/gemv.cuh`) below INT8_TC_MIN_M rows, the
    tensor cores from there;
  - B4b `int4_gemv_tiled`, B4c `int4_gemv_flat` and B4a `int4_matmul`
    (`csrc/int4_gemv.cu`: the GEMV of `csrc/gemv.cuh` over the tiled and
    the flat address map): the int4 GEMV over a stacked tiled, a stacked
    flat and one flat matrix;
  - B5b `int4_matmul_prefill_tiled` and B5a `int4_matmul_prefill`
    (`csrc/int4_prefill.cu`): the prefill matmul over the stacked tiled and
    flat layouts;
  - B7b `int4_matmul_T_tiled` and B7a `int4_matmul_T_flat`
    (`csrc/int4_transpose.cu`): the transpose product dy @ dequant(W)^T
    over the same two layouts, the input gradient through a frozen int4
    projection.
- `int4_matmul_stacked` dispatches on the layout (5-D tiled, 4-D flat) and
  then on rows as the JAX package does (rows = B x T); `maybe_int8_matmul`
  takes a dense weight, an int8 {"w8", "scale"} or a flat int4
  {"w4", "gscale"} leaf, as the JAX package's does;
  `int4_matmul_stacked_T` dispatches the transpose product on the layout.
- Gradients: under grad mode with an x that requires grad, the int4
  products run as an autograd Function whose backward is B7b / B7a (the
  JAX package's `int4_matmul_stacked` custom_vjp), dx cast to x's dtype,
  and `int8_matmul` as one whose backward is dy @ (w8 * scale)^T in plain
  torch (the JAX package's default int8 path is a differentiable XLA dot).
  The quantized weights and scales get no gradient.

The plain versions differ on purpose, as the Pallas kernels do: B4a/B4b/B4c's
is the exact product (per-group f32 dot products, the f32 scale applied to
each group's partial sum); B5a/B5b's rounds x to bf16 and each weight to
bf16(bf16(nibble) x bf16(scale)) before an f32-accumulated product; B9's is
(x @ w8) in f32 times the column scale, since bf16(int8) is exact; B7a/B7b's
rounds dy to bf16 and the weights as B5a/B5b's do.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

INT4_GROUP = 128  # contraction-group size of the int4 scales
INT4_PREFILL_MIN_M = 128  # rows from which the prefill matmul serves a projection
INT4_GEMV_BN = 512  # widest weight tile (columns) of the tiled layout
# rows from which B9 runs a bf16 x on the tensor cores (below, and for an
# f32 x at any m: the GEMV). It is the least row count above every
# decode-time one: verify windows (SPEC_K + 1 = 5 rows) and slot batches (8)
# stay on the GEMV, whose rows sum alone (chip_smoke.py's B9 crossover table
# times both routes around it)
INT8_TC_MIN_M = 9
# the GEMV's blocks (csrc/gemv.cuh): output columns and rows of x a block,
# splits of a column block's contraction (one thread block cluster, the
# portable size), rows of d a B9 stage
GEMV_COLS, GEMV_ROWS, GEMV_MAX_SPLITS, GEMV_INT8_STAGE = 128, 8, 8, 64


# ---------------------------------------------------------------------------
# Quantizers (bit-identical to the JAX package's)
# ---------------------------------------------------------------------------


def quantize_int8(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice along `axis` (reduced over):
    w -> (w8 int8 of w's shape, scale f32 of the other axis's size)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    w8 = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return w8, scale


def quantize_lm_head(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head's (V, d) weight (nn.Linear layout) -> (w8 (V, d) int8,
    scale (V,) f32): one scale per vocab entry, the JAX package's
    per-vocab-column int8 head in the transposed layout."""
    return quantize_int8(weight, axis=1)


def quantize_stacked_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, din, dout) -> (w8 (L, din, dout) int8, scale (L, dout) f32): one
    scale per output column of each layer, the JAX package's
    `quantize_stacked_int8`."""
    return quantize_int8(w, axis=1)


def int4_group(d: int, group: int = INT4_GROUP) -> int:
    """The group size `quantize_int4` uses for a contraction of d rows."""
    if d % group:
        group = math.gcd(d, group) or d  # small test dims
    if group % 2:
        group *= 2  # the two halves of a group share a byte
    return group


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4: w (d, n) -> (w4 (G, g/2, n) int8,
    gscale (G, n) f32), d = G*g.

    Packing: within each group row r shares a byte with row r + g/2; the
    high nibble holds the second half's value (two's complement), the low
    nibble the first half's value biased by +8:
    byte = ((lo + 8) & 0xF) | (hi << 4)."""
    d, n = w.shape
    group = int4_group(d, group)
    wf = w.float().reshape(d // group, group, n)
    absmax = wf.abs().amax(dim=1)  # (G, n)
    scale = torch.where(absmax > 0, absmax / 7.0, 1.0)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -8, 7).to(torch.int32)
    half = group // 2
    lo, hi = q[:, :half], q[:, half:]
    packed = ((lo + 8) & 0x0F) | ((hi & 0x0F) << 4)  # 0..255
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_int4(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., g/2, n) packed bytes -> (..., g, n) values in `dtype`, rows
    ordered [low-nibble half, high-nibble half] as in `quantize_int4`."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 0x0F) - 8).to(dtype)
    hi = (p32 >> 4).to(dtype)  # arithmetic shift sign-extends
    return torch.cat([lo, hi], dim=-2)


def pick_block_n(n: int, d_bytes: int) -> int:
    """Tile width BN of the tiled layout: the largest block_n <= INT4_GEMV_BN
    that divides n and keeps a packed tile under 2.5 MB (the JAX package's
    `_pick_block_n`, which froze the layout of its checkpoints)."""
    block_n = min(INT4_GEMV_BN, n)
    while block_n > 8 and (n % block_n or 2 * d_bytes * block_n > 5 * 1024 * 1024):
        block_n //= 2
    return max(block_n, math.gcd(n, 128))


def tile_int4_stacked(w4_all: torch.Tensor, gs_all: torch.Tensor, block_n: int = 0):
    """Stacked packed weights (L, G, g/2, n) and scales (L, G, n) -> the
    tiled layout w4t (L, NB, G, g/2, BN) and gst (L, NB, G, BN): each
    weight tile is one contiguous block."""
    L, G, half, n = w4_all.shape
    bn = block_n or pick_block_n(n, G * half)
    nb = n // bn
    if nb * bn != n:
        raise ValueError(f"tile width {bn} does not divide {n}")
    w4t = w4_all.reshape(L, G, half, nb, bn).permute(0, 3, 1, 2, 4).contiguous()
    gst = gs_all.reshape(L, G, nb, bn).permute(0, 2, 1, 3).contiguous()
    return w4t, gst


def tiled_shapes(din: int, dout: int, num_layers: int, group: int = INT4_GROUP):
    """Shapes of (w4t, gst) for a (din -> dout) projection stacked over
    `num_layers` layers."""
    g = int4_group(din, group)
    G, half = din // g, g // 2
    bn = pick_block_n(dout, G * half)
    nb = dout // bn
    return (num_layers, nb, G, half, bn), (num_layers, nb, G, bn)


def dequantize_tiled(w4t: torch.Tensor, gst: torch.Tensor, layer_idx: int) -> torch.Tensor:
    """Layer `layer_idx` of a tiled projection -> the exactly dequantized
    (d, n) f32 weight (values x scales, one rounding)."""
    _, nb, G, half, bn = w4t.shape
    q = unpack_int4(w4t[layer_idx], torch.float32)  # (NB, G, g, BN)
    w = q * gst[layer_idx].float()[:, :, None, :]
    return w.permute(1, 2, 0, 3).reshape(G * 2 * half, nb * bn)


def untile_int4_stacked(w4t: torch.Tensor, gst: torch.Tensor):
    """The inverse of `tile_int4_stacked`: the tiled layout -> the flat
    stacked w4 (L, G, g/2, n) and gscale (L, G, n), the bytes unchanged."""
    L, nb, G, half, bn = w4t.shape
    w4 = w4t.permute(0, 2, 3, 1, 4).reshape(L, G, half, nb * bn).contiguous()
    return w4, gst.permute(0, 2, 1, 3).reshape(L, G, nb * bn).contiguous()


def dequantize_int4(w4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """One flat matrix w4 (G, g/2, n), gscale (G, n) -> the exactly
    dequantized (d, n) f32 weight."""
    G, half, n = w4.shape
    return (unpack_int4(w4, torch.float32) * gscale.float()[:, None, :]).reshape(2 * G * half, n)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_matmul_ref(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """x (..., d) @ w8 (d, n) in f32, times scale (n,) -> (..., n) in
    `out_dtype`: the Pallas kernel's (x @ bf16(w8)) * scale, whose
    bf16(int8) is exact."""
    return ((x.float() @ w8.float()) * scale).to(out_dtype)


def int4_matmul_ref(x: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ dequant(w4 (G, g/2, n), gscale (G, n)) -> (..., n) in
    x.dtype, as y[n] = sum_g s[g, n] * sum_r x[g*g_size + r] * q[g, r, n]
    in f32: the exact product, up to f32 summation."""
    G, half, n = w4.shape
    x2 = x.reshape(-1, G, 2 * half).float()
    part = torch.einsum("mgr,grn->mgn", x2, unpack_int4(w4, torch.float32))
    y = (part * gscale.float()[None]).sum(dim=1)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def int4_gemv_flat_ref(x: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor,
                       layer_idx: int) -> torch.Tensor:
    """`int4_matmul_ref` over layer `layer_idx` of the flat stacked layout
    w4 (L, G, g/2, n), gscale (L, G, n)."""
    return int4_matmul_ref(x, w4[layer_idx], gscale[layer_idx])


def int4_gemv_tiled_ref(x: torch.Tensor, w4t: torch.Tensor, gst: torch.Tensor,
                        layer_idx: int) -> torch.Tensor:
    """x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in x.dtype, as
    y[n] = sum_g s[g, n] * sum_r x[g*g_size + r] * q[g, r, n] in f32: the
    exact product, up to f32 summation."""
    _, nb, G, half, bn = w4t.shape
    group = 2 * half
    x2 = x.reshape(-1, G, group).float()
    q = unpack_int4(w4t[layer_idx], torch.float32)  # (NB, G, g, BN)
    part = torch.einsum("mgr,jgrc->mjgc", x2, q)
    y = (part * gst[layer_idx].float()[None]).sum(dim=2)  # (m, NB, BN)
    return y.reshape(*x.shape[:-1], nb * bn).to(x.dtype)


def _dequant_bf16(p: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Packed bytes (..., G, g/2, N) and scales (..., G, N) -> the weights
    (..., G, g, N) as bf16(bf16(nibble) * bf16(scale)), the Pallas kernels'
    per-group dequantization."""
    p = p.to(torch.int32)
    s = sc.to(torch.bfloat16)[..., None, :]
    lo = ((p & 0x0F) - 8).to(torch.bfloat16) * s
    hi = (p >> 4).to(torch.bfloat16) * s
    return torch.cat([lo, hi], dim=-2)


def int4_matmul_prefill_tiled_ref(x: torch.Tensor, w4t: torch.Tensor, gst: torch.Tensor,
                                  layer_idx: int) -> torch.Tensor:
    """x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in x.dtype with the
    Pallas prefill kernel's roundings: x to bf16, each weight to
    bf16(bf16(nibble) * bf16(scale)), f32 accumulation."""
    _, nb, G, half, bn = w4t.shape
    d = G * 2 * half
    x2 = x.reshape(-1, d).to(torch.bfloat16)
    w = _dequant_bf16(w4t[layer_idx], gst[layer_idx])  # (NB, G, g, BN)
    w = w.permute(1, 2, 0, 3).reshape(d, nb * bn)
    y = x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], nb * bn).to(x.dtype)


def int4_matmul_prefill_ref(x: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor,
                            layer_idx: int) -> torch.Tensor:
    """`int4_matmul_prefill_tiled_ref` over the flat stacked layout: the flat
    layout is the tiled one with a single tile of all n columns."""
    L, G, half, n = w4.shape
    return int4_matmul_prefill_tiled_ref(x, w4.view(L, 1, G, half, n),
                                         gscale.view(L, 1, G, n), layer_idx)


def int4_matmul_T_tiled_ref(dy: torch.Tensor, w4t: torch.Tensor, gst: torch.Tensor,
                            layer_idx: int) -> torch.Tensor:
    """dy (..., n) @ dequant(w4t[layer_idx])^T -> (..., d) in dy.dtype with
    the Pallas transpose kernel's roundings: dy to bf16 whatever its dtype,
    each weight bf16(bf16(nibble) * bf16(scale)), f32 sums."""
    _, nb, G, half, bn = w4t.shape
    d = G * 2 * half
    dy2 = dy.reshape(-1, nb * bn).to(torch.bfloat16)
    w = _dequant_bf16(w4t[layer_idx], gst[layer_idx])  # (NB, G, g, BN)
    w = w.permute(1, 2, 0, 3).reshape(d, nb * bn)
    return (dy2.float() @ w.float().t()).reshape(*dy.shape[:-1], d).to(dy.dtype)


def int4_matmul_T_flat_ref(dy: torch.Tensor, w4: torch.Tensor, gscale: torch.Tensor,
                           layer_idx: int) -> torch.Tensor:
    """`int4_matmul_T_tiled_ref` over the flat stacked layout (one tile of
    all n columns)."""
    L, G, half, n = w4.shape
    return int4_matmul_T_tiled_ref(dy, w4.view(L, 1, G, half, n), gscale.view(L, 1, G, n),
                                   layer_idx)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gemv_split(nb: int, groups: int, n_sm: int) -> Tuple[int, int]:
    """(splits, groups per split) of the GEMV's contraction over `groups`
    units for `nb` column blocks: the fewest splits (up to GEMV_MAX_SPLITS,
    one cluster) that make at least 5/8 of n_sm blocks. On an H100 a block
    streams its weight best alone on its SM; each split past that adds a
    pipeline fill and its share of the merge (chip_smoke.py's B4b and B9
    lines time the 7B projections; a sweep of the split count put every 7B
    projection's best at the least count past 5/8 of the SMs). The row
    count does not enter: a row reduces over the same splits in the same
    order whether it comes alone or as row i of a verify window or a slot
    batch, so greedy speculative decode sees the logits of sequential
    decode."""
    want = min(GEMV_MAX_SPLITS, groups, max(1, -(-5 * n_sm // (8 * nb))))
    per = -(-groups // want)
    return -(-groups // per), per


class GemvPlan(NamedTuple):
    """A GEMV launch: grid (splits, row_tiles, blocks), clusters of splits."""
    blocks: int     # column blocks of GEMV_COLS columns
    row_tiles: int  # tiles of GEMV_ROWS rows of x
    splits: int     # splits of the contraction
    per: int        # contraction units a split: int4 groups, B9 stages of 64 rows


def int4_gemv_plan(m: int, nb: int, groups: int, bn: int, n_sm: int) -> GemvPlan:
    """The int4 GEMV's plan for m rows over NB tiles of BN columns and G
    groups (the tiled layout's, or the flat layout's with BN from
    `pick_block_n`): a column block is 128 columns of one tile."""
    blocks = nb * -(-bn // GEMV_COLS)
    return GemvPlan(blocks, -(-m // GEMV_ROWS), *gemv_split(blocks, groups, n_sm))


def int8_gemv_plan(m: int, d: int, n: int, n_sm: int) -> GemvPlan:
    """B9's GEMV plan for x (m, d) and w8 (d, n): units of GEMV_INT8_STAGE
    rows of d."""
    blocks = -(-n // GEMV_COLS)
    return GemvPlan(blocks, -(-m // GEMV_ROWS),
                    *gemv_split(blocks, -(-d // GEMV_INT8_STAGE), n_sm))


def _split_refusal(units: int, splits: int, per: int, row_tiles: int, blocks: int):
    if not 1 <= splits <= GEMV_MAX_SPLITS:
        return f"{splits} splits: the GEMV takes 1..{GEMV_MAX_SPLITS} (one cluster)"
    if per < 1 or (splits - 1) * per >= units or splits * per < units:
        return f"{splits} splits of {per} do not cover {units} units once"
    if not 1 <= row_tiles <= 65535 or not 1 <= blocks <= 65535:
        return f"a grid of {row_tiles} row tiles x {blocks} column blocks"
    return None


def int4_gemv_refusal(m: int, nb: int, groups: int, half: int, bn: int, splits: int,
                      per: int) -> Optional[str]:
    """Why `hv_int4_gemv` (csrc/int4_gemv.cu) would refuse these arguments,
    its checks mirrored; None if it takes them."""
    if bn < 16 or bn % 16 or half not in (8, 16, 32, 64) or nb < 1 or groups < 1:
        return (f"the int4 GEMV needs a tile width that is a multiple of 16 and a group of "
                f"16, 32, 64 or 128 rows, got {bn}, {2 * half}")
    return _split_refusal(groups, splits, per, -(-m // GEMV_ROWS), nb * -(-bn // GEMV_COLS))


def int8_gemv_refusal(m: int, d: int, n: int, splits: int, rows_per_split: int) -> Optional[str]:
    """Why `hv_int8_matmul` (csrc/int8_matmul.cu) would refuse these GEMV
    arguments, its checks mirrored; None if it takes them."""
    if m < 1 or d < 8 or d % 8 or n < 16 or n % 16:
        return f"B9 takes d a multiple of 8 and n of 16, got d={d}, n={n}"
    if rows_per_split < 1 or rows_per_split % GEMV_INT8_STAGE:
        return f"B9's splits are whole 64-row stages, got {rows_per_split} rows"
    if (splits - 1) * rows_per_split >= d or splits * rows_per_split < d:
        return f"{splits} splits of {rows_per_split} rows do not cover d={d} once"
    return _split_refusal(-(-d // GEMV_INT8_STAGE), splits, rows_per_split // GEMV_INT8_STAGE,
                          -(-m // GEMV_ROWS), -(-n // GEMV_COLS))


def _int4_geometry(x, w, s, layer_idx, what, transpose=False):
    """Check an int4 call (x of d features, or with `transpose` of n);
    returns (flat, NB, G, g/2, BN) where BN is the tiled layout's tile
    width, and for the flat layout (L, G, g/2, n) the width `pick_block_n`
    gives the same weight's tiled layout."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or f32 x, got {x.dtype}")
    flat = w.dim() == 4
    if w.dtype != torch.int8 or s.dtype != torch.float32 or w.dim() not in (4, 5):
        raise TypeError(f"{what} takes int8 tiles (L, NB, G, g/2, BN) or a flat stack "
                        f"(L, G, g/2, n) and f32 scales, got {w.dtype} {tuple(w.shape)} / "
                        f"{s.dtype}")
    if flat:
        L, G, half, n = w.shape
        bn = pick_block_n(n, G * half)
        nb = n // bn
        want_s = (L, G, n)
    else:
        L, nb, G, half, bn = w.shape
        want_s = (L, nb, G, bn)
    if tuple(s.shape) != want_s:
        raise ValueError(f"scales {tuple(s.shape)} do not fit weights {tuple(w.shape)}")
    want = nb * bn if transpose else G * 2 * half
    if x.shape[-1] != want:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {want}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range for L={L}")
    if not (x.device == w.device == s.device):
        raise ValueError("x, the weights and the scales must be on one device")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError("the weights and the scales must be contiguous")
    return flat, nb, G, half, bn


def _launch_gemv(x, w, s, layer_idx, counter):
    from handsonvlm_torch.ops._build import check, load_library

    flat, nb, G, half, bn = _int4_geometry(x, w, s, layer_idx, "int4 gemv")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:  # TMA reads x from 16-byte aligned rows
        x2 = x2.clone()
    m, n = x2.shape[0], nb * bn
    plan = int4_gemv_plan(m, nb, G, bn, _num_sms(x.device.index))
    refusal = int4_gemv_refusal(m, nb, G, half, bn, plan.splits, plan.per)
    if refusal:
        raise ValueError(refusal)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.hv_int4_gemv(
            x2.data_ptr(), w[layer_idx].data_ptr(), s[layer_idx].data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), int(flat), m, nb, G, half, bn, plan.splits,
            plan.per, torch.cuda.current_stream().cuda_stream)
    check(status, counter.__name__)
    counter.LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


def _slot_use(blocks: int, n_sm: int) -> float:
    """The share of the card's block slots (one block an SM) that `blocks`
    blocks fill over the waves they take."""
    return blocks / (-(-blocks // n_sm) * n_sm)


def prefill_split(m: int, n: int, groups: int, n_sm: int) -> Tuple[int, int]:
    """(splits, groups per split) of the prefill matmul's contraction. The
    kernel's 7B tiles (128 rows, 256 columns) take one block an SM;
    splitting the groups (at least four a split, at most eight splits)
    multiplies the blocks, and the split count that fills the waves best
    wins, each split past the first charged 0.1 of the slots for writing
    and summing its f32 partials (in split order). It reads (m, n, G) alone,
    so the tiled and the flat layout of one weight split alike and give the
    same bits."""
    blocks = -(-m // 128) * -(-n // 256)
    best, score = 1, _slot_use(blocks, n_sm)
    for splits in range(2, min(8, groups // 4) + 1):
        use = _slot_use(blocks * splits, n_sm) - 0.1 * (splits - 1)
        if use > score:
            best, score = splits, use
    per = -(-groups // best)
    return -(-groups // per), per


# wgmma's N, the rows of m a block of B7 (int4 transpose) and B9's tensor
# cores takes (csrc/weight_gemm.cuh with_rows_tile)
ROW_TILES = (16, 32, 64, 104, 128)
WGMMA_K_STAGE = 64  # contraction rows (B9) or columns (B7) a stage of their rings
WGMMA_BLOCK = 256  # weight columns (B9) or rows of d (B7) a block
# The time model their plans minimise, fitted to B7's and B9's times at the
# 7B projections on an H100 (PERF.md, section 6): a wave of blocks takes a
# 64-deep stage in STAGE_S + STAGE_ROW_S x (row tile) seconds, or in the
# time its weight bytes take at STAGE_BYTES_S; split-K adds 8 bytes an
# output element a split (f32 partials written, then read by the merge) at
# SPLIT_BYTES_S, and the merge's launch.
STAGE_S, STAGE_ROW_S, STAGE_BYTES_S = 0.55e-6, 3.3e-9, 3.0e12
SPLIT_BYTES_S, MERGE_S = 2.0e12, 2e-6


# memoised: a call walks ~80 candidate plans in Python, on the host's path
# before every B7, B9 and B10 launch
@functools.lru_cache(maxsize=4096)
def wgmma_plan(m: int, outs: int, stages: int, n_sm: int,
               stage_bytes: int) -> Tuple[int, int, int]:
    """(row tile, splits, stages per split) for m rows, `outs` output
    columns in blocks of WGMMA_BLOCK and a contraction of `stages` stages
    of `stage_bytes` weight bytes a block, one block an SM: the plan of
    least modelled time, up to 16 splits of at least four stages each.
    Split s takes the stages [s * per, (s + 1) * per)."""
    best = None
    for rows in ROW_TILES:
        blocks = -(-m // rows) * -(-outs // WGMMA_BLOCK)
        for want in range(1, max(1, min(16, stages // 4)) + 1):
            per = -(-stages // want)
            splits = -(-stages // per)
            stage_s = max(STAGE_S + STAGE_ROW_S * rows,
                          min(blocks * splits, n_sm) * stage_bytes / STAGE_BYTES_S)
            t = -(-blocks * splits // n_sm) * per * stage_s
            if splits > 1:
                t += 8 * splits * m * outs / SPLIT_BYTES_S + MERGE_S
            if best is None or t < best[0]:
                best = (t, rows, splits, per)
    return best[1:]


def transpose_plan(m: int, n: int, d: int, n_sm: int) -> Tuple[int, int, int]:
    """(row tile, splits, 64-column stages of n per split) of B7 for dy (m, n)
    and a weight of d rows: blocks of WGMMA_BLOCK rows of d x the row tile.
    It reads the shapes alone, so the tiled and the flat layout of one
    weight plan alike and give the same bits."""
    return wgmma_plan(m, d, n // WGMMA_K_STAGE, n_sm, WGMMA_BLOCK // 2 * WGMMA_K_STAGE)


def int8_tc_plan(m: int, d: int, n: int, n_sm: int) -> Tuple[int, int, int]:
    """(row tile, splits, rows of d per split: a multiple of 64) of B9's
    tensor-core route for x (m, d) and w8 (d, n): blocks of WGMMA_BLOCK
    weight columns x the row tile."""
    rows, splits, per = wgmma_plan(m, n, -(-d // WGMMA_K_STAGE), n_sm,
                                   WGMMA_BLOCK * WGMMA_K_STAGE)
    return rows, splits, per * WGMMA_K_STAGE


def _launch_prefill(x, w, s, layer_idx, counter):
    from handsonvlm_torch.ops._build import check, load_library

    flat, nb, G, half, bn = _int4_geometry(x, w, s, layer_idx, "int4 prefill")
    if flat:  # the flat layout is the tiled one with a single tile of n columns
        nb, bn = 1, nb * bn
    if bn % 64 or half % 32:
        raise ValueError(f"int4 prefill needs a tile width that is a multiple of 64 "
                         f"and a group that is a multiple of 64, got {bn}, {2 * half}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x2 = x2.clone()
    m, n = x2.shape[0], nb * bn
    splits, per = prefill_split(m, n, G, _num_sms(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xb = (torch.empty(x2.shape, dtype=torch.bfloat16, device=x.device)
          if x.dtype != torch.bfloat16 else None)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.hv_int4_prefill(
            x2.data_ptr(), None if xb is None else xb.data_ptr(), w[layer_idx].data_ptr(),
            s[layer_idx].data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16), m, nb, G, half, bn, splits, per,
            torch.cuda.current_stream().cuda_stream)
    check(status, counter.__name__)
    counter.LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


def _transpose_geometry(dy, w, s, layer_idx, n_sm):
    """Check a B7 call; returns (m, NB, G, g/2, BN, (row tile, splits,
    stages per split)), the flat layout (L, G, g/2, n) as one tile of n
    columns."""
    flat, nb, G, half, bn = _int4_geometry(dy, w, s, layer_idx, "int4 transpose",
                                           transpose=True)
    if flat:
        nb, bn = 1, nb * bn
    if bn % 64 or half % 32 or (128 % half if half <= 128 else half % 128):
        raise ValueError(f"int4 transpose needs a tile width that is a multiple of 64 and a "
                         f"group of 64, 128 or a multiple of 256 rows, got {bn}, {2 * half}")
    m = math.prod(dy.shape[:-1])
    return m, nb, G, half, bn, transpose_plan(m, nb * bn, G * 2 * half, n_sm)


def _launch_transpose(dy, w, s, layer_idx, counter):
    from handsonvlm_torch.ops._build import check, load_library, refuse_grad

    refuse_grad(counter.__name__, dy)
    m, nb, G, half, bn, (rows, splits, per) = _transpose_geometry(
        dy, w, s, layer_idx, _num_sms(dy.device.index))
    dy2 = dy.reshape(m, nb * bn).contiguous()
    if dy2.data_ptr() % 16:  # TMA reads dy from 16-byte aligned rows
        dy2 = dy2.clone()
    d = G * 2 * half
    out = torch.empty((m, d), dtype=dy.dtype, device=dy.device)
    dyb = (torch.empty(dy2.shape, dtype=torch.bfloat16, device=dy.device)
           if dy.dtype != torch.bfloat16 else None)
    part = (torch.empty((splits, m, d), dtype=torch.float32, device=dy.device)
            if splits > 1 else None)
    lib = load_library()
    with torch.cuda.device(dy.device):
        status = lib.hv_int4_transpose(
            dy2.data_ptr(), None if dyb is None else dyb.data_ptr(), w[layer_idx].data_ptr(),
            s[layer_idx].data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), int(dy.dtype == torch.bfloat16), m, nb, G, half, bn, rows, splits,
            per, torch.cuda.current_stream().cuda_stream)
    check(status, counter.__name__)
    counter.LAUNCHES += 1
    return out.reshape(*dy.shape[:-1], d)


def _launch_int8(x, w8, scale, out_dtype, tensor_cores=None):
    from handsonvlm_torch.ops._build import check, load_library

    if x.dtype not in (torch.bfloat16, torch.float32) or out_dtype not in (x.dtype,
                                                                           torch.float32):
        raise TypeError(f"int8 matmul takes bf16 or f32 x and writes x's dtype or f32, "
                        f"got {x.dtype} -> {out_dtype}")
    if w8.dtype != torch.int8 or scale.dtype != torch.float32 or w8.dim() != 2:
        raise TypeError(f"int8 matmul takes int8 w8 (d, n) and f32 scales, got "
                        f"{w8.dtype} {tuple(w8.shape)} / {scale.dtype}")
    d, n = w8.shape
    if tuple(scale.shape) != (n,) or x.shape[-1] != d:
        raise ValueError(f"x (..., {x.shape[-1]}), w8 {tuple(w8.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit")
    if n % 16 or d % 8:
        raise ValueError(f"int8 matmul reads 16-byte runs of x and w8: n must be a multiple "
                         f"of 16 and d of 8, got d={d}, n={n}")
    if not (x.device == w8.device == scale.device):
        raise ValueError("x, w8 and scale must be on one device")
    if not (w8.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w8 and scale must be contiguous")
    x2 = x.reshape(-1, d).contiguous()
    m = x2.shape[0]
    if not 1 <= m < 65536 * 64:
        raise ValueError(f"int8 matmul takes 1..{65536 * 64 - 1} rows, got {m}")
    if tensor_cores is None:  # the dispatch; chip_smoke times both sides of it
        tensor_cores = x.dtype == torch.bfloat16 and m >= INT8_TC_MIN_M
    if tensor_cores and x.dtype != torch.bfloat16:
        raise TypeError("the int8 matmul runs only a bf16 x on the tensor cores")
    if tensor_cores:
        rows, splits, per = int8_tc_plan(m, d, n, _num_sms(x.device.index))
        part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
    else:
        # splits of the contraction in 64-row stages, sized for one row
        plan = int8_gemv_plan(m, d, n, _num_sms(x.device.index))
        rows, splits, per, part = 0, plan.splits, plan.per * GEMV_INT8_STAGE, None
        refusal = int8_gemv_refusal(m, d, n, splits, per)
        if refusal:
            raise ValueError(refusal)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.hv_int8_matmul(
            x2.data_ptr(), w8.data_ptr(), scale.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.float32),
            int(tensor_cores), m, d, n, splits, per, rows,
            torch.cuda.current_stream().cuda_stream)
    check(status, "int8_matmul")
    int8_matmul.LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


def _on_device(x, launch, ref, *args):
    if x.is_cuda:
        return launch(x, *args)
    if x.device.type == "cpu":
        return ref(x, *args)
    raise ValueError(f"no quantized matmul for device {x.device}")


class _FrozenWeightMatmul(torch.autograd.Function):
    """y = fwd(x) through a frozen quantized weight; dx = bwd(dy) cast to
    x's dtype. The weights and scales are constants of the closures: they
    get no gradient, as the JAX package gives its quantized leaves zero
    cotangents."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd, ctx.dtype = bwd, x.dtype
        return fwd(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.bwd(dy).to(ctx.dtype), None, None


def _with_grad(x, fwd, bwd):
    """fwd(x), differentiable in x through `bwd` under grad mode."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FrozenWeightMatmul.apply(x, fwd, bwd)
    return fwd(x)


def _int8_dx(dy, w8, scale, dtype):
    """dx = dy @ (w8 * scale)^T in plain torch: (dy * scale) rounded to x's
    dtype against the exact w8, f32 sums (exact in f32, as `jax.vjp` of the
    JAX package's XLA int8 dot)."""
    return (dy.float() * scale).to(dtype) @ w8.to(dtype).t()


def int8_matmul(x, w8, scale, out_dtype=torch.float32) -> torch.Tensor:
    """x (..., d) @ (w8 (d, n) int8 * scale (n,) f32) -> (..., n) in
    `out_dtype` (f32, as the JAX package returns, or x's dtype), f32
    accumulation (kernel B9: the GEMV, or a bf16 x of INT8_TC_MIN_M rows or
    more on the tensor cores). CUDA tensors run the Hopper kernel; CPU
    tensors the plain version. dx = dy @ (w8 * scale)^T in plain torch."""
    dtype = x.dtype  # the backward keeps the weights alone, never x itself
    return _with_grad(
        x, lambda x_: _on_device(x_, _launch_int8, int8_matmul_ref, w8, scale, out_dtype),
        lambda dy: _int8_dx(dy, w8, scale, dtype))


def int4_matmul_T_tiled(dy, w4t, gst, layer_idx) -> torch.Tensor:
    """dy (..., n) @ dequant(w4t[layer_idx])^T -> (..., d) in dy.dtype over
    the tiled layout (kernel B7b)."""
    return _on_device(dy, lambda *a: _launch_transpose(*a, int4_matmul_T_tiled),
                      int4_matmul_T_tiled_ref, w4t, gst, int(layer_idx))


def int4_matmul_T_flat(dy, w4, gscale, layer_idx) -> torch.Tensor:
    """dy (..., n) @ dequant(w4[layer_idx])^T -> (..., d) in dy.dtype over
    the flat stacked layout (kernel B7a: B7b's kernel with one tile of n
    columns)."""
    return _on_device(dy, lambda *a: _launch_transpose(*a, int4_matmul_T_flat),
                      int4_matmul_T_flat_ref, w4, gscale, int(layer_idx))


def int4_matmul_stacked_T(dy, w4, gscale, layer_idx) -> torch.Tensor:
    """dy (..., n) @ dequant(layer `layer_idx`)^T -> (..., d) over the tiled
    (5-D, B7b) or the flat (4-D, B7a) stacked layout: the input gradient of
    `int4_matmul_stacked`."""
    fn = int4_matmul_T_tiled if w4.dim() == 5 else int4_matmul_T_flat
    return fn(dy, w4, gscale, int(layer_idx))


def int4_matmul_stacked_T_ref(dy, w4, gscale, layer_idx) -> torch.Tensor:
    """The plain version of `int4_matmul_stacked_T` on any device."""
    fn = int4_matmul_T_tiled_ref if w4.dim() == 5 else int4_matmul_T_flat_ref
    return fn(dy, w4, gscale, int(layer_idx))


def _int4(x, w, s, layer_idx, fwd, bwd):
    """fwd(x, w, s, layer) over a stacked int4 layout, differentiable in x
    through bwd(dy, w, s, layer), the transpose product of the layout."""
    layer_idx = int(layer_idx)
    return _with_grad(x, lambda x_: fwd(x_, w, s, layer_idx),
                      lambda dy: bwd(dy, w, s, layer_idx))


def _int4_kernel(x, w, s, layer_idx, launch, ref):
    return _int4(x, w, s, layer_idx, lambda *a: _on_device(a[0], launch, ref, *a[1:]),
                 int4_matmul_stacked_T)


def int4_gemv_tiled(x, w4t, gst, layer_idx) -> torch.Tensor:
    """Decode-sized x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in
    x.dtype over the tiled layout (kernel B4b)."""
    return _int4_kernel(x, w4t, gst, layer_idx, lambda *a: _launch_gemv(*a, int4_gemv_tiled),
                        int4_gemv_tiled_ref)


def int4_gemv_flat(x, w4, gscale, layer_idx) -> torch.Tensor:
    """Decode-sized x (..., d) @ dequant(w4[layer_idx]) -> (..., n) in
    x.dtype over the flat stacked layout (kernel B4c: B4b's body over the
    flat address map, with the tile width of the same weight's tiled
    layout, so both give the same bits)."""
    return _int4_kernel(x, w4, gscale, layer_idx, lambda *a: _launch_gemv(*a, int4_gemv_flat),
                        int4_gemv_flat_ref)


def _int4_matmul_ref(x, w, s, i):
    return int4_matmul_ref(x, w[i], s[i])


def int4_matmul(x, w4, gscale) -> torch.Tensor:
    """x (..., d) @ dequant(w4 (G, g/2, n), gscale (G, n)) -> (..., n) in
    x.dtype, one flat matrix at any row count, as the JAX package runs it
    (kernel B4a: B4c's launch over a stack of one; its gradient B7a over
    the same stack)."""
    return _int4_kernel(x, w4[None], gscale[None], 0,
                        lambda x_, w, s, i: _launch_gemv(x_, w, s, i, int4_matmul),
                        _int4_matmul_ref)


def int4_matmul_prefill_tiled(x, w4t, gst, layer_idx) -> torch.Tensor:
    """Prefill-sized x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in
    x.dtype over the tiled layout (kernel B5b)."""
    return _int4_kernel(x, w4t, gst, layer_idx,
                        lambda *a: _launch_prefill(*a, int4_matmul_prefill_tiled),
                        int4_matmul_prefill_tiled_ref)


def int4_matmul_prefill(x, w4, gscale, layer_idx) -> torch.Tensor:
    """Prefill-sized x (..., d) @ dequant(w4[layer_idx]) -> (..., n) in
    x.dtype over the flat stacked layout (kernel B5a: B5b's kernel with one
    tile of n columns, the same bits as B5b on the same weight)."""
    return _int4_kernel(x, w4, gscale, layer_idx,
                        lambda *a: _launch_prefill(*a, int4_matmul_prefill),
                        int4_matmul_prefill_ref)


for _fn in (int8_matmul, int4_gemv_tiled, int4_gemv_flat, int4_matmul,
            int4_matmul_prefill_tiled, int4_matmul_prefill, int4_matmul_T_tiled,
            int4_matmul_T_flat):
    _fn.LAUNCHES = 0


def int4_matmul_stacked(x, w4, gscale, layer_idx, *, plain: bool = False) -> torch.Tensor:
    """x (..., d) @ dequant(layer `layer_idx`) over the tiled (5-D) or the
    flat (4-D) stacked layout: rows = prod(x.shape[:-1]) >=
    INT4_PREFILL_MIN_M go to the prefill matmul, fewer to the GEMV. `plain`
    runs the chosen op's plain version, and B7's as its backward, on any
    device (the reference path). Differentiable in x: dx =
    `int4_matmul_stacked_T(dy)` in x's dtype, as the JAX package's
    custom_vjp."""
    prefill = math.prod(x.shape[:-1]) >= INT4_PREFILL_MIN_M
    fn, ref = {(5, True): (int4_matmul_prefill_tiled, int4_matmul_prefill_tiled_ref),
               (5, False): (int4_gemv_tiled, int4_gemv_tiled_ref),
               (4, True): (int4_matmul_prefill, int4_matmul_prefill_ref),
               (4, False): (int4_gemv_flat, int4_gemv_flat_ref)}[(w4.dim(), prefill)]
    if plain:
        return _int4(x, w4, gscale, layer_idx, ref, int4_matmul_stacked_T_ref)
    return fn(x, w4, gscale, int(layer_idx))


def maybe_int8_matmul(x, w, *, plain: bool = False) -> torch.Tensor:
    """x @ w where w is a dense (d, n) tensor, an int8 {"w8", "scale"} leaf
    or a flat int4 {"w4", "gscale"} leaf (one layer's views), in x.dtype,
    as the JAX package's `maybe_int8_matmul`: w8 leaves go to B9, w4 leaves
    to B4a (their plain versions with `plain` or on CPU tensors)."""
    if isinstance(w, dict):
        if "w4" in w:
            if plain:
                return _int4(x, w["w4"][None], w["gscale"][None], 0, _int4_matmul_ref,
                             int4_matmul_stacked_T_ref)
            return int4_matmul(x, w["w4"], w["gscale"])
        return (int8_matmul_ref if plain else int8_matmul)(x, w["w8"], w["scale"], x.dtype)
    return x @ w
