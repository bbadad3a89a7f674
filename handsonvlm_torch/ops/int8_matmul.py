"""Weight-only int4 / int8 quantization and the int4 matmuls.

Port of the parts of `handsonvlm_tpu/ops/int8_matmul.py` that the int4
decode mode runs (`--int4`):

- `quantize_int8` / `quantize_lm_head`: per-column symmetric int8. Only the
  head uses it; `models/llama.lm_logits` consumes it in plain PyTorch, as
  the JAX package leaves it to XLA.
- `quantize_int4` / `unpack_int4` / `tile_int4_stacked`: group-wise
  symmetric int4 (group 128, gcd fallback for small dims), two nibbles per
  byte (row r of a group with row r + g/2; the low nibble biased by +8),
  re-laid out into contiguous (NB, G, g/2, BN) tiles per layer with BN
  frozen by `pick_block_n`. Bytes and scales are bit-identical to the JAX
  package's, so a checkpoint quantized by either package loads in the other.
- `int4_gemv_tiled` (kernel B4b, m < INT4_PREFILL_MIN_M rows) and
  `int4_matmul_prefill_tiled` (kernel B5b, m >= INT4_PREFILL_MIN_M): each
  launches its hand-written Hopper kernel (`csrc/int4_gemv.cu`,
  `csrc/int4_prefill.cu`) for CUDA tensors and runs its plain version
  (`*_ref`) for CPU tensors. There is no fallback: on a CUDA tensor a
  wrapper launches its kernel or raises. `<wrapper>.LAUNCHES` counts
  launches. `int4_matmul_stacked` dispatches on rows as the JAX package
  does (rows = B x T).

The two plain versions differ on purpose, as the two Pallas kernels do:
B4b's is the exact product (per-group f32 dot products, the f32 scale
applied to each group's partial sum); B5b's rounds x to bf16 and each
weight to bf16(bf16(nibble) x bf16(scale)) before an f32-accumulated
product.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

INT4_GROUP = 128  # contraction-group size of the int4 scales
INT4_PREFILL_MIN_M = 128  # rows from which the prefill matmul serves a projection
INT4_GEMV_BN = 512  # widest weight tile (columns) of the tiled layout


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


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


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


def int4_matmul_prefill_tiled_ref(x: torch.Tensor, w4t: torch.Tensor, gst: torch.Tensor,
                                  layer_idx: int) -> torch.Tensor:
    """x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in x.dtype with the
    Pallas prefill kernel's roundings: x to bf16, each weight to
    bf16(bf16(nibble) * bf16(scale)), f32 accumulation."""
    _, nb, G, half, bn = w4t.shape
    d = G * 2 * half
    x2 = x.reshape(-1, d).to(torch.bfloat16)
    p = w4t[layer_idx].to(torch.int32)  # (NB, G, g/2, BN)
    sc = gst[layer_idx].to(torch.bfloat16)[:, :, None, :]
    lo = ((p & 0x0F) - 8).to(torch.bfloat16) * sc
    hi = (p >> 4).to(torch.bfloat16) * sc
    w = torch.cat([lo, hi], dim=2).permute(1, 2, 0, 3).reshape(d, nb * bn)
    y = x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], nb * bn).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gemv_split(nb: int, groups: int, n_sm: int) -> Tuple[int, int]:
    """(splits, groups per split) of the contraction: enough blocks of
    (tile, split) to cover every SM about twice with one row. The row count
    does not enter: a row reduces over the same splits in the same order
    whether it comes alone or as row i of a verify window or a slot batch,
    so greedy speculative decode sees the logits of sequential decode."""
    want = min(groups, max(1, -(-2 * n_sm // nb)))
    per = -(-groups // want)
    return -(-groups // per), per


def _check_tiled(x, w4t, gst, layer_idx, what):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or f32 x, got {x.dtype}")
    if w4t.dtype != torch.int8 or gst.dtype != torch.float32 or w4t.dim() != 5:
        raise TypeError(f"{what} takes int8 (L, NB, G, g/2, BN) tiles and f32 "
                        f"scales, got {w4t.dtype} {tuple(w4t.shape)} / {gst.dtype}")
    L, nb, G, half, bn = w4t.shape
    if tuple(gst.shape) != (L, nb, G, bn):
        raise ValueError(f"scales {tuple(gst.shape)} do not fit tiles {tuple(w4t.shape)}")
    if x.shape[-1] != G * 2 * half:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {G * 2 * half}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range for L={L}")
    if not (x.device == w4t.device == gst.device):
        raise ValueError("x, w4t and gst must be on one device")
    if not (w4t.is_contiguous() and gst.is_contiguous()):
        raise ValueError("w4t and gst must be contiguous")


def _launch_gemv(x, w4t, gst, layer_idx):
    from handsonvlm_torch.ops._build import check, load_library

    _check_tiled(x, w4t, gst, layer_idx, "int4 gemv")
    _, nb, G, half, bn = w4t.shape
    if bn % 16 or bn > 16 * 256:
        raise ValueError(f"int4 gemv needs a tile width that is a multiple of 16 "
                         f"up to 4096, got {bn}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, n = x2.shape[0], nb * bn
    if not 1 <= m < 65536:
        raise ValueError(f"int4 gemv takes 1..65535 rows, got {m}")
    splits, per = gemv_split(nb, G, _num_sms(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.hv_int4_gemv(
            x2.data_ptr(), w4t[layer_idx].data_ptr(), gst[layer_idx].data_ptr(),
            part.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            m, nb, G, half, bn, splits, per, torch.cuda.current_stream().cuda_stream)
    check(status, "int4_gemv_tiled")
    int4_gemv_tiled.LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


def _launch_prefill(x, w4t, gst, layer_idx):
    from handsonvlm_torch.ops._build import check, load_library

    _check_tiled(x, w4t, gst, layer_idx, "int4 prefill")
    _, nb, G, half, bn = w4t.shape
    if bn % 64 or half % 8 or 2 * half > 128:
        raise ValueError(f"int4 prefill needs a tile width that is a multiple of 64 "
                         f"and a group of 16..128 in steps of 16, got {bn}, {2 * half}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, n = x2.shape[0], nb * bn
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.hv_int4_prefill(
            x2.data_ptr(), w4t[layer_idx].data_ptr(), gst[layer_idx].data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16), m, nb, G, half, bn,
            torch.cuda.current_stream().cuda_stream)
    check(status, "int4_matmul_prefill_tiled")
    int4_matmul_prefill_tiled.LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


def _dispatch(launch, ref, x, w4t, gst, layer_idx):
    layer_idx = int(layer_idx)
    if x.is_cuda:
        return launch(x, w4t, gst, layer_idx)
    if x.device.type == "cpu":
        return ref(x, w4t, gst, layer_idx)
    raise ValueError(f"no int4 matmul for device {x.device}")


def int4_gemv_tiled(x, w4t, gst, layer_idx) -> torch.Tensor:
    """Decode-sized x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in
    x.dtype (kernel B4b). CUDA tensors run the Hopper kernel; CPU tensors
    the plain version."""
    return _dispatch(_launch_gemv, int4_gemv_tiled_ref, x, w4t, gst, layer_idx)


def int4_matmul_prefill_tiled(x, w4t, gst, layer_idx) -> torch.Tensor:
    """Prefill-sized x (..., d) @ dequant(w4t[layer_idx]) -> (..., n) in
    x.dtype (kernel B5b). CUDA tensors run the Hopper kernel; CPU tensors
    the plain version."""
    return _dispatch(_launch_prefill, int4_matmul_prefill_tiled_ref, x, w4t, gst, layer_idx)


int4_gemv_tiled.LAUNCHES = 0
int4_matmul_prefill_tiled.LAUNCHES = 0


def int4_matmul_stacked(x, w4t, gst, layer_idx, *, plain: bool = False) -> torch.Tensor:
    """x (..., d) @ dequant(w4t[layer_idx]) over the tiled layout: rows =
    prod(x.shape[:-1]) >= INT4_PREFILL_MIN_M go to the prefill matmul,
    fewer to the GEMV. `plain` runs the chosen op's plain version on any
    device (the reference path)."""
    rows = math.prod(x.shape[:-1])
    if rows >= INT4_PREFILL_MIN_M:
        fn = int4_matmul_prefill_tiled_ref if plain else int4_matmul_prefill_tiled
    else:
        fn = int4_gemv_tiled_ref if plain else int4_gemv_tiled
    return fn(x, w4t, gst, int(layer_idx))
