"""A decode layer's whole MLP half in one kernel (kernel B11).

Port of `handsonvlm_tpu/ops/fused_decode.py`, as the JAX package holds it:
an op over a layer's tiled int4 MLP weights, gated off by `fused_mlp_ok`
(`HANDSONVLM_FUSED_MLP=1`) and wired into no decoder. For one layer and
B <= ROWS decode rows it computes rms_norm, the gate and up products,
silu(gate) * up, the down product and the residual:

- `fused_mlp_stacked` launches `csrc/fused_decode.cu` (one cooperative
  launch with one grid barrier between the gate/up and the down phase) for
  CUDA tensors and runs `fused_mlp_stacked_ref` for CPU tensors, no
  fallback; `fused_mlp_stacked.LAUNCHES` counts launches. It has no
  backward and raises under grad.
- `fused_mlp_stacked_ref` repeats the Pallas kernel's roundings: xn =
  bf16(h * rsqrt(mean(h^2) + eps) * nrm) in f32; each weight tile
  dequantized to bf16 as bf16(bf16(nibble) * bf16(scale)); f32 sums; act =
  bf16(silu(yg) * yu); the down product as one f32 product per gate tile,
  summed over the tiles in f32; plus h, cast to h's dtype.
- `split_wgu_tiled` re-tiles the fused gate|up leaf into separate gate and
  up leaves of 256-column tiles (the fused kernel pairs gate tile j with up
  tile j), bytes unchanged.

Leaves are JAX-style dicts {"w4t": (L, NB, G, 64, BN) int8, "gst": (L, NB,
G, BN) f32}, the tiled layout of `ops.int8_matmul.tile_int4_stacked`.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import torch
import torch.nn.functional as F

from handsonvlm_torch.ops.int8_matmul import _dequant_bf16, tile_int4_stacked, untile_int4_stacked

GROUP = 128  # int4 contraction-group size == llama head_dim
HALF = GROUP // 2
ROWS = 8  # the most decode rows one call serves


def _dequant_tiles(leaf: Mapping, layer_idx: int) -> torch.Tensor:
    """Layer `layer_idx` of a tiled leaf -> (NB, d, BN) bf16, each tile's
    rows in contraction order (the Pallas `_dequant_tile`)."""
    w4t, gst = leaf["w4t"][layer_idx], leaf["gst"][layer_idx]
    nb, G, half, bn = w4t.shape
    return _dequant_bf16(w4t, gst).reshape(nb, G * 2 * half, bn)


def fused_mlp_stacked_ref(hidden: torch.Tensor, nrm_scales: torch.Tensor, wg: Mapping,
                          wu: Mapping, wd: Mapping, layer_idx: int,
                          eps: float = 1e-6) -> torch.Tensor:
    """The MLP half of layer `layer_idx` for hidden (B, d) with the Pallas
    kernel's roundings -> (B, d) in hidden's dtype."""
    h = hidden.float()
    ms = (h * h).mean(dim=-1, keepdim=True)
    xn = (h * torch.rsqrt(ms + eps) * nrm_scales[layer_idx].float()).to(torch.bfloat16)
    x = xn.float()
    yg = torch.einsum("bd,jdc->bjc", x, _dequant_tiles(wg, layer_idx).float())
    yu = torch.einsum("bd,jdc->bjc", x, _dequant_tiles(wu, layer_idx).float())
    act = (F.silu(yg) * yu).to(torch.bfloat16)  # (B, NBf, BNf)
    nbf, bnf = act.shape[1:]
    wdq = _dequant_tiles(wd, layer_idx).float()  # (NBd, f, BNd)
    nbd, _, bnd = wdq.shape
    part = torch.einsum("bjc,kjcn->bjkn", act.float(), wdq.reshape(nbd, nbf, bnf, bnd))
    y = part.sum(dim=1).reshape(h.shape[0], nbd * bnd)
    return (y + h).to(hidden.dtype)


def _check(hidden, nrm_scales, wg, wu, wd, layer_idx):
    if hidden.dtype not in (torch.bfloat16, torch.float32) or hidden.dim() != 2:
        raise TypeError(f"fused_mlp_stacked takes bf16 or f32 rows (B, d), got "
                        f"{hidden.dtype} {tuple(hidden.shape)}")
    b, d = hidden.shape
    if not 1 <= b <= ROWS:
        raise ValueError(f"fused_mlp_stacked serves 1..{ROWS} decode rows, got {b}")
    L, nbf, gd, half, bnf = wg["w4t"].shape
    _, nbd, gf, _, bnd = wd["w4t"].shape
    f = nbf * bnf
    if half != HALF or gd * GROUP != d or gf * GROUP != f or nbd * bnd != d:
        raise ValueError(f"weights gate {tuple(wg['w4t'].shape)}, down "
                         f"{tuple(wd['w4t'].shape)} do not fit d={d} in groups of {GROUP}")
    if tuple(wu["w4t"].shape) != tuple(wg["w4t"].shape) or bnf % 64 or bnd % 64:
        raise ValueError("gate and up must share one tiling, and the tiles be multiples "
                         "of 64 columns")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range for L={L}")
    leaves = [leaf[k] for leaf in (wg, wu, wd) for k in ("w4t", "gst")]
    if any(t.device != hidden.device for t in leaves + [nrm_scales]):
        raise ValueError("fused_mlp_stacked: every operand must be on one device")
    if not all(t.is_contiguous() for t in leaves):
        raise ValueError("fused_mlp_stacked: the weights and scales must be contiguous")
    return b, d, f, bnf, bnd


def _launch(hidden, nrm_scales, wg, wu, wd, layer_idx, eps):
    from handsonvlm_torch.ops._build import check, load_library, refuse_grad

    refuse_grad("fused_mlp_stacked", hidden)
    b, d, f, bnf, bnd = _check(hidden, nrm_scales, wg, wu, wd, layer_idx)
    h = hidden.contiguous()
    nrm = nrm_scales[layer_idx].float().contiguous()
    act = torch.empty((ROWS, f), dtype=torch.bfloat16, device=h.device)
    out = torch.empty_like(h)
    lib = load_library()
    with torch.cuda.device(h.device):
        status = lib.hv_fused_mlp(
            h.data_ptr(), nrm.data_ptr(),
            *(leaf[k][layer_idx].data_ptr() for leaf in (wg, wu, wd) for k in ("w4t", "gst")),
            act.data_ptr(), out.data_ptr(), int(h.dtype == torch.bfloat16), b, d, f, bnf, bnd,
            float(eps), torch.cuda.current_stream().cuda_stream)
    check(status, "fused_mlp_stacked")
    fused_mlp_stacked.LAUNCHES += 1
    return out


def fused_mlp_stacked(hidden: torch.Tensor, nrm_scales: torch.Tensor, wg: Mapping,
                      wu: Mapping, wd: Mapping, layer_idx, eps: float = 1e-6) -> torch.Tensor:
    """One launch for the MLP half of decoder layer `layer_idx`: hidden (B,
    d) + down(silu(gate(xn)) * up(xn)), xn the rms-normed rows, over tiled
    int4 leaves wg / wu (from `split_wgu_tiled`) and wd (kernel B11)."""
    layer_idx = int(layer_idx)
    if hidden.is_cuda:
        return _launch(hidden, nrm_scales, wg, wu, wd, layer_idx, eps)
    if hidden.device.type == "cpu":
        return fused_mlp_stacked_ref(hidden, nrm_scales, wg, wu, wd, layer_idx, eps)
    raise ValueError(f"no fused MLP for device {hidden.device}")


fused_mlp_stacked.LAUNCHES = 0


def split_wgu_tiled(wgu: Mapping, f: int):
    """The fused tiled gate|up leaf -> separate tiled gate and up leaves
    with tiles of 256 columns (gcd(f, 256) where 256 does not divide f), so
    gate tile j pairs with up tile j; the bytes unchanged."""
    w4, gs = untile_int4_stacked(wgu["w4t"], wgu["gst"])
    bnf = 256 if f % 256 == 0 else math.gcd(f, 256)
    out = []
    for sl in (slice(0, f), slice(f, 2 * f)):
        w4t, gst = tile_int4_stacked(w4[..., sl].contiguous(), gs[..., sl].contiguous(), bnf)
        out.append({"w4t": w4t, "gst": gst})
    return out[0], out[1]


def fused_mlp_ok(int4_stacked: Mapping, d: int, t: int, b: int) -> bool:
    """Whether the fused MLP kernel serves this step: never unless
    HANDSONVLM_FUSED_MLP=1 (the JAX package's gate), then only a one-token
    step of at most ROWS rows over leaves carrying the separate gate / up
    tiling."""
    if os.environ.get("HANDSONVLM_FUSED_MLP") != "1":
        return False
    if t != 1 or b > ROWS:
        return False
    if not {"wg", "wu", "w_down"} <= set(int4_stacked):
        return False
    wg = int4_stacked["wg"]["w4t"]
    return (wg.dim() == 5 and wg.shape[3] == HALF and wg.shape[2] == d // GROUP
            and wg.shape[4] % GROUP == 0)
