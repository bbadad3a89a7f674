"""A decode layer's whole MLP half in one kernel (kernel B11).

Port of `handsonvlm_tpu/ops/fused_decode.py`, as the JAX package holds it:
an op over a layer's tiled int4 MLP weights, gated off by `fused_mlp_ok`
(`HANDSONVLM_FUSED_MLP=1`) and wired into no decoder. For one layer and
B <= ROWS decode rows it computes rms_norm, the gate and up products,
silu(gate) * up, the down product and the residual:

- `fused_mlp_stacked` runs `csrc/fused_decode.cu` for CUDA tensors (two
  launches a call on the GEMV's body, `fused_mlp_gate_up_kernel` then
  `fused_mlp_down_kernel`, the second a programmatic dependent launch that
  streams its first w_down stages before act is ready) and
  `fused_mlp_stacked_ref` for CPU tensors, no fallback;
  `fused_mlp_stacked.LAUNCHES` counts calls. It has no backward and raises
  under grad.
- `fused_mlp_plan` splits each phase's contraction (`gemv_split`, from the
  weights' shapes and the SM count alone, never the row count);
  `fused_mlp_refusal` mirrors the C entry point's argument rules.
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
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from handsonvlm_torch.ops.int8_matmul import (
    GEMV_COLS,
    GEMV_MAX_SPLITS,
    _dequant_bf16,
    _num_sms,
    gemv_split,
    tile_int4_stacked,
    untile_int4_stacked,
)

GROUP = 128  # int4 contraction-group size == llama head_dim
HALF = GROUP // 2
ROWS = 8  # the most decode rows one call serves
# a gate/up block's shared memory (csrc/fused_decode.cu): the ring and its
# barriers with 1 KB of alignment slack, then its split's xn, 256 bytes a
# group and row; at most SMEM_CAP bytes
UP_SMEM_FIXED = 6 * (2 * 64 * 128 + 2 * 4 * 128) + 2 * 6 * 8 + 1024
XN_GROUP_ROW = 256
SMEM_CAP = 227 * 1024 - 1024


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


class MlpPlan(NamedTuple):
    """B11's two launches: grids (splits, 1, blocks), clusters of splits."""
    blocks1: int  # gate/up column blocks of GEMV_COLS columns of f
    splits1: int  # splits of d (groups of GROUP rows)
    per1: int     # groups a gate/up split
    blocks2: int  # down column blocks of d
    splits2: int  # splits of f
    per2: int     # groups a down split


def fused_mlp_plan(d: int, f: int, bnf: int, bnd: int, n_sm: int) -> MlpPlan:
    """Each phase's splits by `gemv_split` (the GEMV's rule: the fewest that
    make 5/8 of the SMs' worth of blocks), gate/up with at least as many as
    let a split's xn of ROWS rows fit a block's shared memory. The row count
    does not enter, so a row sums in the same order alone or among 8."""
    blocks1 = (f // bnf) * -(-bnf // GEMV_COLS)
    blocks2 = (d // bnd) * -(-bnd // GEMV_COLS)
    gd, gf = d // GROUP, f // GROUP
    splits1, per1 = gemv_split(blocks1, gd, n_sm)
    per_fit = max(1, (SMEM_CAP - UP_SMEM_FIXED) // (XN_GROUP_ROW * ROWS))
    if per1 > per_fit:
        splits1 = -(-gd // per_fit)
        per1 = -(-gd // splits1)
    return MlpPlan(blocks1, splits1, per1, blocks2, *gemv_split(blocks2, gf, n_sm))


def _covers(units: int, splits: int, per: int) -> bool:
    return (1 <= splits <= GEMV_MAX_SPLITS and per >= 1 and (splits - 1) * per < units
            <= splits * per)


def fused_mlp_refusal(b: int, d: int, f: int, bnf: int, bnd: int,
                      plan: MlpPlan) -> Optional[str]:
    """Why `hv_fused_mlp` (csrc/fused_decode.cu) would refuse these
    arguments, its checks mirrored; None if it takes them."""
    if not 1 <= b <= ROWS:
        return f"{b} rows: B11 takes 1..{ROWS}"
    if d < GROUP or d % GROUP or f < GROUP or f % GROUP:
        return f"d={d}, f={f}: B11 takes multiples of {GROUP}"
    if bnf < 64 or bnf % 64 or f % bnf or bnd < 64 or bnd % 64 or d % bnd:
        return f"tiles of {bnf} / {bnd} columns: multiples of 64 dividing f={f} / d={d}"
    if not _covers(d // GROUP, plan.splits1, plan.per1):
        return f"{plan.splits1} splits of {plan.per1} do not cover {d // GROUP} groups once"
    if not _covers(f // GROUP, plan.splits2, plan.per2):
        return f"{plan.splits2} splits of {plan.per2} do not cover {f // GROUP} groups once"
    if UP_SMEM_FIXED + plan.per1 * XN_GROUP_ROW * b > SMEM_CAP:
        return f"{plan.per1} groups of xn for {b} rows exceed a block's shared memory"
    return None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernel's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(hidden, nrm_scales, wg, wu, wd, layer_idx, eps, parts=3, act=None):
    from handsonvlm_torch.ops._build import check, load_library, refuse_grad

    refuse_grad("fused_mlp_stacked", hidden)
    b, d, f, bnf, bnd = _check(hidden, nrm_scales, wg, wu, wd, layer_idx)
    h = _aligned(hidden.contiguous())
    nrm = nrm_scales[layer_idx]
    if nrm.dtype not in (torch.bfloat16, torch.float32):
        nrm = nrm.float()
    nrm = _aligned(nrm.contiguous())
    plan = fused_mlp_plan(d, f, bnf, bnd, _num_sms(h.device.index or 0))
    refusal = fused_mlp_refusal(b, d, f, bnf, bnd, plan)
    if refusal:
        raise ValueError(f"fused_mlp_stacked: {refusal}")
    if act is None:
        act = torch.empty((b, f), dtype=torch.bfloat16, device=h.device)
    elif (act.shape != (b, f) or act.dtype != torch.bfloat16 or act.device != h.device
          or not act.is_contiguous()):
        raise ValueError(f"fused_mlp_part: act must be ({b}, {f}) bf16 on {h.device}, got "
                         f"{act.dtype} {tuple(act.shape)}")
    act = _aligned(act)
    out = torch.empty_like(h)
    lib = load_library()
    with torch.cuda.device(h.device):
        status = lib.hv_fused_mlp(
            h.data_ptr(), nrm.data_ptr(),
            *(leaf[k][layer_idx].data_ptr() for leaf in (wg, wu, wd) for k in ("w4t", "gst")),
            act.data_ptr(), out.data_ptr(), int(h.dtype == torch.bfloat16),
            int(nrm.dtype == torch.bfloat16), b, d, f, bnf, bnd, plan.splits1, plan.per1,
            plan.splits2, plan.per2, float(eps), parts, torch.cuda.current_stream().cuda_stream)
    check(status, "fused_mlp_stacked")
    if parts == 3:
        fused_mlp_stacked.LAUNCHES += 1
    return act if parts == 1 else out


def fused_mlp_stacked(hidden: torch.Tensor, nrm_scales: torch.Tensor, wg: Mapping,
                      wu: Mapping, wd: Mapping, layer_idx, eps: float = 1e-6) -> torch.Tensor:
    """One call (two launches) for the MLP half of decoder layer
    `layer_idx`: hidden (B, d) + down(silu(gate(xn)) * up(xn)), xn the
    rms-normed rows, over tiled int4 leaves wg / wu (from `split_wgu_tiled`)
    and wd (kernel B11)."""
    layer_idx = int(layer_idx)
    if hidden.is_cuda:
        return _launch(hidden, nrm_scales, wg, wu, wd, layer_idx, eps)
    if hidden.device.type == "cpu":
        return fused_mlp_stacked_ref(hidden, nrm_scales, wg, wu, wd, layer_idx, eps)
    raise ValueError(f"no fused MLP for device {hidden.device}")


fused_mlp_stacked.LAUNCHES = 0


def fused_mlp_part(hidden: torch.Tensor, nrm_scales: torch.Tensor, wg: Mapping, wu: Mapping,
                   wd: Mapping, layer_idx, eps: float, part: int,
                   act: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One of B11's two kernels alone, for the tests and chip_smoke.py's
    timing: part 1 (gate/up) returns act (B, f) bf16, part 2 (down) takes
    act and returns hidden + act @ down. CUDA tensors only; not counted in
    `fused_mlp_stacked.LAUNCHES`."""
    if part not in (1, 2) or not hidden.is_cuda or (part == 2) != (act is not None):
        raise ValueError("fused_mlp_part runs part 1 (no act) or part 2 (act given) of B11 "
                         "on CUDA tensors")
    return _launch(hidden, nrm_scales, wg, wu, wd, int(layer_idx), eps, parts=part, act=act)


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
