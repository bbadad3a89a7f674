"""Tensor parallelism: each rank runs the port's kernels on its shard.

Port of `handsonvlm_tpu/parallel/tp.py` (decode) and of the JAX package's
('data', 'model') training layout (`parallel/partition.py`, GSPMD over
`model`). The JAX package splits the operands of its Pallas kernels over
the mesh's `model` axis with `shard_map`; here every rank of a `TPGroup`
holds plain local slices of the weights (and at decode of the KV cache) and
runs the unsharded wrapper on them, so the hand-written kernels run
unchanged on ordinary tensors:

- attention (B1, B6 at decode; B3 / B3b in training): query heads and kv
  heads split over the ranks, H/tp and K/tp each, the GQA ratio kept, no
  collective inside the kernel;
- int4 projections (B4b / B4c at decode, B5b / B5a from 128 rows, B7b /
  B7a for their input gradient): output columns split over the ranks,
  tiled weights on their NB tile axis, flat ones on their column axis, the
  activation replicated.

The fused int4 wqkv / wgu are cut over their full concatenated width, so a
shard edge can fall inside q / k / v (JAX `tp.py:17-22`): every
column-parallel output is all-gathered before its next use, as GSPMD
reshards there, and so is the head-parallel attention output that feeds
the column-parallel wo. `shard_llama_tp` cuts the dense decoder and the
per-projection int8 leaves ("int8", "int8_fused": B9, B10a / B10b)
Megatron-style instead: q / k / v / gate / up by output columns (whole
heads), o / down by input rows, each row-parallel product summed over the
ranks by an f32 all-reduce, so a layer costs two collectives. The
embedding, the head (32101 rows divide no rank count), the norms, CLIP, the
projector and the CVAE head stay whole on every rank.

Training runs through the same cuts (`shard_for_training`): the slices keep
`requires_grad`, and every collective is an autograd Function, Megatron's
pair and two reshards:

- `copy_to_model` (f): identity forward, dx all-reduced over the group in
  f32 backward; in front of a product whose weight is cut by columns (a
  projection left whole already has the whole dx);
- `reduce_from_model` (g): f32 all-reduce forward, identity backward; the
  row-parallel partial sums;
- `gather_last`: all-gather forward, this rank's slice of dy backward; the
  int4 column route's outputs and the head-parallel attention output;
- `split_dim`: this rank's slice forward, all-gather backward; the heads a
  rank attends of q / k / v that every rank holds whole (the int4 route).

LoRA adapters are cut with their base (`shard_lora_tp`): a column target's
b by output columns with a whole, a row target's a by input rows with b
whole; the row target's term is added to its base's f32 partial before the
reduce. Each rank's product then gives its whole factor (the column
target's a, the row target's b) a partial gradient, which
`partition.sync_replicated_grads` sums over the group once a step (the
fused B10a computes x @ a inside its kernel, so the factor cannot sit on
the replicated side of f). Over the int4 base, whose projections are
gathered whole, the adapters stay whole and run on the replicated side.

A shard is made only under the JAX package's conditions (`heads_shard`,
`int4_shard_ok`: `tp.py:71`, `:131`, `:185-197`) and, for int8 slices,
B9's and B10's shape rules (`int8_shard_ok`); a weight or cache that does
not meet them stays whole and runs the unsharded kernel on every rank, and
`shard_llama_tp` logs each such fallback (at 7B with tp = 2 or 4: the
tiled wgu, 43 tiles). The ops take this rank's shard and the group
(`tp=None`: the whole tensors, no collective). Every packed byte of a shard
is the matching slice of the full model's, so a checkpoint quantized by
either package loads; `model_cuts` lists what was cut so that
`partition.full_state_dict` and the optimizer gather checkpoints back to
the one-rank layout.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from handsonvlm_torch.ops.decode_attention import (
    decode_attention_stacked,
    decode_attention_stacked_q,
)
from handsonvlm_torch.ops.int8_matmul import int4_matmul_stacked

log = logging.getLogger(__name__)

GEMV_LANES = 128  # a flat shard's columns must be a multiple of this on the card
COLLECTIVES = 0  # collectives issued by this module (all-gathers, all-reduces, broadcasts)


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The ranks of one tensor-parallel group: this rank's place in it, its
    size and its process group (None: the default group)."""

    rank: int
    size: int
    group: Optional[dist.ProcessGroup] = None

    @classmethod
    def world(cls) -> "TPGroup":
        """Every rank of the default process group."""
        return cls(dist.get_rank(), dist.get_world_size(), None)


def tp_size(tp: Optional[TPGroup]) -> int:
    """Size of the tensor-parallel group (1 without one)."""
    return 1 if tp is None else int(tp.size)


# ---------------------------------------------------------------------------
# When a shard is made (the JAX package's conditions)
# ---------------------------------------------------------------------------


def heads_shard(num_heads: int, kv_heads: int, tp: int) -> bool:
    """Query and kv heads split over `tp` ranks (JAX `tp.py:71`, `:131`)."""
    return tp > 1 and num_heads % tp == 0 and kv_heads % tp == 0


def int4_shard_ok(w_shape, tp: int, on_card: bool = True) -> bool:
    """A stacked int4 weight of full shape `w_shape` splits over `tp` ranks
    (JAX `tp.py:185-197`): the tiled layout (L, NB, G, g/2, BN) when tp
    divides NB; the flat one (L, G, g/2, n) when tp divides n and, on the
    card, each shard keeps a multiple of 128 columns (the JAX package's
    lane rule, which its interpret mode drops: `on_card=False`)."""
    if tp <= 1:
        return False
    if len(w_shape) == 5:
        return w_shape[1] % tp == 0
    n = w_shape[-1]
    return n % tp == 0 and (not on_card or (n // tp) % GEMV_LANES == 0)


def int8_shard_ok(din: int, dout: int, tp: int, rows: bool) -> bool:
    """An int8 (din, dout) projection splits over `tp` ranks, by input rows
    (`rows`) or output columns, when each slice keeps B9's and B10's shape
    rule: 16 | its columns and 8 | its rows (they read 16-byte runs)."""
    if tp <= 1:
        return False
    d, n = (din // tp, dout) if rows else (din, dout // tp)
    return (din if rows else dout) % tp == 0 and n % 16 == 0 and d % 8 == 0


def shard_int4_stacked(w: torch.Tensor, s: torch.Tensor, rank: int, tp: int,
                       on_card: Optional[bool] = None):
    """Rank `rank`'s (weights, scales) of a stacked int4 projection, the
    contiguous slice of the full layout: NB tiles of the tiled one, columns
    of the flat one; None when `int4_shard_ok` refuses (the rank then keeps
    the whole weight)."""
    on_card = w.is_cuda if on_card is None else on_card
    if not int4_shard_ok(tuple(w.shape), tp, on_card):
        return None
    if w.dim() == 5:
        nb = w.shape[1] // tp
        return (w[:, rank * nb:(rank + 1) * nb].contiguous(),
                s[:, rank * nb:(rank + 1) * nb].contiguous())
    n = w.shape[-1] // tp
    return (w[..., rank * n:(rank + 1) * n].contiguous(),
            s[..., rank * n:(rank + 1) * n].contiguous())


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _count(n: int = 1) -> None:
    global COLLECTIVES
    COLLECTIVES += n


def all_gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """This rank's slice of the last dimension -> the whole, rank-major (the
    resharding GSPMD inserts after a column-parallel op)."""
    _count()
    x = x.reshape(1, *x.shape).contiguous()
    out = torch.empty((tp.size, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=tp.group)
    return torch.movedim(out, 0, -2).reshape(*x.shape[1:-1], tp.size * x.shape[-1])


def gather_dim(x: torch.Tensor, tp: TPGroup, dim: int) -> torch.Tensor:
    """`all_gather_last` along dimension `dim`."""
    dim = dim % x.dim()
    return torch.movedim(all_gather_last(torch.movedim(x, dim, -1), tp), -1, dim)


def slice_dim(x: torch.Tensor, tp: TPGroup, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/tp of `x` along `dim` (a view)."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


def all_reduce_f32(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of `x` over the group, in f32 (a new tensor)."""
    _count()
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=tp.group)
    return y


def broadcast_from_first(tensors, tp: TPGroup):
    """Every rank takes the group's first rank's values of `tensors`."""
    _count(len(tensors))
    src = dist.get_global_rank(tp.group, 0) if tp.group is not None else 0
    out = []
    for t in tensors:
        t = t.contiguous()
        dist.broadcast(t, src, group=tp.group)
        out.append(t)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: y = x; dx = the sum of dy over the group (f32, one
    rounding to dy's dtype)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_f32(dy, ctx.tp).to(dy.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: y = the f32 sum of the partials x over the group; dx =
    dy (every rank's partial moves the sum alike)."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_f32(x, tp)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherLast(torch.autograd.Function):
    """y = the ranks' slices of the last dimension, whole; dx = this rank's
    slice of dy (dy is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, dy):
        return slice_dim(dy, ctx.tp, -1).contiguous(), None


class _SplitDim(torch.autograd.Function):
    """y = this rank's slice of x (whole on every rank) along `dim`; dx =
    the ranks' slices of dy gathered."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return slice_dim(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return gather_dim(dy.contiguous(), ctx.tp, ctx.dim), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """x in front of a column-cut product: under autograd its gradient is
    summed over the group (no collective in the forward)."""
    if tp_size(tp) == 1 or not _tracked(x):
        return x
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The f32 sum of this rank's partial `x` over the group."""
    if tp_size(tp) == 1:
        return x
    return _ReduceFromModel.apply(x, tp) if _tracked(x) else all_reduce_f32(x, tp)


def gather_last(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """`all_gather_last`, differentiable (dx: this rank's slice of dy)."""
    if tp_size(tp) == 1:
        return x
    return _GatherLast.apply(x, tp) if _tracked(x) else all_gather_last(x, tp)


def split_dim(x: torch.Tensor, tp: Optional[TPGroup], dim: int) -> torch.Tensor:
    """This rank's slice of `x` along `dim`, differentiable (dx: gathered)."""
    if tp_size(tp) == 1:
        return x
    return _SplitDim.apply(x, tp, dim) if _tracked(x) else slice_dim(x, tp, dim)


# ---------------------------------------------------------------------------
# The ops (each rank's shard through the unsharded wrapper)
# ---------------------------------------------------------------------------


def local_heads(x: torch.Tensor, tp: TPGroup, dim: int = -2) -> torch.Tensor:
    """This rank's 1/tp of the heads of `x` along `dim` (differentiable)."""
    return split_dim(x, tp, dim)


def head_parallel(attend: Callable[[torch.Tensor], torch.Tensor], q: torch.Tensor,
                  tp: Optional[TPGroup]) -> torch.Tensor:
    """attend(this rank's query heads) over its own kv heads, the outputs
    of the group's ranks gathered back into every head (q (B, T, H, D) or
    (B, H, D))."""
    if tp_size(tp) == 1:
        return attend(q)
    if q.shape[-2] % tp.size:
        raise ValueError(f"{q.shape[-2]} query heads do not split over {tp.size} ranks")
    out = attend(local_heads(q, tp))
    d = out.shape[-1]
    full = gather_last(out.reshape(*out.shape[:-2], -1), tp)
    return full.reshape(*out.shape[:-2], tp.size * out.shape[-2], d)


def decode_attention_stacked_tp(q, ck, cv, layer_idx, length, *, key_mask=None,
                                blocks=None, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Head-sharded decode attention (kernel B1) over one layer of the
    stacked cache. q (B, T<=8, H, D) or (B, H, D) holds every head; ck / cv
    (L, B, S, K/tp, D) are this rank's kv heads (the whole cache with
    `tp=None`). Each rank attends its H/tp query heads; the output has all."""
    return head_parallel(
        lambda q_: decode_attention_stacked(q_, ck, cv, layer_idx, length,
                                            key_mask=key_mask, blocks=blocks), q, tp)


def decode_attention_stacked_q_tp(q, ck, cv, ks, vs, layer_idx, length, *, key_mask=None,
                                  blocks=None, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """`decode_attention_stacked_tp` over the int8 cache (kernel B6): the
    cache and its per-(token, kv head) scales (L, B, K/tp, S) hold this
    rank's kv heads."""
    return head_parallel(
        lambda q_: decode_attention_stacked_q(q_, ck, cv, ks, vs, layer_idx, length,
                                              key_mask=key_mask, blocks=blocks), q, tp)


def int4_matmul_stacked_tp(x, w4, gs, layer_idx, *, tp: Optional[TPGroup] = None,
                           plain: bool = False) -> torch.Tensor:
    """Column-parallel stacked int4 matmul: x (..., d) replicated, w4 / gs
    this rank's shard (`shard_int4_stacked`), the output's columns
    all-gathered from the ranks (`tp=None`: the whole weight, no
    collective). The op's dispatch is `int4_matmul_stacked`'s: B4b / B4c
    below 128 rows, B5b / B5a from there; under autograd its input
    gradient (B7b / B7a on this rank's columns) is summed over the group."""
    if tp_size(tp) == 1:
        return int4_matmul_stacked(x, w4, gs, layer_idx, plain=plain)
    y = int4_matmul_stacked(copy_to_model(x, tp), w4, gs, layer_idx, plain=plain)
    return gather_last(y, tp)


class _F32Linear(torch.autograd.Function):
    """y = x @ w^T with f32 output from bf16 operands (`torch.mm`'s
    out_dtype form, which autograd cannot differentiate); backward in the
    operands' dtype, as nn.Linear's: dy rounded once, f32 sums."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        g = dy.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = (g.t() @ x).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def linear_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., din) @ weight (dout, din)^T with f32 sums and an f32 result
    (no rounding of a partial product), differentiable."""
    flat = x.reshape(-1, x.shape[-1])
    if flat.is_cuda and flat.dtype != torch.float32:
        y = _F32Linear.apply(flat, weight)
    else:
        y = flat.float() @ weight.float().t()
    return y.reshape(*x.shape[:-1], weight.shape[0])


def reduce_partial(y: torch.Tensor, tp: Optional[TPGroup], dtype,
                   extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's partial `y` (and `extra`, a LoRA term's partial) summed
    over the group in f32, rounded once to `dtype`."""
    y = y.float() if extra is None else y.float() + extra.float()
    return reduce_from_model(y, tp).to(dtype)


# ---------------------------------------------------------------------------
# A rank's shard of a decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TPLayout:
    """What `shard_llama_tp` cut: this rank, the group size, whether the
    heads (attention weights and KV cache) and the MLP split, each int4
    projection's split, each int8 projection's split (`int8`: by its
    group), the fallbacks (whole on every rank), and `cuts`, the decoder's
    state-dict keys that were sliced, each with the dimension it was
    sliced on."""

    rank: int
    size: int
    heads: bool
    mlp: bool
    int4: Dict[str, bool]
    fallbacks: List[str]
    int8: Dict[str, bool] = dataclasses.field(default_factory=dict)
    cuts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def kv_heads(self, kv_heads: int) -> int:
        """A rank's kv heads in its cache."""
        return kv_heads // self.size if self.heads else kv_heads


def _keep(mod: nn.Module, name: str, value: torch.Tensor, trainable: bool = False) -> None:
    old = getattr(mod, name)
    if isinstance(old, nn.Parameter):
        setattr(mod, name, nn.Parameter(value.contiguous(),
                                        requires_grad=trainable and old.requires_grad))
    else:
        setattr(mod, name, value.contiguous())


# Megatron's cuts: a column target by its output, a row target by its input
HEAD_PROJ = {"wq": "col", "wk": "col", "wv": "col", "wo": "row"}
MLP_PROJ = {"w_gate": "col", "w_up": "col", "w_down": "row"}


def _cut(mod: nn.Module, name: str, dim: int, rank: int, tp: int, trainable: bool,
         key: str, cuts: Dict[str, int]) -> None:
    t = getattr(mod, name)
    n = t.shape[dim] // tp
    _keep(mod, name, t.narrow(dim, rank * n, n), trainable)
    cuts[key] = dim


@torch.no_grad()
def shard_llama_tp(llama, cfg, rank: int, tp: int, *, trainable: bool = False) -> "nn.Module":
    """Cut a whole decoder (`models.llama.Llama`, dense, "int4" /
    "int4_flat", "int8" or "int8_fused") into rank `rank`'s shard of a
    `tp`-rank group, in place, and record what was cut (`llama.tp_layout`,
    a `TPLayout`):

    - tiled int4 weights on NB, flat int4 on columns, each only where
      `int4_shard_ok` allows (else whole, logged);
    - dense q / k / v / gate / up by output rows of their HF weights (whole
      heads), o / down by input columns, where `heads_shard` (attention) or
      tp | intermediate (MLP) allows (else whole, logged);
    - the int8 leaves (w8 (L, din, dout), scale (L, dout)) the same way:
      q / k / v / gate / up by output columns, their scales with them, o /
      down by input rows, their per-column scales whole; a group (the
      attention's four, the MLP's three) whose slices miss `int8_shard_ok`
      stays whole (logged);
    - the KV cache a rank builds then holds its K/tp kv heads
      (`TPLayout.kv_heads`).

    The embedding, the norms and the head stay whole. `trainable` keeps
    each sliced parameter's `requires_grad` (a training cut: the
    collectives around the products are then autograd Functions); a decode
    cut freezes the slices. The per-projection flat int4 layout
    ("int4_proj") has no tensor-parallel route and raises."""
    if llama.quantize == "int4_proj":
        raise ValueError("quantize='int4_proj' has no tensor-parallel route (the JAX "
                         "package runs its flat int4 leaves replicated): decode it on one rank")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a group of {tp}")
    h, k, hd, f = cfg.num_heads, cfg.kv_heads, cfg.head_dim_, cfg.intermediate_size
    heads = heads_shard(h, k, tp)
    mlp = tp > 1 and f % tp == 0
    fallbacks: List[str] = []
    if tp > 1 and not heads:
        fallbacks.append(f"heads: {h} query / {k} kv heads do not split over {tp} ranks")
    if tp > 1 and not mlp and llama.int4 is None:
        fallbacks.append(f"mlp: intermediate {f} does not split over {tp} ranks")
    int4, int8, cuts = {}, {}, {}
    if llama.int4 is not None:
        for name, w in llama.int4.items():
            wt, st = w.packed()
            part = shard_int4_stacked(wt, st, rank, tp)
            int4[name] = part is not None
            if part is None:
                if tp > 1:
                    axis = f"NB={wt.shape[1]}" if wt.dim() == 5 else f"n={wt.shape[-1]}"
                    fallbacks.append(f"int4 {name} ({'tiled' if wt.dim() == 5 else 'flat'}, "
                                     f"{axis}) does not split over {tp} ranks")
                continue
            names = [n for n, _ in w.named_buffers()]
            dims = (1, 1) if wt.dim() == 5 else (3, 2)  # NB tiles, or flat columns
            for n, t, dim in zip(names, part, dims):
                setattr(w, n, t)
                cuts[f"int4.{name}.{n}"] = dim
    elif llama.proj is not None:
        from handsonvlm_torch.models.llama import projection_shapes

        shapes = projection_shapes(cfg)
        for group, table in (("heads", HEAD_PROJ), ("mlp", MLP_PROJ)):
            split = heads if group == "heads" else mlp
            bad = [n for n, kind in table.items()
                   if not int8_shard_ok(*shapes[n], tp, rows=kind == "row")]
            if tp > 1 and split and bad:
                fallbacks.append(f"int8 {group} ({', '.join(bad)}): a slice misses B9 / B10's "
                                 "16 | columns, 8 | rows")
            split = split and not bad
            for n, kind in table.items():
                int8[n] = split
                if split:
                    w = llama.proj[n]
                    _cut(w, "w8", 1 if kind == "row" else 2, rank, tp, False,
                         f"proj.{n}.w8", cuts)
                    if kind == "col":
                        _cut(w, "scale", 1, rank, tp, False, f"proj.{n}.scale", cuts)
        heads, mlp = int8["wq"], int8["w_gate"]
    else:
        for i, lp in enumerate(llama.layers):
            a, m = lp.self_attn, lp.mlp
            pre = f"layers.{i}"
            for on, sub, mod in ((heads, "self_attn", a), (mlp, "mlp", m)):
                if not on:
                    continue
                for lin in (("q_proj", "k_proj", "v_proj", "o_proj") if sub == "self_attn"
                            else ("gate_proj", "up_proj", "down_proj")):
                    dim = 1 if lin in ("o_proj", "down_proj") else 0
                    _cut(getattr(mod, lin), "weight", dim, rank, tp, trainable,
                         f"{pre}.{sub}.{lin}.weight", cuts)
    for msg in fallbacks:
        log.warning("tensor parallel (rank %d of %d): %s; it runs unsharded on every rank",
                    rank, tp, msg)
    llama.tp_layout = TPLayout(rank, tp, heads, mlp, int4, fallbacks, int8, cuts)
    llama.tp_cuts = cuts
    return llama


@torch.no_grad()
def shard_lora_tp(lora, layout: TPLayout, int4: bool = False, group: Optional[TPGroup] = None):
    """Cut `models.lora.LoRA` adapters in place for the decoder shard
    `layout`: a column target's b on its output (dim 2), a row target's a
    on its input (dim 1), for the groups `layout` cuts; over an int4 base
    (its outputs gathered whole) nothing. Records `lora.tp_cuts`
    {state-dict key: dim}, `lora.tp_partial` (the whole factors whose
    gradient each rank holds a partial sum of), `lora.tp_for` (rank, size)
    and `lora.tp_group`."""
    cuts, partial = {}, []
    for on, table in ((layout.heads, HEAD_PROJ), (layout.mlp, MLP_PROJ)):
        if int4 or not on or layout.size == 1:
            continue
        for t, kind in table.items():
            if t in lora.adapters:
                cut, whole = ("b", "a") if kind == "col" else ("a", "b")
                _cut(lora.adapters[t], cut, 2 if kind == "col" else 1, layout.rank,
                     layout.size, True, f"adapters.{t}.{cut}", cuts)
                partial.append(f"adapters.{t}.{whole}")
    lora.tp_cuts = cuts
    lora.tp_partial = partial
    lora.tp_for = (layout.rank, layout.size)
    lora.tp_group = group
    return lora


def shard_for_training(model, cfg, tp: TPGroup) -> TPLayout:
    """Cut a whole `HandsOnVLM` (its decoder, dense or QLoRA-quantized, and
    its LoRA adapters when attached) into this rank's training shard of
    the model group `tp`, in place: `shard_llama_tp(trainable=True)` and
    `shard_lora_tp`, the group recorded on each (`tp_group`) for the
    gathers of a checkpoint. Returns the decoder's `TPLayout`."""
    shard_llama_tp(model.llama, cfg.llama, tp.rank, tp.size, trainable=True)
    model.llama.tp_group = tp
    if getattr(model, "lora", None) is not None:
        shard_lora_tp(model.lora, model.llama.tp_layout, model.llama.int4 is not None, tp)
    return model.llama.tp_layout


def model_cuts(module: nn.Module) -> Dict[str, Tuple[int, TPGroup]]:
    """{state-dict key of `module`: (dimension, group)} of every tensor a
    training cut sliced over a model group (`shard_for_training`)."""
    out = {}
    for prefix, sub in module.named_modules():
        cuts, group = getattr(sub, "tp_cuts", None), getattr(sub, "tp_group", None)
        if cuts and group is not None:
            for key, dim in cuts.items():
                out[f"{prefix}.{key}" if prefix else key] = (dim, group)
    return out


def check_layout(llama, tp: Optional[TPGroup]):
    """The decoder's `TPLayout` for a call with group `tp` (None without
    one); raises when the decoder was not cut for this rank of this group."""
    layout = getattr(llama, "tp_layout", None)
    if tp_size(tp) == 1:
        if layout is not None and layout.size > 1:
            raise ValueError(f"this decoder is rank {layout.rank}'s shard of {layout.size}: "
                             "call it with its TPGroup (the continuous engine, the HTTP "
                             "stack and speculative decode take none: they run whole "
                             "models on one rank)")
        return None
    if layout is None or (layout.rank, layout.size) != (tp.rank, tp.size):
        have = None if layout is None else (layout.rank, layout.size)
        raise ValueError(f"the decoder is not cut for rank {tp.rank} of {tp.size} (its shard: "
                         f"{have}); run shard_llama_tp first")
    return layout
