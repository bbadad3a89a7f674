"""Tensor-parallel decode: each rank runs the port's kernels on its shard.

Port of `handsonvlm_tpu/parallel/tp.py`. The JAX package splits the
operands of its Pallas kernels over the mesh's `model` axis with
`shard_map`; here every rank of a `TPGroup` holds its shard of the weights
and of the KV cache (`shard_llama_tp`) and runs the unsharded wrapper on it:

- decode attention (B1, B6): query heads and kv heads split over the ranks,
  H/tp and K/tp each, the GQA ratio kept, no collective inside the kernel;
- int4 projections (B4b / B4c at decode, B5b / B5a from 128 rows, the
  dispatch of `int4_matmul_stacked`): output columns split over the ranks,
  tiled weights on their NB tile axis, flat ones on their column axis, the
  activation replicated.

The fused int4 wqkv / wgu are cut over their full concatenated width, so a
shard edge can fall inside q / k / v (JAX `tp.py:17-22`): every
column-parallel output is all-gathered before its next use, as GSPMD
reshards there, and so is the head-parallel attention output that feeds
the column-parallel wo. `shard_llama_tp` cuts the dense bf16 decoder
Megatron-style instead: q / k / v / gate / up by output columns (whole
heads), o / down by input rows, each row-parallel product summed over the
ranks by an f32 all-reduce, so a layer costs two collectives. The
embedding, the head (32101 rows divide no rank count), the norms, CLIP, the
projector and the CVAE head stay whole on every rank.

A shard is made only under the JAX package's conditions (`heads_shard`,
`int4_shard_ok`: `tp.py:71`, `:131`, `:185-197`); a weight or cache that
does not meet them stays whole and runs the unsharded kernel on every rank,
and `shard_llama_tp` logs each such fallback (at 7B with tp = 2 or 4: the
tiled wgu, 43 tiles). The ops take this rank's shard and the group
(`tp=None`: the whole tensors, no collective). Every packed byte of a shard
is the matching slice of the full model's, so a checkpoint quantized by
either package loads.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional

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


def all_gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """This rank's slice of the last dimension -> the whole, rank-major (the
    resharding GSPMD inserts after a column-parallel op)."""
    global COLLECTIVES
    COLLECTIVES += 1
    x = x.reshape(1, *x.shape).contiguous()
    out = torch.empty((tp.size, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=tp.group)
    return torch.movedim(out, 0, -2).reshape(*x.shape[1:-1], tp.size * x.shape[-1])


def broadcast_from_first(tensors, tp: TPGroup):
    """Every rank takes the group's first rank's values of `tensors`."""
    global COLLECTIVES
    COLLECTIVES += len(tensors)
    src = dist.get_global_rank(tp.group, 0) if tp.group is not None else 0
    out = []
    for t in tensors:
        t = t.contiguous()
        dist.broadcast(t, src, group=tp.group)
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# The ops (each rank's shard through the unsharded wrapper)
# ---------------------------------------------------------------------------


def local_heads(x: torch.Tensor, tp: TPGroup, dim: int = -2) -> torch.Tensor:
    """This rank's 1/tp of the heads of `x` along `dim`."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


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
    full = all_gather_last(out.reshape(*out.shape[:-2], -1), tp)
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
    below 128 rows, B5b / B5a from there."""
    y = int4_matmul_stacked(x, w4, gs, layer_idx, plain=plain)
    return y if tp_size(tp) == 1 else all_gather_last(y, tp)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        tp: Optional[TPGroup]) -> torch.Tensor:
    """x (..., din/tp) @ weight (dout, din/tp)^T summed over the ranks: the
    partial products in f32 (f32 accumulation, no bf16 rounding of a
    partial), one f32 all-reduce, one rounding to x's dtype, as the
    unsharded product rounds once."""
    if tp_size(tp) == 1:
        return nn.functional.linear(x, weight)
    flat = x.reshape(-1, x.shape[-1])
    if flat.is_cuda and flat.dtype != torch.float32:
        y = torch.mm(flat, weight.t(), out_dtype=torch.float32)
    else:
        y = flat.float() @ weight.float().t()
    global COLLECTIVES
    COLLECTIVES += 1
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])


# ---------------------------------------------------------------------------
# A rank's shard of a decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TPLayout:
    """What `shard_llama_tp` cut: this rank, the group size, whether the
    heads (attention weights and KV cache) and the dense MLP split, each
    int4 projection's split, and the fallbacks (whole on every rank)."""

    rank: int
    size: int
    heads: bool
    mlp: bool
    int4: Dict[str, bool]
    fallbacks: List[str]

    def kv_heads(self, kv_heads: int) -> int:
        """A rank's kv heads in its cache."""
        return kv_heads // self.size if self.heads else kv_heads


def _keep(mod: nn.Module, name: str, value: torch.Tensor) -> None:
    if isinstance(getattr(mod, name), nn.Parameter):
        setattr(mod, name, nn.Parameter(value.contiguous(), requires_grad=False))
    else:
        setattr(mod, name, value.contiguous())


@torch.no_grad()
def shard_llama_tp(llama, cfg, rank: int, tp: int) -> "nn.Module":
    """Cut a whole decoder (`models.llama.Llama`, dense or "int4" /
    "int4_flat") into rank `rank`'s shard of a `tp`-rank group, in place,
    and record what was cut (`llama.tp_layout`, a `TPLayout`):

    - tiled int4 weights on NB, flat int4 on columns, each only where
      `int4_shard_ok` allows (else whole, logged);
    - dense q / k / v / gate / up by output rows of their HF weights (whole
      heads), o / down by input columns, where `heads_shard` (attention) or
      tp | intermediate (MLP) allows (else whole, logged);
    - the KV cache a rank builds then holds its K/tp kv heads
      (`TPLayout.kv_heads`).

    The embedding, the norms and the head stay whole. The int8 layouts
    ("int8", "int8_fused", "int4_proj") have no tensor-parallel route in
    the JAX package (its B9 runs replicated under a mesh) and raise."""
    if llama.proj is not None:
        raise ValueError(f"quantize={llama.quantize!r} has no tensor-parallel route (the JAX "
                         "package runs its int8 weights replicated): decode it on one rank")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a group of {tp}")
    h, k, hd, f = cfg.num_heads, cfg.kv_heads, cfg.head_dim_, cfg.intermediate_size
    heads = heads_shard(h, k, tp)
    mlp = tp > 1 and f % tp == 0
    fallbacks: List[str] = []
    if tp > 1 and not heads:
        fallbacks.append(f"heads: {h} query / {k} kv heads do not split over {tp} ranks")
    int4 = {}
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
            for n, t in zip(names, part):
                setattr(w, n, t)
    else:
        if tp > 1 and not mlp:
            fallbacks.append(f"mlp: intermediate {f} does not split over {tp} ranks")
        qh, kh, fl = h // tp * hd, k // tp * hd, f // tp
        for lp in llama.layers:
            a, m = lp.self_attn, lp.mlp
            if heads:
                _keep(a.q_proj, "weight", a.q_proj.weight[rank * qh:(rank + 1) * qh])
                _keep(a.k_proj, "weight", a.k_proj.weight[rank * kh:(rank + 1) * kh])
                _keep(a.v_proj, "weight", a.v_proj.weight[rank * kh:(rank + 1) * kh])
                _keep(a.o_proj, "weight", a.o_proj.weight[:, rank * qh:(rank + 1) * qh])
            if mlp:
                _keep(m.gate_proj, "weight", m.gate_proj.weight[rank * fl:(rank + 1) * fl])
                _keep(m.up_proj, "weight", m.up_proj.weight[rank * fl:(rank + 1) * fl])
                _keep(m.down_proj, "weight", m.down_proj.weight[:, rank * fl:(rank + 1) * fl])
    for msg in fallbacks:
        log.warning("tensor parallel (rank %d of %d): %s; it runs unsharded on every rank",
                    rank, tp, msg)
    llama.tp_layout = TPLayout(rank, tp, heads, mlp, int4, fallbacks)
    return llama


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
