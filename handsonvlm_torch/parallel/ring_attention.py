"""Sequence-parallel ring attention over the ranks of a mesh axis.

Port of `handsonvlm_tpu/parallel/ring_attention.py`. Each of the P ranks of
the `seq` axis holds T/P consecutive rows of q, k and v (B, T/P, H, D),
rank p the rows p*T/P + [0, T/P). A rank attends its queries to the kv
block it holds, accumulating with the online-softmax recurrence (running
max, normalizer and weighted sum, all f32: exact, not approximate), then
passes the block on to the next rank and takes the previous rank's; after
P - 1 hops every query has seen every key.

- Causal masking uses global positions: the block a rank holds at hop s
  came from rank (p - s) mod P. Fully masked blocks still hop (the ring is
  a fixed schedule); their contribution is zero.
- Under GQA the kv blocks travel unrepeated (1/groups of the traffic) and
  are repeated per hop for the products.
- A key mask (B, T/P) travels with its block. A row whose keys are all
  masked returns 0 (plain attention returns the uniform average there;
  such rows are padding whose outputs are never read).
- The math inside a hop is plain torch in f32, as the JAX package uses
  plain XLA there: what this module owns is the schedule across ranks.
- A hop is `torch.distributed` point-to-point (`batch_isend_irecv`), wrapped
  as an autograd function whose backward sends the gradient the other way,
  so autograd through the unrolled hops is the JAX package's autodiff of
  its `ppermute` loop: the ring serves training at long context.

`shard_sequence` cuts a rank's rows out of a whole sequence and refuses a T
that P does not divide, with the JAX package's message.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

NEG_INF = -1e30  # matches ops/attention's mask fill


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ranks of one ring: this rank's place, the size, the process
    group and its members' global ranks in ring order."""

    rank: int
    size: int
    group: Optional[dist.ProcessGroup]
    members: Sequence[int]

    @classmethod
    def from_mesh(cls, mesh, axis: str = "seq") -> "Ring":
        group = mesh.get_group(axis)
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        return cls(mesh.get_local_rank(axis), size, group,
                   tuple(dist.get_global_rank(group, i) for i in range(size)))

    def shift(self, tensors, step: int):
        """Each tensor of this rank goes `step` places round the ring; the
        one `step` places back comes in."""
        to = self.members[(self.rank + step) % self.size]
        frm = self.members[(self.rank - step) % self.size]
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), to, self.group))
            ops.append(dist.P2POp(dist.irecv, o, frm, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


class _Hop(torch.autograd.Function):
    """Forward: the tensors move one place on (rank p -> p + 1). Backward:
    their gradients move one place back (p + 1 -> p)."""

    @staticmethod
    def forward(ctx, ring: Ring, *tensors):
        ctx.ring = ring
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(ring.shift(tensors, +1))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.likes)]
        return (None, *ctx.ring.shift(grads, -1))


def _block_attn_accum(q, k, v, m, l, acc, q_pos, k_pos, scale, causal, key_mask=None):
    """One online-softmax step of q against one kv block.

    q (B, Tq, H, D); k / v (B, Tk, H, D); m / l (B, H, Tq); acc (B, H, Tq, D)
    f32. q_pos (Tq,), k_pos (Tk,) global positions for causal masking;
    key_mask (B, Tk) marks the block's valid keys."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]  # (Tq, Tk)
        s = torch.where(mask[None, None], s, NEG_INF)
    if key_mask is not None:
        s = torch.where(key_mask.bool()[:, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard rows masked so far: exp(NEG_INF - NEG_INF) must not be 1
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    corr = torch.exp(m - m_new)
    corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def _ring_shard(q, k, v, key_mask, *, ring: Ring, causal: bool, scale: float):
    """A rank's part: q / k / v (B, Tl, H or K, D) its rows, key_mask
    (B, Tl) or None (it rides with its kv block)."""
    b, tl, h, d = q.shape
    groups = h // k.shape[2]
    dev = q.device
    q_pos = ring.rank * tl + torch.arange(tl, device=dev)
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=dev)
    for step in range(ring.size):
        src = (ring.rank - step) % ring.size  # the block's home rank
        k_pos = src * tl + torch.arange(tl, device=dev)
        kk, vv = k, v
        if groups > 1:
            kk = torch.repeat_interleave(k, groups, dim=2)
            vv = torch.repeat_interleave(v, groups, dim=2)
        m, l, acc = _block_attn_accum(q, kk, vv, m, l, acc, q_pos, k_pos, scale, causal,
                                      key_mask=key_mask)
        if step != ring.size - 1:
            k, v = _Hop.apply(ring, k, v)
            if key_mask is not None:
                key_mask = ring.shift([key_mask.to(torch.uint8)], +1)[0].bool()
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, H, Tl, D)
    return out.transpose(1, 2).to(q.dtype)  # (B, Tl, H, D)


def ring_attention(
    q: torch.Tensor,  # (B, T/P, H, D): this rank's rows
    k: torch.Tensor,  # (B, T/P, K, D)
    v: torch.Tensor,
    *,
    mesh,
    axis: str = "seq",
    causal: bool = True,
    key_mask: Optional[torch.Tensor] = None,  # (B, T/P) valid keys of this rank's rows
) -> torch.Tensor:
    """Exact attention over a sequence cut across the ranks of `mesh`'s
    `axis` (a `DeviceMesh`, or a `Ring`); returns this rank's rows
    (B, T/P, H, D). Differentiable. Rows whose keys are all masked return
    0. A `data` axis beside `axis` composes: each data rank runs its own
    ring over its rows of the batch."""
    ring = mesh if isinstance(mesh, Ring) else Ring.from_mesh(mesh, axis)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ring_shard(q, k, v, key_mask, ring=ring, causal=causal, scale=scale)


def shard_sequence(x: torch.Tensor, mesh, axis: str = "seq", dim: int = 1) -> torch.Tensor:
    """This rank's T/P rows of `x` along `dim`; a T that the axis size P
    does not divide raises, as the JAX package's `ring_attention` does."""
    ring = mesh if isinstance(mesh, Ring) else Ring.from_mesh(mesh, axis)
    t = x.shape[dim]
    if t % ring.size:
        raise ValueError(f"T={t} must divide the '{axis}' axis ({ring.size})")
    tl = t // ring.size
    return x.narrow(dim, ring.rank * tl, tl)
