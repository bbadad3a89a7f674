"""Decode attention over one layer of the stacked KV cache.

Port of `handsonvlm_tpu/ops/decode_attention.py::decode_attention_stacked`
(kernel B1) and `decode_attention_stacked_q` (kernel B6, the int8 cache
with per-(token, kv head) f32 scales (L, B, K, S)). A query window of
T <= MAX_T_WINDOW rows (T = 1 for plain decode) attends over positions
< `length` of layer `layer_idx` of the (L, B, S, K, D) cache; window row tq
attends causally up to `length - (T-1) + tq`. `length` already counts the
T rows written this step (cache index + T).

Each row sweeps a COMPACTED list of its cache blocks (`BlockList`, as the
Pallas kernel's scalar-prefetched table): the blocks of `block_k` keys
that hold at least one key with key_mask true below `length`, in order.
Leading pad, interior holes (other requests' prompt buckets in continuous
batching) and the unfilled tail are never read. The sweep sees the same
(content, lane mask) blocks in the same order when serving compaction
(ops/cache_ops) deletes empty blocks, so a live row's output is
bit-equal across a compaction event: the kernel cuts its splits over the
ordinal of the listed blocks, sized from the row's own count, and the
plain versions reduce each row over its own gathered list.

`decode_attention` (kernel B12, the JAX package's `decode_attention`) is
the single-query form over one layer's own (B, S, K, D) cache: a scalar
`length` and a key mask, no block list. Its kernel entry point sweeps
every 32-key tile below `length`, skips the tiles with no valid key, and
splits the key range over the card.

The wrappers launch the hand-written Hopper kernel
(`csrc/decode_attention.cu`, one templated body for the three entry
points) for CUDA tensors and run their plain versions (`*_ref`) for CPU
tensors. There is no fallback: on a CUDA tensor a wrapper launches the
kernel or raises. Each wrapper's `LAUNCHES` counts its kernel launches.
The kernels have no backward (the JAX package never differentiates decode
attention): a CUDA input that requires grad under grad mode raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from handsonvlm_torch.ops._build import refuse_grad

NEG_INF = -1e30
MAX_T_WINDOW = 8
DEFAULT_BLOCK_K = 256
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def pick_block_k(s: int) -> int:
    """Keys per block of the compacted sweep for a cache of S positions:
    the largest multiple of 128 that is <= 256 and divides S (256 where
    256 | S, else 128; a last partial block when 128 does not divide S
    either). The JAX package's `_pick_stacked_block` on the TPU."""
    bk = DEFAULT_BLOCK_K
    while bk > 128 and s % bk:
        bk //= 2
    return bk


@dataclasses.dataclass
class BlockList:
    """Each row's listed cache blocks: `table[b, :counts[b]]` are the
    indices of row b's blocks with a valid key, ascending; the rest of the
    row repeats its last entry (0 for an empty row)."""

    table: torch.Tensor  # (B, ceil(S / block_k)) int32
    counts: torch.Tensor  # (B,) int32
    block_k: int


def block_list(key_mask: Optional[torch.Tensor], length: int, batch: int, s: int,
               device) -> BlockList:
    """The compacted block list of a (B, S) key mask (None: every key) for
    keys below `length`, built on `device` without a host sync. A forward
    builds it once and every layer's decode attention reads it."""
    bk = pick_block_k(s)
    nk = -(-s // bk)
    if key_mask is None:
        key_mask = torch.ones((batch, s), dtype=torch.bool, device=device)
    km = F.pad(key_mask.bool(), (0, nk * bk - s))
    ids = torch.arange(nk, device=device, dtype=torch.int32)
    valid = km.view(batch, nk, bk).any(dim=-1) & (ids * bk < length)[None, :]
    counts = valid.sum(dim=-1, dtype=torch.int32)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    last = torch.minimum(ids[None, :], (counts[:, None] - 1).clamp(min=0))
    table = torch.gather(order, 1, last.long()).to(torch.int32)
    return BlockList(table=table.contiguous(), counts=counts, block_k=bk)


def _attend_ref(q, k, v, blocks: BlockList, length, key_mask, ks=None, vs=None):
    """q (B,T,H,D) over one layer's keys k, v (B,S,K,D) listed by `blocks`;
    with ks, vs (B,K,S) the int8 cache's scales, applied as the Pallas
    kernel applies them: on the score rows and on p before P.V. Each row
    gathers the valid keys of its own listed blocks, in position order, and
    reduces over exactly those, so its result depends on nothing but its
    own keys: not on the other rows, and not on where in the cache its keys
    sit (a request joined at another cursor, or moved by a compaction,
    gives the same bits)."""
    b, tw, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    bk = blocks.block_k
    dev = q.device
    scale = float(1.0 / (d ** 0.5))
    tq = torch.arange(tw, device=dev)
    outs = []
    for r, count in enumerate(blocks.counts.tolist()):
        if count == 0:  # no valid key: 0, as in the kernel
            outs.append(torch.zeros((1, tw, h, d), dtype=q.dtype, device=dev))
            continue
        pos = (blocks.table[r, :count].long()[:, None] * bk
               + torch.arange(bk, device=dev)).reshape(-1)
        valid = pos < min(length, s)
        pos = pos.clamp(max=s - 1)
        if key_mask is not None:
            valid = valid & key_mask[r].bool()[pos]
        pos = pos[valid]  # the row's valid keys alone, in position order
        valid = valid[valid]
        kg, vg = k[r, pos].float(), v[r, pos].float()  # (N, K, D)
        # rows laid out (kv head, group, tq) as in the kernel
        qg = q[r].float().reshape(tw, kh, g, d)
        sc = torch.einsum("tkgd,nkd->kgtn", qg, kg)
        if ks is not None:
            sc = sc * ks[r][:, pos][:, None, None, :]
        sc = sc * scale
        causal = pos[None, :] < (length - (tw - 1) + tq)[:, None]  # (T, N)
        ok = valid[None, :] & causal
        sc = torch.where(ok, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if vs is not None:
            p = p * vs[r][:, pos][:, None, None, :]
        o = torch.einsum("kgtn,nkd->kgtd", p, vg) / torch.where(l == 0.0, 1.0, l)
        outs.append(o.permute(2, 0, 1, 3).reshape(1, tw, h, d).to(q.dtype))
    return torch.cat(outs)


def _blocks_for(q, ck, length, key_mask, blocks):
    if blocks is not None:
        return blocks
    return block_list(key_mask, length, q.shape[0], ck.shape[2], q.device)


def decode_attention_stacked_ref(
    q: torch.Tensor,  # (B, T, H, D)
    ck: torch.Tensor,  # (L, B, S, K, D)
    cv: torch.Tensor,
    layer_idx: int,
    length: int,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    blocks: Optional[BlockList] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: fp32 scores and softmax over each
    row's listed blocks, masked probabilities zeroed, a row with no valid
    key gives 0."""
    blocks = _blocks_for(q, ck, length, key_mask, blocks)
    return _attend_ref(q, ck[layer_idx], cv[layer_idx], blocks, length, key_mask)


def decode_attention_stacked_q_ref(
    q: torch.Tensor,  # (B, T, H, D)
    ck: torch.Tensor,  # (L, B, S, K, D) int8
    cv: torch.Tensor,
    ks: torch.Tensor,  # (L, B, K, S) f32
    vs: torch.Tensor,
    layer_idx: int,
    length: int,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    blocks: Optional[BlockList] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B6: B1's over the int8 cache, scores
    times the k-scales, probabilities times the v-scales before P.V."""
    blocks = _blocks_for(q, ck, length, key_mask, blocks)
    return _attend_ref(q, ck[layer_idx], cv[layer_idx], blocks, length, key_mask,
                       ks[layer_idx].float(), vs[layer_idx].float())


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(q, ck, cv, layer_idx: int, length: int, key_mask, blocks: BlockList,
            scales=None):
    """Launch B1, or B6 when `scales` (ks, vs) are given."""
    from handsonvlm_torch.ops._build import check, load_library

    b, tw, h, d = q.shape
    L, cb, s, kh, cd = ck.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode attention takes bf16 or f32, got {q.dtype}")
    cache_dtype = q.dtype if scales is None else torch.int8
    if ck.dtype != cache_dtype or cv.dtype != cache_dtype:
        raise TypeError(f"cache dtypes ck {ck.dtype} cv {cv.dtype}, want {cache_dtype}")
    if scales is not None:
        for sc in scales:
            if sc.dtype != torch.float32 or tuple(sc.shape) != (L, b, kh, s):
                raise ValueError(f"scales must be f32 (L, B, K, S)=({L}, {b}, {kh}, {s}), "
                                 f"got {sc.dtype} {tuple(sc.shape)}")
    if cv.shape != ck.shape or cb != b or cd != d or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} ck {tuple(ck.shape)} "
                         f"cv {tuple(cv.shape)} do not fit")
    if not 1 <= tw <= MAX_T_WINDOW:
        raise ValueError(f"window T={tw} outside 1..{MAX_T_WINDOW}")
    if not 0 <= layer_idx < L or not 1 <= length <= s:
        raise ValueError(f"layer_idx {layer_idx} / length {length} out of "
                         f"range for L={L}, S={s}")
    if d > 256:
        raise ValueError(f"head size {d} > 256")
    bk = blocks.block_k
    nk = -(-s // bk)
    if (bk % 32 or blocks.table.dtype != torch.int32 or blocks.counts.dtype != torch.int32
            or tuple(blocks.table.shape) != (b, nk) or tuple(blocks.counts.shape) != (b,)):
        raise ValueError(f"block list must be int32 table (B, ceil(S/block_k))=({b}, {nk}) "
                         f"and counts ({b},) with block_k a multiple of 32")
    tensors = ([q, ck, cv, blocks.table, blocks.counts] + list(scales or ())
               + ([key_mask] if key_mask is not None else []))
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the cache, its scales, the block list and key_mask must be "
                         "on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the cache, its scales, the block list and key_mask must be "
                         "contiguous")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (b, s)):
        raise ValueError(f"key_mask must be bool (B, S)=({b}, {s})")
    lib = load_library()
    if lib.hv_decode_attention_smem_bytes((h // kh) * tw, d) > _SMEM_LIMIT:
        raise ValueError(f"{(h // kh) * tw} query rows per kv head at D={d} "
                         "exceed one block's shared memory")

    rows = (h // kh) * tw
    # splits per (kv head, row): enough blocks to cover every SM about twice;
    # the kernel sizes them from the largest count it reads on the device
    max_splits = max(1, -(-2 * _num_sms(q.device.index) // (kh * b)))
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kh, max_splits, rows, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kh, max_splits, 2, rows), dtype=torch.float32, device=q.device)
    mask_ptr = key_mask.data_ptr() if key_mask is not None else None
    tail = (mask_ptr, blocks.table.data_ptr(), blocks.counts.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), int(q.dtype == torch.bfloat16), b, tw,
            h, kh, d, s, length, nk, bk, max_splits, float(1.0 / (d ** 0.5)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if scales is None:
            status = lib.hv_decode_attention_stacked(
                q.data_ptr(), ck[layer_idx].data_ptr(), cv[layer_idx].data_ptr(),
                *tail, stream)
        else:
            status = lib.hv_decode_attention_stacked_q(
                q.data_ptr(), ck[layer_idx].data_ptr(), cv[layer_idx].data_ptr(),
                scales[0][layer_idx].data_ptr(), scales[1][layer_idx].data_ptr(),
                *tail, stream)
    if scales is None:
        check(status, "decode_attention_stacked")
        decode_attention_stacked.LAUNCHES += 1
    else:
        check(status, "decode_attention_stacked_q")
        decode_attention_stacked_q.LAUNCHES += 1
    return out


def decode_attention_stacked(
    q: torch.Tensor,  # (B, T, H, D) with T <= MAX_T_WINDOW, or (B, H, D)
    ck: torch.Tensor,  # (L, B, S, K, D) full stacked cache
    cv: torch.Tensor,
    layer_idx: int,
    length: int,  # valid positions including the T window rows
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    blocks: Optional[BlockList] = None,  # block_list(key_mask, length, ...) if None
) -> torch.Tensor:
    """Attention of a decode window over one layer of the stacked cache.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    layer_idx, length = int(layer_idx), int(length)
    blocks = _blocks_for(q, ck, length, key_mask, blocks)
    if q.is_cuda:
        refuse_grad("decode_attention_stacked", q, ck, cv)
        out = _launch(q, ck, cv, layer_idx, length, key_mask, blocks)
    elif q.device.type == "cpu":
        out = decode_attention_stacked_ref(
            q, ck, cv, layer_idx, length, key_mask=key_mask, blocks=blocks)
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    return out[:, 0] if squeeze else out


def decode_attention_stacked_q(
    q: torch.Tensor,  # (B, T, H, D) with T <= MAX_T_WINDOW, or (B, H, D)
    ck: torch.Tensor,  # (L, B, S, K, D) int8 stacked cache
    cv: torch.Tensor,
    ks: torch.Tensor,  # (L, B, K, S) f32 per-(token, kv head) scales
    vs: torch.Tensor,
    layer_idx: int,
    length: int,  # valid positions including the T window rows
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    blocks: Optional[BlockList] = None,  # block_list(key_mask, length, ...) if None
) -> torch.Tensor:
    """decode_attention_stacked over the int8 cache, dequantized exactly.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    layer_idx, length = int(layer_idx), int(length)
    blocks = _blocks_for(q, ck, length, key_mask, blocks)
    if q.is_cuda:
        refuse_grad("decode_attention_stacked_q", q, ks, vs)
        out = _launch(q, ck, cv, layer_idx, length, key_mask, blocks, scales=(ks, vs))
    elif q.device.type == "cpu":
        out = decode_attention_stacked_q_ref(
            q, ck, cv, ks, vs, layer_idx, length, key_mask=key_mask, blocks=blocks)
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    return out[:, 0] if squeeze else out


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, D) or (B, H, D)
    k: torch.Tensor,  # (B, S, K, D) one layer's cache
    v: torch.Tensor,
    length: int,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
) -> torch.Tensor:
    """Plain PyTorch version of kernel B12: fp32 scores of one query per
    head over the keys with pos < length and key_mask, fp32 softmax with
    masked probabilities zeroed, a row with no valid key gives 0."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kh, h // kh, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * float(1.0 / (d ** 0.5))
    ok = (torch.arange(s, device=q.device) < int(length))[None, :]
    if key_mask is not None:
        ok = ok & key_mask.bool()
    ok = ok[:, None, None, :]
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.where(ok, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) / torch.where(l == 0.0, 1.0, l)
    out = o.reshape(b, h, d).to(q.dtype)
    return out[:, None] if squeeze else out


def _launch_single(q, k, v, length: int, key_mask):
    """Launch B12: q (B, H, D) over one layer's k, v (B, S, K, D)."""
    from handsonvlm_torch.ops._build import check, load_library

    b, h, d = q.shape
    kb, s, kh, kd = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode attention takes bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cache dtypes k {k.dtype} v {v.dtype}, want {q.dtype}")
    if v.shape != k.shape or kb != b or kd != d or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if not 1 <= length <= s:
        raise ValueError(f"length {length} out of range for S={s}")
    if d > 256:
        raise ValueError(f"head size {d} > 256")
    tensors = [q, k, v] + ([key_mask] if key_mask is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the cache and key_mask must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the cache and key_mask must be contiguous")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (b, s)):
        raise ValueError(f"key_mask must be bool (B, S)=({b}, {s})")
    lib = load_library()
    rows = h // kh
    if lib.hv_decode_attention_smem_bytes(rows, d) > _SMEM_LIMIT:
        raise ValueError(f"{rows} query heads per kv head at D={d} exceed one block's "
                         "shared memory")
    # splits per (kv head, row): enough blocks to cover every SM about twice
    max_splits = max(1, -(-2 * _num_sms(q.device.index) // (kh * b)))
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kh, max_splits, rows, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kh, max_splits, 2, rows), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.hv_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_mask.data_ptr() if key_mask is not None else None, out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), int(q.dtype == torch.bfloat16), b, h,
            kh, d, s, length, max_splits, float(1.0 / (d ** 0.5)),
            torch.cuda.current_stream().cuda_stream)
    check(status, "decode_attention")
    decode_attention.LAUNCHES += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) or (B, H, D)
    k: torch.Tensor,  # (B, S, K, D) one layer's cache (a view of the stack)
    v: torch.Tensor,
    length: int,  # valid cache positions (cache index + 1)
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
) -> torch.Tensor:
    """Single-position cached attention over one layer's cache; returns the
    rank of q. Keys at or past `length` are never read.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    squeeze = q.dim() == 4
    if squeeze:
        if q.shape[1] != 1:
            raise ValueError(f"decode_attention takes one query position, got T={q.shape[1]}")
        q = q[:, 0]
    length = int(length)
    if q.is_cuda:
        refuse_grad("decode_attention", q, k, v)
        out = _launch_single(q.contiguous(), k, v, length, key_mask)
    elif q.device.type == "cpu":
        out = decode_attention_ref(q, k, v, length, key_mask=key_mask)
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    return out[:, None] if squeeze else out


decode_attention_stacked.LAUNCHES = 0
decode_attention_stacked_q.LAUNCHES = 0
decode_attention.LAUNCHES = 0
