"""Decode attention over one layer of the stacked KV cache.

Port of `handsonvlm_tpu/ops/decode_attention.py::decode_attention_stacked`
(kernel B1) and `decode_attention_stacked_q` (kernel B6, the int8 cache
with per-(token, kv head) f32 scales (L, B, K, S)). A query window of
T <= MAX_T_WINDOW rows (T = 1 for plain decode) attends over positions
< `length` of layer `layer_idx` of the (L, B, S, K, D) cache; window row tq
attends causally up to `length - (T-1) + tq`. `length` already counts the
T rows written this step (cache index + T).

Both wrappers launch the hand-written Hopper kernel
(`csrc/decode_attention.cu`, one body for both caches) for CUDA tensors and
run their plain versions (`*_ref`) for CPU tensors. There is no fallback:
on a CUDA tensor a wrapper launches the kernel or raises. Each wrapper's
`LAUNCHES` counts its kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

NEG_INF = -1e30
MAX_T_WINDOW = 8
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _attend_ref(q, k, v, length, key_mask, ks=None, vs=None):
    """q (B,T,H,D) over one layer's first `length` keys k, v (B,S',K,D);
    with ks, vs (B,K,S') the int8 cache's scales, applied as the Pallas
    kernel applies them: on the score rows and on p before P.V."""
    b, tw, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    k, v = k.float(), v.float()
    s_len = k.shape[1]
    scale = float(1.0 / (d ** 0.5))
    # rows laid out (kv head, group, tq) as in the kernel
    qg = q.float().reshape(b, tw, kh, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    if ks is not None:
        s = s * ks[:, :, None, None, :]
    s = s * scale
    pos = torch.arange(s_len, device=q.device)
    tq = torch.arange(tw, device=q.device)
    ok = pos[None, :] < (length - (tw - 1) + tq)[:, None]  # (T, S')
    ok = ok[None, None, None]
    if key_mask is not None:
        ok = ok & key_mask[:, :length].bool()[:, None, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, :, None, None, :]
    o = torch.einsum("bkgts,bskd->bkgtd", p, v) / torch.where(l == 0.0, 1.0, l)
    return o.permute(0, 3, 1, 2, 4).reshape(b, tw, h, d).to(q.dtype)


def decode_attention_stacked_ref(
    q: torch.Tensor,  # (B, T, H, D)
    ck: torch.Tensor,  # (L, B, S, K, D)
    cv: torch.Tensor,
    layer_idx: int,
    length: int,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: fp32 scores and softmax, masked
    probabilities zeroed, a row with no valid key gives 0."""
    return _attend_ref(q, ck[layer_idx, :, :length], cv[layer_idx, :, :length],
                       length, key_mask)


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
) -> torch.Tensor:
    """Plain PyTorch version of kernel B6: B1's over the int8 cache, scores
    times the k-scales, probabilities times the v-scales before P.V."""
    return _attend_ref(q, ck[layer_idx, :, :length], cv[layer_idx, :, :length],
                       length, key_mask, ks[layer_idx, :, :, :length].float(),
                       vs[layer_idx, :, :, :length].float())


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split_keys(length: int, blocks: int, n_sm: int, tile: int = 32) -> int:
    """Keys per split of [0, length): a multiple of `tile`, chosen so that
    blocks x splits covers every SM about twice."""
    tiles = -(-length // tile)
    want = min(max(1, -(-2 * n_sm // blocks)), tiles)
    return tile * -(-tiles // want)


def _launch(q, ck, cv, layer_idx: int, length: int, key_mask, scales=None):
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
    tensors = ([q, ck, cv] + list(scales or ())
               + ([key_mask] if key_mask is not None else []))
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the cache, its scales and key_mask must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the cache, its scales and key_mask must be contiguous")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (b, s)):
        raise ValueError(f"key_mask must be bool (B, S)=({b}, {s})")
    lib = load_library()
    if lib.hv_decode_attention_smem_bytes((h // kh) * tw, d) > _SMEM_LIMIT:
        raise ValueError(f"{(h // kh) * tw} query rows per kv head at D={d} "
                         "exceed one block's shared memory")

    rows = (h // kh) * tw
    split_keys = _split_keys(length, kh * b, _num_sms(q.device.index))
    n_split = -(-length // split_keys)
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kh, n_split, rows, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kh, n_split, 2, rows), dtype=torch.float32, device=q.device)
    mask_ptr = key_mask.data_ptr() if key_mask is not None else None
    tail = (mask_ptr, out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            int(q.dtype == torch.bfloat16), b, tw, h, kh, d, s, length, split_keys,
            float(1.0 / (d ** 0.5)))
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
) -> torch.Tensor:
    """Attention of a decode window over one layer of the stacked cache.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    layer_idx, length = int(layer_idx), int(length)
    if q.is_cuda:
        out = _launch(q, ck, cv, layer_idx, length, key_mask)
    elif q.device.type == "cpu":
        out = decode_attention_stacked_ref(
            q, ck, cv, layer_idx, length, key_mask=key_mask)
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
) -> torch.Tensor:
    """decode_attention_stacked over the int8 cache, dequantized exactly.

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    layer_idx, length = int(layer_idx), int(length)
    if q.is_cuda:
        out = _launch(q, ck, cv, layer_idx, length, key_mask, scales=(ks, vs))
    elif q.device.type == "cpu":
        out = decode_attention_stacked_q_ref(
            q, ck, cv, ks, vs, layer_idx, length, key_mask=key_mask)
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    return out[:, 0] if squeeze else out


decode_attention_stacked.LAUNCHES = 0
decode_attention_stacked_q.LAUNCHES = 0
