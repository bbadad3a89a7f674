"""Blockwise (flash) attention forward for prefill-sized queries.

Port of `handsonvlm_tpu/ops/flash_attention.py::flash_attention` (kernel
B3, the forward `_fwd_call`). q (B, T, H, D) attends over k, v (B, S, K, D)
with grouped-query heads, an optional boolean key mask (B, S), causal
masking against the scalar `q_offset` (the absolute position of q[:, 0]:
the cache index of a prefill), an fp32 softmax, and the probabilities cast
to the inputs' dtype before the P.V product. Returns the output
(B, T, H, D) and each row's logsumexp (B, H, T) in fp32, which the
backward will need.

No (T, S) score tensor reaches device memory: at T = 4096 over a 4608-key
cache layer the plain route writes 2.4 GB of fp32 scores per layer. The
kernel reads q and the cache layer in place through their strides (a view
of one layer of the (L, B, S, K, D) cache, or of its first n positions,
costs no copy), never visits key tiles above the causal diagonal and skips
tiles whose keys are all masked, so its cost follows the valid keys.

A query row with no valid key (left padding) gives output 0 and logsumexp
NEG_INF here and in `flash_attention_ref`; the Pallas kernel and
`attention_xla` average some keys there. Such rows are never read:
comparisons hold valid rows only.

The wrapper launches the hand-written Hopper kernel
(`csrc/flash_attention.cu`) for CUDA tensors and runs the plain version
(`flash_attention_ref`) for CPU tensors. There is no fallback: on a CUDA
tensor it launches the kernel or raises. `flash_attention.LAUNCHES` counts
the launches. Forward only: the backward kernels (dq; dk/dv) come with
training (ROADMAP A9), and a CUDA input that requires grad raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256


def flash_attention_ref(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3: fp32 scores, NEG_INF on masked
    keys, p = exp(s - max) zeroed on masked keys and cast to q's dtype
    before P.V, the fp32 product divided by the fp32 sum l; logsumexp
    max + log(l). A row with no valid key: output 0, logsumexp NEG_INF."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = float(1.0 / (d ** 0.5))
    # query heads grouped by their kv head: (B, K, groups, T, S) scores
    qg = q.float().reshape(b, t, kh, h // kh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    ok = torch.ones((b, 1, 1, t, s), dtype=torch.bool, device=q.device)
    if key_mask is not None:
        ok = ok & key_mask.bool()[:, None, None, None, :]
    if causal:
        q_pos = torch.arange(t, device=q.device) + int(q_offset)
        ok = ok & (q_pos[:, None] >= torch.arange(s, device=q.device)[None, :])
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bkgts,bskd->btkgd", p.to(q.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 3, 1, 2, 4)).reshape(b, t, h, d).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe)).reshape(b, h, t)
    return out, lse


def _strides(x: torch.Tensor, name: str):
    """(batch, token) strides of a (B, N, heads, D) tensor whose last two
    axes are contiguous: what the kernel indexes in place."""
    d = x.shape[-1]
    if x.stride(-1) != 1 or x.stride(-2) != d:
        raise ValueError(f"{name}: the head and feature axes must be contiguous, "
                         f"got strides {x.stride()}")
    return x.stride(0), x.stride(1)


def _launch(q, k, v, key_mask, causal: bool, q_offset: int):
    from handsonvlm_torch.ops._build import check, load_library

    b, t, h, d = q.shape
    kb, s, kh, kd = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention takes bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype} differ")
    if v.shape != k.shape or kb != b or kd != d or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head size {d} > {MAX_HEAD_DIM}")
    if t < 1 or s < 1:
        raise ValueError(f"empty attention: T={t}, S={s}")
    tensors = [q, k, v] + ([key_mask] if key_mask is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and key_mask must be on one device")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (b, s)
                                 or not key_mask.is_contiguous()):
        raise ValueError(f"key_mask must be a contiguous bool (B, S)=({b}, {s})")
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        status = lib.hv_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_mask.data_ptr() if key_mask is not None else None, out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, t, s, h, kh, d, *strides,
            int(causal), q_offset, float(1.0 / (d ** 0.5)),
            torch.cuda.current_stream().cuda_stream)
    check(status, "flash_attention")
    flash_attention.LAUNCHES += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, K, D); a view of a cache layer is read in place
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,  # (B, S) bool
    causal: bool = True,
    q_offset: int = 0,  # absolute position of q[:, 0]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (out (B, T, H, D), logsumexp (B, H, T) f32).

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    q_offset = int(q_offset)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward kernel yet (ROADMAP A9): call it "
                "under torch.no_grad() or use impl='xla'")
        return _launch(q, k, v, key_mask, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, key_mask=key_mask, causal=causal,
                                   q_offset=q_offset)
    raise ValueError(f"no flash attention for device {q.device}")


flash_attention.LAUNCHES = 0
