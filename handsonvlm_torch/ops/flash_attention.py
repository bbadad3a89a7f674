"""Blockwise (flash) attention for prefill-sized queries, with its backward.

Port of `handsonvlm_tpu/ops/flash_attention.py::flash_attention`: kernel
B3, the forward `_fwd_call`, and B3b, the backward `_flash_bwd` (its dq and
dk/dv kernels). q (B, T, H, D) attends over k, v (B, S, K, D)
with grouped-query heads, an optional boolean key mask (B, S), causal
masking against the scalar `q_offset` (the absolute position of q[:, 0]:
the cache index of a prefill), an fp32 softmax, and the probabilities cast
to the inputs' dtype before the P.V product. Returns the output
(B, T, H, D) and each row's logsumexp (B, H, T) in fp32, which the
backward reads: it recomputes the probabilities tile by tile from it.

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

The wrappers launch the hand-written Hopper kernels
(`csrc/flash_attention.cu`) for CUDA tensors and run the plain versions
(`flash_attention_ref`, `flash_attention_bwd_ref`) for CPU tensors. There
is no fallback: on a CUDA tensor a wrapper launches its kernel or raises.
`flash_attention.LAUNCHES` counts forward launches and
`flash_attention_bwd.LAUNCHES` backward ones. In bf16 at head sizes 64 and
128 a backward is two launches on the stream: the delta pass (rowsum(dO *
O)), then one grid of dk/dv blocks (K and V resident, the query tiles
streamed) followed by dq blocks (Q and dO resident, the key tiles
streamed), all on wgmma fed by TMA; f32 and other head sizes launch the
FMA dq kernel, then the FMA dk/dv kernel. `flash_attention_bwd_part`
launches one part of the bf16 route alone, to time it. When q, k or v
requires grad under grad mode, `flash_attention` runs as a
`torch.autograd.Function` whose backward is `flash_attention_bwd`, as the
JAX package's custom_vjp pairs its forward with `_flash_bwd`.
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
    ok = _valid(b, t, s, key_mask, causal, q_offset, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bkgts,bskd->btkgd", p.to(q.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 3, 1, 2, 4)).reshape(b, t, h, d).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe)).reshape(b, h, t)
    return out, lse


def _valid(b, t, s, key_mask, causal, q_offset, device):
    """(B, 1, 1, T, S) bool: the pairs the forward attends."""
    ok = torch.ones((b, 1, 1, t, s), dtype=torch.bool, device=device)
    if key_mask is not None:
        ok = ok & key_mask.bool()[:, None, None, None, :]
    if causal:
        q_pos = torch.arange(t, device=device) + int(q_offset)
        ok = ok & (q_pos[:, None] >= torch.arange(s, device=device)[None, :])
    return ok


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, K, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, T, H, D): the forward's output
    lse: torch.Tensor,  # (B, H, T) f32: the forward's logsumexp
    dout: torch.Tensor,  # (B, T, H, D)
    *,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3b, the JAX package's `_flash_bwd`:
    p = exp(s - lse) on the attended pairs (0 elsewhere, so a row with no
    valid key gets dq = 0 and adds nothing), delta = rowsum(dO * O) in f32,
    ds = p (dO V^T - delta) * scale; dq = ds K, dv = p^T dO, dk = ds^T Q
    with p cast to dO's dtype and ds to q's before those products, f32
    sums. The GQA group's dk / dv are summed in f32 and rounded once (the
    JAX package rounds each repeated head's first; equal for MHA and in
    f32)."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    grp = h // kh
    scale = float(1.0 / (d ** 0.5))
    qg = q.float().reshape(b, t, kh, grp, d)
    dog = dout.float().reshape(b, t, kh, grp, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    ok = _valid(b, t, s, key_mask, causal, q_offset, q.device)
    p = torch.where(ok, torch.exp(scores - lse.reshape(b, kh, grp, t)[..., None]), 0.0)
    delta = (dog * out.float().reshape(b, t, kh, grp, d)).sum(-1)  # (B, T, K, G)
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    ds_r = ds.to(q.dtype).float()
    dq = torch.einsum("bkgts,bskd->btkgd", ds_r, k.float()).reshape(b, t, h, d)
    dk = torch.einsum("bkgts,btkgd->bskd", ds_r, qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(dout.dtype).float(), dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(x: torch.Tensor, name: str):
    """(batch, token) strides of a (B, N, heads, D) tensor whose last two
    axes are contiguous: what the kernel indexes in place."""
    d = x.shape[-1]
    if x.stride(-1) != 1 or x.stride(-2) != d:
        raise ValueError(f"{name}: the head and feature axes must be contiguous, "
                         f"got strides {x.stride()}")
    return x.stride(0), x.stride(1)


def _check_args(q, k, v, key_mask):
    """Check a call the kernels take; returns the six strides."""
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
    return (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))


def _launch(q, k, v, key_mask, causal: bool, q_offset: int):
    from handsonvlm_torch.ops._build import check, load_library

    strides = _check_args(q, k, v, key_mask)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
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


# the parts of B3b's bf16 route (the C entry point's `parts` bits)
BWD_PARTS = {"delta": 1, "dkv": 2, "dq": 4}


def _launch_bwd(q, k, v, out, lse, dout, key_mask, causal: bool, q_offset: int,
                parts: int = 7):
    from handsonvlm_torch.ops._build import check, load_library, refuse_grad

    refuse_grad("flash_attention_bwd", q, k, v, out, dout)

    strides = _check_args(q, k, v, key_mask)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be f32, got {lse.dtype}")
    out, lse = out.contiguous(), lse.contiguous()
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kh, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kh, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        status = lib.hv_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_mask.data_ptr() if key_mask is not None else None, out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(q.dtype == torch.bfloat16), b, t, s, h, kh, d, *strides,
            int(causal), q_offset, float(1.0 / (d ** 0.5)), parts,
            torch.cuda.current_stream().cuda_stream)
    check(status, "flash_attention_bwd")
    if parts == 7:
        flash_attention_bwd.LAUNCHES += 1
    return dq, dk, dv


def _forward(q, k, v, key_mask, causal, q_offset):
    if q.is_cuda:
        return _launch(q, k, v, key_mask, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, key_mask=key_mask, causal=causal,
                                   q_offset=q_offset)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, dout, *, key_mask=None, causal: bool = True,
                        q_offset: int = 0):
    """Flash attention backward: (dq, dk, dv) in q's dtype from the forward's
    output and logsumexp (kernel B3b). CUDA tensors run the Hopper kernels;
    CPU tensors the plain version."""
    q_offset = int(q_offset)
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, lse, dout, key_mask, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, key_mask=key_mask,
                                       causal=causal, q_offset=q_offset)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_bwd_part(q, k, v, out, lse, dout, part: str, *, key_mask=None,
                             causal: bool = True, q_offset: int = 0):
    """One part of B3b's bf16 tensor-core route alone, to time it: "delta"
    (the delta pass), "dkv" (the dk/dv blocks) or "dq" (the dq blocks). CUDA
    tensors only; the gradients it returns are incomplete (unwritten where
    the part does not write, and "dkv" / "dq" read the delta scratch as the
    allocator left it). Not counted in `flash_attention_bwd.LAUNCHES`."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_part times a kernel: CUDA tensors only")
    return _launch_bwd(q, k, v, out, lse, dout, key_mask, causal, int(q_offset),
                       BWD_PARTS[part])


class _Flash(torch.autograd.Function):
    """B3 forward, B3b backward; the logsumexp output has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, q_offset):
        out, lse = _forward(q, k, v, key_mask, causal, q_offset)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, key_mask=key_mask,
                                         causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


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

    CUDA tensors run the Hopper kernel; CPU tensors the plain version. Under
    grad mode with an input that requires grad, the output's gradient runs
    through `flash_attention_bwd`."""
    q_offset = int(q_offset)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Flash.apply(q, k, v, key_mask, causal, q_offset)
    return _forward(q, k, v, key_mask, causal, q_offset)


flash_attention.LAUNCHES = 0
flash_attention_bwd.LAUNCHES = 0
