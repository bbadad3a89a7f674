"""Fused int8-base + LoRA-epilogue stacked matmuls (the fused QLoRA path).

Port of `handsonvlm_tpu/ops/qlora_fused.py`, the projections of the
`--qlora int8_fused` train step: the frozen int8 base (the int8 decoder's
stacked `w8` (L, din, dout) and per-column `scale` (L, dout)) with each
targeted projection's low-rank delta accumulated in the base product's f32
output tile, so the full-width delta never exists in device memory.

- Kernels, each a wrapper that launches its hand-written Hopper kernel for
  CUDA tensors and runs its plain version (`*_ref`) for CPU tensors, no
  fallback, `<wrapper>.LAUNCHES` counting launches
  (`csrc/qlora_fused.cu`):
  - B10a `int8_stacked_fwd`: o = bf16(x) @ bf16(W8[l]) with f32 sums, times
    s[l] in f32, plus (with an adapter) u_s @ b in f32, one cast to bf16;
  - B10b `int8_stacked_bwd`: dx = bf16(g) @ (bf16(W8[l]) * bf16(s[l]))^T,
    the scale folded into the bf16 dequantization, f32 sums, plus (with an
    adapter) v_s @ a^T in f32, one cast to bf16.
  Both raise under grad: they are the two halves of the autograd fronts.
- Autograd fronts, the JAX package's custom_vjp pair:
  - `int8_matmul_stacked(x, w8_all, s_all, layer_idx)`: B10a without the
    epilogue, dx by B10b; the int8 weights and scales get no gradient;
  - `int8_lora_matmul_stacked(x, w8_all, s_all, a, b, ls, layer_idx)`:
    u = bf16(x) @ bf16(a) (f32 sums) outside the kernel, u_s = u * ls, B10a
    with the epilogue; backward v = bf16(g) @ bf16(b)^T, v_s = v * ls, B10b
    with the v_s @ a^T epilogue, and the thin products da = (bf16(x)^T @
    bf16(v)) * ls and db = (bf16(u)^T @ bf16(g)) * ls outside the kernel;
    `ls` (alpha / r, optimizer-masked) gets a zero gradient.
  The output is bf16, then cast to x's dtype; dx likewise.
  `plain=True` runs the plain versions on any device (the reference route).

The TPU-only parts do not carry over: the rank padded to a multiple of 128
(`_pad_rank`), the VMEM block picking and the scalar-prefetched layer
select. The kernels take any rank and any row count, and the caller passes
the layer's views. The models' int8_fused route keeps `Llama.proj`'s
`Int8Weight` stacks, the leaves JAX's `stack_llama_int8` moves under
`layers["int8"]`.
"""

from __future__ import annotations

from typing import Optional

import torch


def mm_f32(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p @ q of bf16 operands with f32 sums and an f32 result (JAX's
    `preferred_element_type=f32`): `torch.mm(out_dtype=)` on the card, the
    exact f32 products of the upcast operands on the CPU."""
    if p.is_cuda:
        return torch.mm(p, q, out_dtype=torch.float32)
    return p.float() @ q.float()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_stacked_fwd_ref(x2: torch.Tensor, w8_all: torch.Tensor, s_all: torch.Tensor,
                         layer_idx: int, u_s: Optional[torch.Tensor] = None,
                         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2 (m, d) bf16 @ W8[l] (d, n) in f32 (bf16 x int8 products are exact),
    times s[l] in f32, plus u_s (m, r) @ b (r, n) in f32, cast to bf16: the
    Pallas forward kernel's arithmetic."""
    y = (x2.float() @ w8_all[layer_idx].float()) * s_all[layer_idx]
    if u_s is not None:
        y = y + u_s @ b.float()
    return y.to(torch.bfloat16)


def int8_stacked_bwd_ref(g2: torch.Tensor, w8_all: torch.Tensor, s_all: torch.Tensor,
                         layer_idx: int, v_s: Optional[torch.Tensor] = None,
                         a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g2 (m, n) bf16 @ (bf16(W8[l]) * bf16(s[l]))^T (a bf16 product, one
    rounding) with f32 sums, plus v_s (m, r) @ a (d, r)^T in f32, cast to
    bf16: the Pallas backward kernel's arithmetic."""
    w = w8_all[layer_idx].to(torch.bfloat16) * s_all[layer_idx].to(torch.bfloat16)
    dx = g2.float() @ w.float().t()
    if v_s is not None:
        dx = dx + v_s @ a.float().t()
    return dx.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what, x2, w8_all, s_all, layer_idx, lhs, rhs, contraction):
    """Check a call: x2 (m, k) bf16 with k = d (forward) or n (backward)."""
    if x2.dtype != torch.bfloat16 or x2.dim() != 2:
        raise TypeError(f"{what} takes a bf16 (m, k) input, got {x2.dtype} {tuple(x2.shape)}")
    if w8_all.dtype != torch.int8 or s_all.dtype != torch.float32 or w8_all.dim() != 3:
        raise TypeError(f"{what} takes int8 w8 (L, d, n) and f32 scales (L, n), got "
                        f"{w8_all.dtype} {tuple(w8_all.shape)} / {s_all.dtype}")
    L, d, n = w8_all.shape
    if tuple(s_all.shape) != (L, n):
        raise ValueError(f"scales {tuple(s_all.shape)} do not fit w8 {tuple(w8_all.shape)}")
    if x2.shape[1] != (d if contraction == "d" else n):
        raise ValueError(f"{what}: the input has {x2.shape[1]} features, the weight "
                         f"{d if contraction == 'd' else n}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range for L={L}")
    if n % 16 or d % 8:
        raise ValueError(f"{what} reads 16 bytes at a time: n must be a multiple of 16 and "
                         f"d of 8, got d={d}, n={n}")
    if (lhs is None) != (rhs is None):
        raise ValueError(f"{what}: the adapter's two operands come together")
    tensors = [x2, w8_all, s_all] + ([lhs, rhs] if lhs is not None else [])
    if any(t.device != x2.device for t in tensors):
        raise ValueError(f"{what}: every operand must be on one device")
    if not (w8_all.is_contiguous() and s_all.is_contiguous()):
        raise ValueError(f"{what}: w8 and the scales must be contiguous")
    if lhs is not None and (lhs.dtype != torch.float32 or rhs.dtype != torch.float32):
        raise TypeError(f"{what}: the adapter operands are f32")
    return d, n


def _launch(entry, what, counter, x2, w8_all, s_all, layer_idx, lhs, rhs, contraction):
    from handsonvlm_torch.ops._build import check, load_library, refuse_grad

    refuse_grad(what, x2, lhs, rhs)
    d, n = _check(what, x2, w8_all, s_all, layer_idx, lhs, rhs, contraction)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the kernels read 16 bytes at a time
        x2 = x2.clone()
    m = x2.shape[0]
    r = 0 if lhs is None else lhs.shape[1]
    if lhs is not None:
        lhs, rhs = lhs.contiguous(), rhs.contiguous()
        want = (m, r), ((r, n) if contraction == "d" else (d, r))
        if (tuple(lhs.shape), tuple(rhs.shape)) != want:
            raise ValueError(f"{what}: adapter operands {tuple(lhs.shape)}, "
                             f"{tuple(rhs.shape)}; expected {want}")
    out = torch.empty((m, n if contraction == "d" else d), dtype=torch.bfloat16,
                      device=x2.device)
    lib = load_library()
    with torch.cuda.device(x2.device):
        status = getattr(lib, entry)(
            x2.data_ptr(), w8_all[layer_idx].data_ptr(), s_all[layer_idx].data_ptr(),
            None if lhs is None else lhs.data_ptr(), None if rhs is None else rhs.data_ptr(),
            out.data_ptr(), m, d, n, r, torch.cuda.current_stream().cuda_stream)
    check(status, what)
    counter.LAUNCHES += 1
    return out


def _on_device(x2, launch, ref, *args):
    if x2.is_cuda:
        return launch(x2, *args)
    if x2.device.type == "cpu":
        return ref(x2, *args)
    raise ValueError(f"no fused int8 matmul for device {x2.device}")


def int8_stacked_fwd(x2, w8_all, s_all, layer_idx, u_s=None, b=None) -> torch.Tensor:
    """x2 (m, d) bf16 @ W8[layer_idx] times its scales, plus u_s (m, r) @ b
    (r, n) f32 when given -> (m, n) bf16 (kernel B10a)."""
    return _on_device(
        x2, lambda *a: _launch("hv_qlora_fwd", "int8_stacked_fwd", int8_stacked_fwd, *a, "d"),
        int8_stacked_fwd_ref, w8_all, s_all, int(layer_idx), u_s, b)


def int8_stacked_bwd(g2, w8_all, s_all, layer_idx, v_s=None, a=None) -> torch.Tensor:
    """g2 (m, n) bf16 @ (bf16(W8[layer_idx]) * bf16(s))^T, plus v_s (m, r) @
    a (d, r)^T f32 when given -> (m, d) bf16 (kernel B10b)."""
    return _on_device(
        g2, lambda *a_: _launch("hv_qlora_bwd", "int8_stacked_bwd", int8_stacked_bwd, *a_,
                                "n"),
        int8_stacked_bwd_ref, w8_all, s_all, int(layer_idx), v_s, a)


int8_stacked_fwd.LAUNCHES = 0
int8_stacked_bwd.LAUNCHES = 0


# ---------------------------------------------------------------------------
# Differentiable fronts
# ---------------------------------------------------------------------------


def _ops(plain: bool):
    return ((int8_stacked_fwd_ref, int8_stacked_bwd_ref) if plain
            else (int8_stacked_fwd, int8_stacked_bwd))


class _Int8Stacked(torch.autograd.Function):
    """y = fwd(bf16(x)) in x's dtype; dx = bwd(bf16(dy)) in x's dtype. The
    int8 weights and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, w8_all, s_all, layer_idx, plain):
        fwd, _ = _ops(plain)
        d, n = w8_all.shape[1:]
        ctx.save_for_backward(w8_all, s_all)
        ctx.layer_idx, ctx.plain, ctx.dtype, ctx.shape = layer_idx, plain, x.dtype, x.shape
        out = fwd(x.reshape(-1, d).to(torch.bfloat16), w8_all, s_all, layer_idx)
        return out.reshape(*x.shape[:-1], n).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        w8_all, s_all = ctx.saved_tensors
        _, bwd = _ops(ctx.plain)
        g2 = dy.reshape(-1, w8_all.shape[2]).to(torch.bfloat16)
        dx = bwd(g2, w8_all, s_all, ctx.layer_idx)
        return dx.reshape(ctx.shape).to(ctx.dtype), None, None, None, None


class _Int8LoraStacked(torch.autograd.Function):
    """The fused QLoRA projection: y = bf16(x) @ W8[l] * s[l] + u_s @ b in
    x's dtype, and its gradients in x, a and b (JAX's `_int8_lora_fwd` /
    `_int8_lora_bwd`); `ls` gets zeros."""

    @staticmethod
    def forward(ctx, x, w8_all, s_all, a, b, ls, layer_idx, plain):
        fwd, _ = _ops(plain)
        d, n = w8_all.shape[1:]
        x2 = x.reshape(-1, d).to(torch.bfloat16)
        # the thin first stage outside the kernel, bf16 operands, f32 sums
        u = mm_f32(x2, a.to(torch.bfloat16))
        out = fwd(x2, w8_all, s_all, layer_idx, (u * ls).float(), b.float())
        ctx.save_for_backward(x, w8_all, s_all, a, b, ls, u)
        ctx.layer_idx, ctx.plain = layer_idx, plain
        return out.reshape(*x.shape[:-1], n).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w8_all, s_all, a, b, ls, u = ctx.saved_tensors
        _, bwd = _ops(ctx.plain)
        d, n = w8_all.shape[1:]
        g2 = dy.reshape(-1, n).to(torch.bfloat16)
        x2 = x.reshape(-1, d).to(torch.bfloat16)
        v = mm_f32(g2, b.to(torch.bfloat16).t())
        dx = bwd(g2, w8_all, s_all, ctx.layer_idx, (v * ls).float(), a.float())
        needs = ctx.needs_input_grad
        da = (mm_f32(x2.t(), v.to(torch.bfloat16)) * ls).to(a.dtype) if needs[3] else None
        db = (mm_f32(u.to(torch.bfloat16).t(), g2) * ls).to(b.dtype) if needs[4] else None
        dls = torch.zeros_like(ls) if needs[5] else None
        return dx.reshape(x.shape).to(x.dtype), None, None, da, db, dls, None, None


def int8_matmul_stacked(x, w8_all, s_all, layer_idx, *, plain: bool = False) -> torch.Tensor:
    """x (..., d) @ dequant(w8_all (L, d, n)[layer_idx]) -> (..., n) in x's
    dtype through a bf16 result (B10a; its input gradient B10b). The frozen
    base: a gradient in x only."""
    return _Int8Stacked.apply(x, w8_all, s_all, int(layer_idx), plain)


def int8_lora_matmul_stacked(x, w8_all, s_all, a, b, ls, layer_idx, *,
                             plain: bool = False) -> torch.Tensor:
    """The fused QLoRA projection x @ dequant(W8[l]) + ls * (x @ a) @ b, the
    delta accumulated in the kernel's f32 output tile (B10a; B10b and the
    thin adapter products in the backward). a (d, r) and b (r, n) are this
    layer's adapter views; ls = alpha / r gets a zero gradient."""
    if not isinstance(ls, torch.Tensor):
        ls = torch.tensor(float(ls), dtype=torch.float32, device=x.device)
    return _Int8LoraStacked.apply(x, w8_all, s_all, a, b, ls, int(layer_idx), plain)
