"""Full non-causal attention at CLIP ViT shapes.

Port of `handsonvlm_tpu/ops/vit_attention.py::vit_attention`: unmasked,
non-causal softmax attention over (B, T, H, 64) q, k, v, output in the same
layout (the packed (B, T, H*64) view of it).

`vit_attention` launches the hand-written Hopper kernel
(`csrc/vit_attention.cu`) for CUDA tensors and runs the plain version
`vit_attention_ref` for CPU tensors. There is no fallback: on a CUDA tensor
it launches the kernel or raises. `vit_attention.LAUNCHES` counts kernel
launches. Under grad mode with an input that requires grad it runs as a
`torch.autograd.Function` whose backward recomputes the plain version and
differentiates that, as the JAX package's custom_vjp recomputes through
XLA (`_vit_attention_bwd`); the kernel has no backward of its own, and the
frozen CLIP tower of training never asks for one.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64


def vit_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, as the Pallas kernel computes it: fp32 scores
    and softmax, probabilities cast to v's dtype before the P.V product."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * float(1.0 / (d ** 0.5))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v)


def vit_attention_ok(q, k, v, key_mask, causal: bool) -> bool:
    """Shapes the kernel serves: non-causal, unmasked, no GQA, D == 64."""
    return (not causal and key_mask is None and q.dim() == 4
            and q.shape == k.shape == v.shape and q.shape[-1] == HEAD_DIM)


def _launch(q, k, v):
    from handsonvlm_torch.ops._build import check, load_library

    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"vit attention takes bf16 or f32, got {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if q.dim() != 4 or not (q.shape == k.shape == v.shape) or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"vit attention needs equal (B, T, H, {HEAD_DIM}) "
                         f"shapes, got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hv_vit_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, t, h, float(1.0 / (d ** 0.5)),
            stream)
    check(status, "vit_attention")
    vit_attention.LAUNCHES += 1
    return out


def _forward(q, k, v):
    if q.is_cuda:
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return vit_attention_ref(q, k, v)
    raise ValueError(f"no vit attention for device {q.device}")


class _VitAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes `vit_attention_ref`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = vit_attention_ref(*inputs)
        return torch.autograd.grad(out, inputs, dout)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal unmasked self-attention, q/k/v/out (B, T, H, 64).

    CUDA tensors run the Hopper kernel; CPU tensors the plain version."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _VitAttention.apply(q, k, v)
    return _forward(q, k, v)


vit_attention.LAUNCHES = 0
