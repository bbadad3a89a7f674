"""Attention: the plain reference and the dispatch to the Hopper kernels.

Port of `handsonvlm_tpu/ops/attention.py`. All functions take q (B,T,H,D),
k/v (B,S,K,D), an optional boolean key mask (B,S) and causal masking, and
return (B,T,H,D).

- ``xla``    plain PyTorch transcription of the JAX `attention_xla`: fp32
             scores, NEG_INF bias, fp32 softmax, probabilities cast to
             q's dtype before the P.V product.
- ``flash``  blockwise attention without the (T, S) score tensor
             (ops/flash_attention, kernel B3), for prefill-sized queries;
             k/v may be a view of a cache layer, read in place.
- ``stacked`` cached attention of a window of T <= MAX_T_WINDOW rows over
             one layer of the decode cache (`decode_length` given), served
             by the stacked decode kernel (B1) over a one-layer view.
- ``decode`` the JAX package's single-query `decode_attention` over one
             layer's own (B, S, K, D) cache (kernel B12) for T == 1; a
             window of 2..MAX_T_WINDOW rows, which that function does not
             take, goes the ``stacked`` way.
- ``vit``    non-causal unmasked CLIP attention (ops/vit_attention).
- ``auto``   cached windows go to ``stacked`` on every device, as the JAX
             package's decoder layer routes them to its stacked kernel
             (the wrapper runs its plain version on a CPU tensor).
             Otherwise the tensor's device decides: on a CUDA tensor
             ``vit`` wherever `vit_attention_ok` holds (no batch-size
             crossover), ``flash`` under the JAX package's rule
             (T >= FLASH_MIN_T and a head size of 128 or 256), else
             ``xla``; on a CPU tensor ``xla``, as the JAX package does off
             the TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from handsonvlm_torch.ops.decode_attention import (
    MAX_T_WINDOW,
    BlockList,
    decode_attention,
    decode_attention_stacked,
)
from handsonvlm_torch.ops.flash_attention import flash_attention
from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ok

NEG_INF = -1e30
FLASH_MIN_T = 2048  # query rows from which `auto` takes the flash kernel


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,K*n_rep,D) for grouped-query attention."""
    if n_rep == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, d).reshape(b, s, k * n_rep, d)


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset=0,
) -> torch.Tensor:
    """Reference attention; softmax in fp32.

    ``q_offset`` is the absolute position of q[:, 0] (int or (B,) tensor),
    used for causal masking during cached decode."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    if kh != h:
        k = _repeat_kv(k, h // kh)
        v = _repeat_kv(v, h // kh)

    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale

    bias = torch.zeros((b, 1, t, s), dtype=torch.float32, device=q.device)
    if key_mask is not None:
        bias = torch.where(key_mask.bool()[:, None, None, :], bias, NEG_INF)
    if causal:
        offset = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
        q_pos = torch.arange(t, device=q.device)[None, :] + offset
        k_pos = torch.arange(s, device=q.device)
        causal_ok = q_pos[:, :, None] >= k_pos[None, None, :]
        bias = torch.where(causal_ok[:, None, :, :], bias, NEG_INF)

    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset=0,
    impl: str = "auto",
    decode_length: Optional[int] = None,
    blocks: Optional[BlockList] = None,
) -> torch.Tensor:
    """Attention entry point used by the models.

    `decode_length` (valid cache positions, = q_offset + T) marks k/v as one
    layer of the decode cache and enables the decode kernels; `blocks` is
    the forward's compacted block list for the stacked one (built there
    when None)."""
    if impl == "auto":
        impl = _best_impl(q, k, v, decode_length, key_mask=key_mask, causal=causal)
    if impl == "vit":
        return vit_attention(q, k, v)
    if impl in ("decode", "stacked"):
        if decode_length is None:
            raise ValueError(f"impl={impl!r} needs decode_length")
        mask = None if key_mask is None else key_mask.bool().contiguous()
        if impl == "decode" and q.shape[1] == 1:
            return decode_attention(q, k, v, decode_length, key_mask=mask)
        # k, v (B,S,K,D) are one layer: a leading-axis view is the stacked layout
        return decode_attention_stacked(q, k[None], v[None], 0, decode_length,
                                        key_mask=mask, blocks=blocks)
    if impl == "flash":
        mask = None if key_mask is None else key_mask.bool().contiguous()
        return flash_attention(q, k, v, key_mask=mask, causal=causal, q_offset=q_offset)[0]
    if impl == "xla":
        return attention_xla(q, k, v, key_mask=key_mask, causal=causal, q_offset=q_offset)
    raise ValueError(f"unknown attention impl {impl!r}")


def _best_impl(q, k, v, decode_length=None, *, key_mask=None, causal=True) -> str:
    if decode_length is not None and q.shape[1] <= MAX_T_WINDOW:
        return "stacked"
    if not q.is_cuda:
        return "xla"
    if vit_attention_ok(q, k, v, key_mask, causal):
        return "vit"
    # with or without a gradient: the flash kernel's backward is B3b, as
    # the JAX package's `_best_impl` takes flash for training rows too
    if q.shape[1] >= FLASH_MIN_T and q.shape[3] in (128, 256):
        return "flash"
    return "xla"
