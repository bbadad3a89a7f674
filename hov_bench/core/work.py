"""Operations and bytes of the model's work, from its shapes alone.

Model FLOPs (for `mfu.*`) count the useful work once: the forward's
matrix products (2 x parameters x rows) and attention, the backward's
activation and weight gradients as the recipe needs them, never a
recomputation. A kernel's bytes count each input read once and each
output written once (for a roofline's bound).
"""

from __future__ import annotations

INT4_GROUP = 128


def decoder_params(cfg) -> int:
    """Matrix parameters of the decoder's layers (no embedding, no head)."""
    lc = cfg.llama
    d, f, hd = lc.hidden_size, lc.intermediate_size, lc.head_dim_
    per = d * (lc.num_heads + 2 * lc.kv_heads) * hd + lc.num_heads * hd * d + 3 * d * f
    return lc.num_layers * per


def head_params(cfg) -> int:
    return cfg.llama.vocab_size * cfg.llama.hidden_size


def lora_params(cfg, r: int) -> int:
    lc = cfg.llama
    d, f, hd = lc.hidden_size, lc.intermediate_size, lc.head_dim_
    qh, kh = lc.num_heads * hd, lc.kv_heads * hd
    pairs = [(d, qh), (d, kh), (d, kh), (qh, d), (d, f), (d, f), (f, d)]
    return lc.num_layers * sum(r * (a + b) for a, b in pairs)


def attention_flops(cfg, q_rows: int, keys: int) -> float:
    """QK^T and PV of `q_rows` queries each over `keys` keys, all layers."""
    lc = cfg.llama
    return 4.0 * q_rows * keys * lc.num_heads * lc.head_dim_ * lc.num_layers


def causal_attention_flops(cfg, t: int) -> float:
    """A causal prefill of t rows: each row over the keys up to it."""
    return attention_flops(cfg, 1, t * (t + 1) // 2)


def clip_flops(cfg, frames: int) -> float:
    """The CLIP layers that run (up to the selected one), the patch
    embedding and the projector, for `frames` frames."""
    v = cfg.vision
    tok = v.num_patches + 1
    layers = v.num_layers + v.select_layer + 1
    d, fc = v.hidden_size, v.intermediate_size
    per_layer = 2 * tok * (4 * d * d + 2 * d * fc) + 4 * tok * tok * d
    patch = 2 * v.num_patches * 3 * v.patch_size ** 2 * d
    proj = 2 * v.num_patches * cfg.mm_hidden_size * cfg.llama.hidden_size
    return frames * (layers * per_layer + patch + proj)


def decode_token_flops(cfg, context: int) -> float:
    """One generated token at `context` keys: the decoder, its attention
    and the head."""
    return 2.0 * (decoder_params(cfg) + head_params(cfg)) + attention_flops(cfg, 1, context)


def prefill_flops(cfg, rows: int, frames: int) -> float:
    """A request's join: CLIP over its unique frames, the decoder over its
    spliced prompt, and the head for its first token."""
    return (clip_flops(cfg, frames) + 2.0 * decoder_params(cfg) * rows
            + causal_attention_flops(cfg, rows) + 2.0 * head_params(cfg))


def qlora_step_flops(cfg, batch: int, rows: int, r: int, frames: int) -> float:
    """A QLoRA step: the forward (base, adapters, attention, head, CLIP),
    the base's and the head's activation gradients, attention's backward
    (twice its forward), and the adapters' and the projector's weight
    gradients (the CVAE head's are under a millionth of the step)."""
    n, nl, nh = decoder_params(cfg), lora_params(cfg, r), head_params(cfg)
    tokens = batch * rows
    attn = batch * causal_attention_flops(cfg, rows)
    proj = 2.0 * frames * cfg.vision.num_patches * cfg.mm_hidden_size * cfg.llama.hidden_size
    fwd = 2.0 * (n + nl + nh) * tokens + attn + batch * clip_flops(cfg, frames)
    bwd = 2.0 * (n + nh) * tokens + 2 * attn + 2.0 * nl * tokens + batch * proj
    return fwd + bwd


def int4_matmul_work(m: int, din: int, dout: int):
    """(flops, bytes) of x (m, din) bf16 @ an int4 (din, dout) weight with
    group-128 f32 scales -> (m, dout) bf16; the transposed product (dy (m,
    dout) @ W^T -> (m, din)) does the same work."""
    flops = 2.0 * m * din * dout
    nbytes = din * dout / 2 + (din // INT4_GROUP) * dout * 4 + 2.0 * m * (din + dout)
    return flops, nbytes


def int4_layer_shapes(cfg):
    """(din, dout) of the four fused int4 projections of a layer."""
    lc = cfg.llama
    d, f, hd = lc.hidden_size, lc.intermediate_size, lc.head_dim_
    return [(d, (lc.num_heads + 2 * lc.kv_heads) * hd), (lc.num_heads * hd, d),
            (d, 2 * f), (f, d)]


def decode_attention_work(cfg, valid_keys: int, rows: int, kv_bytes: float):
    """(flops, bytes) of one layer's decode attention for `rows` query rows
    (one token each) over `valid_keys` keys summed over the rows;
    `kv_bytes` per cached element (2 for bf16; 1 + 4 / head_dim for int8,
    whose k and v carry one f32 scale each a key and kv head)."""
    lc = cfg.llama
    hd = lc.head_dim_
    flops = 4.0 * valid_keys * lc.num_heads * hd
    nbytes = 2.0 * valid_keys * lc.kv_heads * hd * kv_bytes + 2.0 * 2 * rows * lc.num_heads * hd
    return flops, nbytes
