"""The port's int4 weights and int8 KV cache against the JAX package's.

- The quantizers (int4 packing and tiling, the int8 head, the int8 KV rows)
  give bytes and scales bit-identical to the JAX package's.
- The plain versions of kernels B4b (int4 GEMV), B5b (int4 prefill matmul)
  and B6 (decode attention over the int8 cache) are held against the Pallas
  kernels, run in interpret mode off the TPU, on the same numpy inputs.
  B4b's plain version is the exact product; the Pallas GEMV's biased-nibble
  bf16 algebra is not, so both are also held against the float64 product.
- The int4 decoder with the int8 cache, at the tiny preset with the JAX
  package's int4 weights carried over by `from_jax_params`: decode against
  JAX's decoder with the exactly dequantized weights (both exact products),
  prefill against JAX's int4 decoder (both take B5b's roundings).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.convert.jax_to_hf import export_handsonvlm
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.models import llama as jllama
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops import int8_matmul as j8
from handsonvlm_tpu.ops.decode_attention import (
    decode_attention_stacked_q as jax_decode_attention_stacked_q,
)
from handsonvlm_torch.config import get_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.models import llama as tllama
from handsonvlm_torch.ops import int8_matmul as t8
from handsonvlm_torch.ops.decode_attention import (
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
)
from test_torch_kernels import DECODE_CASES, INT4_SHAPES, decode_inputs, quantize_cache


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


# ---------------------------------------------------------------------------
# Quantizers: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,n", [(256, 384), (384, 512), (64, 192), (96, 40)])
def test_quantize_int4_bit_equal(d, n):
    """Group 128, or gcd(d, 128) for d not a multiple of 128 (tiny's d=64,
    and 96 -> 32); a zero column takes scale 1."""
    w = rand((d, n), d + n, 0.05)
    w[:, 3] = 0.0
    want = j8.quantize_int4(jnp.asarray(w))
    w4, gs = t8.quantize_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(w4.numpy(), np.asarray(want["w4"]))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(want["gscale"]))
    np.testing.assert_array_equal(t8.unpack_int4(w4).numpy(),
                                  np.asarray(j8._unpack_int4(want["w4"], jnp.float32)))


@pytest.mark.parametrize("d,n", [(384, 1536), (64, 192), (128, 64)])
def test_tile_int4_stacked_bit_equal(d, n):
    qs = [j8.quantize_int4(jnp.asarray(rand((d, n), d + i, 0.05))) for i in range(2)]
    w4 = np.stack([np.asarray(q["w4"]) for q in qs])
    gs = np.stack([np.asarray(q["gscale"]) for q in qs])
    want = j8.tile_int4_stacked(jnp.asarray(w4), jnp.asarray(gs))
    w4t, gst = t8.tile_int4_stacked(torch.from_numpy(w4), torch.from_numpy(gs))
    np.testing.assert_array_equal(w4t.numpy(), np.asarray(want["w4t"]))
    np.testing.assert_array_equal(gst.numpy(), np.asarray(want["gst"]))
    assert t8.tiled_shapes(d, n, 2) == (tuple(w4t.shape), tuple(gst.shape))


@pytest.mark.parametrize("shape", list(INT4_SHAPES))
def test_pick_block_n_matches_jax(shape):
    """The tile width that froze the JAX package's checkpoint layout, at the
    tiny and 7B projections."""
    din, dout = INT4_SHAPES[shape]
    g = t8.int4_group(din)
    assert t8.pick_block_n(dout, din // 2) == j8._pick_block_n(dout, (din // g) * (g // 2))


def test_quantize_int8_and_lm_head_bit_equal():
    w = rand((64, 300), 1, 0.02)
    w[:, 7] = 0.0
    w8, scale = t8.quantize_int8(torch.from_numpy(w), axis=0)
    want8, want_scale = j8.quantize_int8(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(w8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    # the head: the JAX package's (d, V) per-vocab-column table is the
    # port's (V, d) table transposed, one scale per vocab entry
    want = j8.quantize_lm_head({"lm_head": {"weight": jnp.asarray(w)}})["lm_head"]
    hw8, hscale = t8.quantize_lm_head(torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(hw8.numpy().T, np.asarray(want["w8"]))
    np.testing.assert_array_equal(hscale.numpy(), np.asarray(want["scale"]))


def test_quantize_kv_rows_and_cache_bit_equal():
    k, v = rand((2, 2, 16, 4, 16), 2), rand((2, 2, 16, 4, 16), 3)
    k[1, 0, 5, 2] = 0.0  # an all-zero row takes scale 1
    q8, sc = tllama._quantize_kv_rows(torch.from_numpy(k))
    want8, want_sc = jllama._quantize_kv_rows(jnp.asarray(k))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want_sc))
    got = tllama.quantize_kv_cache(
        tllama.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v), index=11))
    want = jllama.quantize_kv_cache(
        jllama.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), index=jnp.asarray(11)))
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.index == int(want.index) == 11


# ---------------------------------------------------------------------------
# Plain versions of the kernels against the Pallas kernels
# ---------------------------------------------------------------------------


def _tiled_weights(d, n, layers, seed):
    """JAX-quantized and -tiled weights (numpy) and their exact dequantized
    values (float64, `_unpack_int4` x `gscale`) per layer."""
    qs = [j8.quantize_int4(jnp.asarray(rand((d, n), seed + i, 0.05))) for i in range(layers)]
    exact = [(np.asarray(j8._unpack_int4(q["w4"], jnp.float32), np.float64)
              * np.asarray(q["gscale"], np.float64)[:, None, :]).reshape(d, n) for q in qs]
    tiled = j8.tile_int4_stacked(jnp.stack([q["w4"] for q in qs]),
                                 jnp.stack([q["gscale"] for q in qs]))
    return np.array(tiled["w4t"]), np.array(tiled["gst"]), exact


@pytest.mark.parametrize("m", [1, 3, 8, 100])
@pytest.mark.parametrize("d", [128, 384])
def test_int4_gemv_plain_vs_exact_and_pallas(d, m):
    """B4b's plain version is the exact product (mean-relative <= 1e-5 from
    float64, and nearer than the Pallas kernel), and within 5e-2
    mean-relative of the Pallas kernel's biased-nibble bf16 algebra."""
    w4t, gst, exact = _tiled_weights(d, 256, 2, seed=d + m)
    x = rand((m, d), m, 0.3)
    for layer in (0, 1):
        want = x.astype(np.float64) @ exact[layer]
        got = t8.int4_gemv_tiled_ref(torch.from_numpy(x), torch.from_numpy(w4t),
                                     torch.from_numpy(gst), layer).numpy()
        pallas = np.asarray(j8._int4_gemv_tiled(jnp.asarray(x), jnp.asarray(w4t),
                                                jnp.asarray(gst), layer))
        assert mean_rel(got, want) <= 1e-5, (layer, mean_rel(got, want))
        assert mean_rel(got, want) < mean_rel(pallas, want)
        assert mean_rel(got, pallas) <= 5e-2, mean_rel(got, pallas)


@pytest.mark.parametrize("m", [128, 200])
def test_int4_prefill_plain_vs_pallas(m):
    """B5b's plain version makes the Pallas kernel's bf16 roundings (x, and
    each weight as bf16(bf16(nibble) x bf16(scale))) with f32 accumulation:
    within 1e-3 x max|y| of `int4_matmul_prefill_tiled`."""
    w4t, gst, _ = _tiled_weights(384, 512, 2, seed=m)
    x = rand((1, m, 384), m, 0.3)
    for layer in (0, 1):
        want = np.asarray(j8.int4_matmul_prefill_tiled(jnp.asarray(x), jnp.asarray(w4t),
                                                        jnp.asarray(gst), layer))
        got = t8.int4_matmul_prefill_tiled_ref(torch.from_numpy(x), torch.from_numpy(w4t),
                                               torch.from_numpy(gst), layer).numpy()
        assert got.shape == want.shape == (1, m, 512)
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_int4_wrappers_on_cpu_and_dispatch():
    """On CPU tensors the wrappers run their plain versions (no launch), and
    int4_matmul_stacked sends fewer than 128 rows to B4b, more to B5b."""
    w4t, gst, _ = _tiled_weights(128, 256, 2, seed=5)
    w4t, gst = torch.from_numpy(w4t), torch.from_numpy(gst)
    before = (t8.int4_gemv_tiled.LAUNCHES, t8.int4_matmul_prefill_tiled.LAUNCHES)
    for rows, ref in ((127, t8.int4_gemv_tiled_ref), (128, t8.int4_matmul_prefill_tiled_ref)):
        x = torch.from_numpy(rand((rows, 128), rows))
        want = ref(x, w4t, gst, 1)
        torch.testing.assert_close(t8.int4_matmul_stacked(x, w4t, gst, 1), want,
                                   atol=0, rtol=0)
        torch.testing.assert_close(t8.int4_matmul_stacked(x, w4t, gst, 1, plain=True), want,
                                   atol=0, rtol=0)
    x = torch.from_numpy(rand((2, 128), 1))
    torch.testing.assert_close(t8.int4_gemv_tiled(x, w4t, gst, 0),
                               t8.int4_gemv_tiled_ref(x, w4t, gst, 0), atol=0, rtol=0)
    assert (t8.int4_gemv_tiled.LAUNCHES, t8.int4_matmul_prefill_tiled.LAUNCHES) == before


@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_decode_attention_q_ref_matches_pallas(case):
    """B6's plain version against `decode_attention_stacked_q` over the same
    int8 cache and scales, fp32, atol = rtol = 1e-5."""
    L, B, S, H, K, D, T, layer, length, mask_kind = DECODE_CASES[case]
    q, ck, cv, mask = decode_inputs(L, B, S, H, K, D, T, mask_kind, seed=len(case))
    k8, v8, ks, vs = quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))
    want = jax_decode_attention_stacked_q(
        jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in (k8, v8, ks, vs)), layer, length,
        key_mask=None if mask is None else jnp.asarray(mask), block_k=16)
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = decode_attention_stacked_q_ref(torch.from_numpy(q), k8, v8, ks, vs, layer, length,
                                         key_mask=t_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if mask_kind == "dead_row":
        assert not got[1].any() and not np.asarray(want)[1].any()
    before = decode_attention_stacked_q.LAUNCHES
    cpu = decode_attention_stacked_q(torch.from_numpy(q), k8, v8, ks, vs, layer, length,
                                     key_mask=t_mask)
    assert decode_attention_stacked_q.LAUNCHES == before  # no kernel on the CPU
    torch.testing.assert_close(cpu, got, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Weights carried across, and the int4 decoder with the int8 cache
# ---------------------------------------------------------------------------


def dense_from_int4(llama_params, lcfg):
    """The JAX int4 llama tree with its projections exactly dequantized
    (`_unpack_int4` x `gst`) into the dense layout; the int8 head stays."""
    def deq(leaf):
        w4t, gst = np.asarray(leaf["w4t"]), np.asarray(leaf["gst"])
        L, nb, G, half, bn = w4t.shape
        flat = jnp.asarray(w4t.transpose(2, 3, 0, 1, 4).reshape(G, half, L * nb * bn))
        q = np.asarray(j8._unpack_int4(flat, jnp.float32)).reshape(G, 2 * half, L, nb, bn)
        w = q * gst.transpose(2, 0, 1, 3)[:, None]
        return jnp.asarray(w.transpose(2, 0, 1, 3, 4).reshape(L, G * 2 * half, nb * bn))

    int4 = llama_params["layers"]["int4"]
    hq, hk = lcfg.num_heads * lcfg.head_dim_, lcfg.kv_heads * lcfg.head_dim_
    wqkv, wgu = deq(int4["wqkv"]), deq(int4["wgu"])
    f = lcfg.intermediate_size
    layers = {
        "attn": {"wq": wqkv[..., :hq], "wk": wqkv[..., hq:hq + hk], "wv": wqkv[..., hq + hk:],
                 "wo": deq(int4["wo"])},
        "mlp": {"w_gate": wgu[..., :f], "w_up": wgu[..., f:], "w_down": deq(int4["w_down"])},
        "attn_norm": llama_params["layers"]["attn_norm"],
        "mlp_norm": llama_params["layers"]["mlp_norm"],
    }
    return dict(llama_params, layers=layers)


@pytest.fixture(scope="module")
def int4_pair():
    """JAX int4 params (`init_llama_int4` through the JAX builder), their
    dense dequantized llama tree, and the port's int4 model holding the
    same bytes."""
    params, jcfg, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize="int4")
    model = build_model(get_config("tiny"), "cpu", quantize="int4")
    load_state_dict_into(model, from_jax_params(params))
    return params, jcfg, dense_from_int4(params["llama"], jcfg.llama), model


def test_from_jax_params_carries_the_int4_tree(int4_pair):
    params, jcfg, _, model = int4_pair
    for name, leaf in params["llama"]["layers"]["int4"].items():
        np.testing.assert_array_equal(model.llama.int4[name].w4t.numpy(),
                                      np.asarray(leaf["w4t"]))
        np.testing.assert_array_equal(model.llama.int4[name].gst.numpy(),
                                      np.asarray(leaf["gst"]))
    head = params["llama"]["lm_head"]
    vocab = jcfg.llama.vocab_size
    np.testing.assert_array_equal(model.llama.lm_head.w8.numpy(),
                                  np.asarray(head["w8"])[:, :vocab].T)
    np.testing.assert_array_equal(model.llama.lm_head.scale.numpy(),
                                  np.asarray(head["scale"])[:vocab])
    assert model.llama.lm_head.w8.shape == (32101, jcfg.llama.hidden_size)


def test_from_jax_params_matches_export():
    """The port's own name mapping gives, key for key, the arrays of the
    JAX package's exporter (dense tiny preset)."""
    params = jax.jit(lambda k: init_handsonvlm(k, jax_tiny_config()))(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    want = export_handsonvlm(host, vocab_size=32101)
    got = from_jax_params(params)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _decode_setup(jcfg, dense):
    """A JAX prefill of 10 positions (left pad in row 1) with the dense
    dequantized weights, its cache quantized to int8 by JAX; the port's
    QuantKVCache holds the same bytes."""
    embeds = rand((2, 10, jcfg.llama.hidden_size), 7)
    mask = np.ones((2, 16), bool)
    mask[1, :2] = False
    cache = jllama.KVCache.create(jcfg.llama, 2, 16, jnp.float32)
    _, cache = jllama.apply_llama(dense, jcfg.llama, inputs_embeds=jnp.asarray(embeds),
                                  attn_mask=jnp.asarray(mask), kv_cache=cache)
    jq = jllama.quantize_kv_cache(cache)
    tq = tllama.QuantKVCache(*(torch.from_numpy(np.array(getattr(jq, n)))
                               for n in ("k", "v", "ks", "vs")), index=10)
    return jq, tq, mask


@pytest.mark.parametrize("t", [1, 4])
def test_int4_kv8_decode_matches_jax(int4_pair, t):
    """Cached decode over the int8 cache with int4 weights (B4b and B6
    plain versions) against JAX's decoder over its QuantKVCache with the
    exactly dequantized weights: both exact products, rel L2 <= 1e-4. JAX's
    own int4 decoder (the Pallas GEMV's bf16 algebra) within 5e-2."""
    params, jcfg, dense, model = int4_pair
    jq, tq, mask = _decode_setup(jcfg, dense)
    step = rand((2, t, jcfg.llama.hidden_size), 8 + t)
    want, jq_after = jllama.apply_llama(dense, jcfg.llama, inputs_embeds=jnp.asarray(step),
                                        attn_mask=jnp.asarray(mask), kv_cache=jq)
    got, tq = tllama.apply_llama(model.llama, jcfg.llama, inputs_embeds=torch.from_numpy(step),
                                 attn_mask=torch.from_numpy(mask), kv_cache=tq)
    assert isinstance(tq, tllama.QuantKVCache) and tq.index == int(jq_after.index) == 10 + t
    assert rel_l2(got.numpy(), want) <= 1e-4, rel_l2(got.numpy(), want)
    np.testing.assert_allclose(tq.ks[:, :, :, 10:10 + t].numpy(),
                               np.asarray(jq_after.ks)[:, :, :, 10:10 + t], rtol=1e-5)
    logits = tllama.lm_logits(model.llama, jcfg.llama, got)
    want_logits = jllama.lm_logits(dense, jcfg.llama, want)
    assert rel_l2(logits.numpy(), want_logits) <= 1e-4
    jq, _, _ = _decode_setup(jcfg, dense)
    jax_int4, _ = jllama.apply_llama(params["llama"], jcfg.llama,
                                     inputs_embeds=jnp.asarray(step),
                                     attn_mask=jnp.asarray(mask), kv_cache=jq)
    assert rel_l2(got.numpy(), jax_int4) <= 5e-2, rel_l2(got.numpy(), jax_int4)


def test_int4_prefill_matches_jax(int4_pair):
    """A 130-row forward (every projection on B5b's plain version) against
    JAX's int4 decoder (the Pallas prefill kernel), rel L2 <= 1e-3."""
    params, jcfg, _, model = int4_pair
    embeds = rand((1, 130, jcfg.llama.hidden_size), 9)
    want, _ = jllama.apply_llama(params["llama"], jcfg.llama, inputs_embeds=jnp.asarray(embeds))
    before = t8.int4_matmul_prefill_tiled.LAUNCHES
    got, _ = tllama.apply_llama(model.llama, jcfg.llama, inputs_embeds=torch.from_numpy(embeds))
    assert t8.int4_matmul_prefill_tiled.LAUNCHES == before
    assert rel_l2(got.numpy(), want) <= 1e-3, rel_l2(got.numpy(), want)


def test_quantize_llama_int4_round_trip():
    """quantize_llama_int4 on a dense port model gives the bytes the JAX
    package's quantize_llama_int4 gives for the same weights, and
    dequantize_llama restores the exactly dequantized dense weights."""
    params = jax.jit(lambda k: init_handsonvlm(k, jax_tiny_config()))(jax.random.PRNGKey(1))
    cfg = get_config("tiny")
    model = build_model(cfg, "cpu")
    load_state_dict_into(model, from_jax_params(params))
    tllama.quantize_llama_int4(model.llama, cfg.llama)
    want = j8.quantize_llama_int4(params["llama"])
    for name, leaf in want["layers"]["int4"].items():
        np.testing.assert_array_equal(model.llama.int4[name].w4t.numpy(),
                                      np.asarray(leaf["w4t"]))
        np.testing.assert_array_equal(model.llama.int4[name].gst.numpy(),
                                      np.asarray(leaf["gst"]))
    np.testing.assert_array_equal(model.llama.lm_head.w8.numpy(),
                                  np.asarray(want["lm_head"]["w8"]).T)
    assert model.llama.layers[0].self_attn is None  # dense projections freed
    tllama.dequantize_llama(model.llama, cfg.llama, torch.float32)
    dense = dense_from_int4(want, cfg.llama)
    np.testing.assert_array_equal(model.llama.layers[1].mlp.down_proj.weight.numpy(),
                                  np.asarray(dense["layers"]["mlp"]["w_down"])[1].T)


def test_load_pretrained_int4_random_and_kv8_generate():
    """`load_pretrained_model(..., quantize="int4")` builds the int4 layout
    from the random init, and generate_host decodes over the int8 cache."""
    from handsonvlm_torch.infer.sampler import generate_host

    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu", quantize="int4")
    assert model.llama.int4 is not None and isinstance(model.llama.lm_head, tllama.Int8Head)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 1000, size=(1, 10))
    ids[0, 1] = cfg.image_token_index
    frames = rng.normal(size=(1, cfg.num_frames, 3, 56, 56)).astype(np.float32)
    out = generate_host(model, cfg, ids, frames, None, max_new_tokens=4, temperature=0.0,
                        kv_quant="int8")
    assert out.sequences.shape == (1, 4) and int(out.num_tokens[0]) >= 1
    with pytest.raises(ValueError, match="kv_quant"):
        generate_host(model, cfg, ids, frames, None, max_new_tokens=2, kv_quant="int4")


def _heavy(rng, shape, std=0.02, df=4.0, out_frac=0.01, out_scale=20.0):
    """Heavy-tailed weights with outlier columns (tests/test_int4_quality.py)."""
    t = rng.standard_t(df, size=shape) / np.sqrt(df / (df - 2.0))
    w = (t * std).astype(np.float32)
    cols = rng.choice(shape[-1], max(1, int(out_frac * shape[-1])), replace=False)
    w[..., cols] *= out_scale
    return w


@pytest.mark.parametrize("rows", [24, 130])
def test_int4_quality_bound(rows):
    """The int4 quality bound the JAX package serves under
    (tests/test_int4_quality.py): with heavy-tailed, outlier-column weights
    the port's int4 decoder (exact GEMV at 24 rows, the bf16-rounding
    prefill matmul at 130) stays within 0.05 nats of mean logit KL of the
    dense model, and one int4 matmul within 0.35 relative L2."""
    from handsonvlm_torch.config import LlamaConfig

    cfg = LlamaConfig(vocab_size=32101, hidden_size=128, intermediate_size=256,
                      num_layers=3, num_heads=4)
    rng = np.random.default_rng(0)
    llama = tllama.Llama(cfg)
    with torch.no_grad():  # heavy-tailed projections; embedding and head N(0, 0.02)
        llama.init_weights(torch.Generator().manual_seed(0))
        for name, p in llama.named_parameters():
            if name.endswith("proj.weight"):
                p.copy_(torch.from_numpy(_heavy(rng, tuple(p.shape[::-1])).T.copy()))
    ids = torch.from_numpy(np.random.default_rng(7).integers(3, 30000, size=(1, rows)))

    @torch.no_grad()
    def logits():
        h, _ = tllama.apply_llama(llama, cfg, input_ids=ids, attn_impl="xla")
        return tllama.lm_logits(llama, cfg, h)[0].double().numpy()

    dense = logits()
    w = llama.layers[0].mlp.down_proj.weight.detach().t().contiguous()
    tllama.quantize_llama_int4(llama, cfg)
    quant = logits()
    pr = np.exp(dense - dense.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    pq = np.exp(quant - quant.max(-1, keepdims=True))
    pq /= pq.sum(-1, keepdims=True)
    kl = float((pr * (np.log(pr + 1e-12) - np.log(pq + 1e-12))).sum(-1).mean())
    assert kl < 0.05, kl
    x = torch.from_numpy(rand((4, w.shape[0]), 3))
    down = llama.int4["w_down"]
    got = t8.int4_gemv_tiled_ref(x, down.w4t, down.gst, 0)
    assert rel_l2(got.numpy(), (x @ w).numpy()) < 0.35
