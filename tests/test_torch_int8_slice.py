"""The port's int8 weight-only decoder and the decoders over the flat int4
layouts against the JAX package's, at the tiny preset in fp32 on the CPU
(every op runs its plain version).

- Three decoder trees the JAX package's `apply_llama` takes, carried over
  by `from_jax_params`: per-projection int8 (`quantize_llama`), fused flat
  int4 and per-projection flat int4. Prefill and cached steps against JAX's
  decoder, relative L2 1e-5 where both sides take the exact product (int8;
  int4 against JAX with the weights exactly dequantized), 1e-3 where both
  round to bf16 (the fused flat int4 prefill, B5a and the Pallas prefill).
- An 8-token greedy prefix with quantize="int8" equal to JAX's, and greedy
  `generate_spec` equal to sequential decode and to JAX's `generate_spec`
  on the same int8 tree.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer import speculative as jspec
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.infer.sampler import generate_host as jax_generate_host
from handsonvlm_tpu.models import llama as jllama
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops import int8_matmul as j8
from handsonvlm_torch.config import get_config
from handsonvlm_torch.convert.from_hf import from_jax_params, quantize_mode
from handsonvlm_torch.infer.sampler import generate_host
from handsonvlm_torch.infer.speculative import generate_spec
from handsonvlm_torch.models import llama as tllama
from test_torch_int8 import _port, _t
from test_torch_quant import rand, rel_l2
from test_torch_spec import KW, _bank, _prompt

JCFG = jax_tiny_config()
CFG = get_config("tiny")


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(3))


# ---------------------------------------------------------------------------
# The decoder trees carried across, against JAX's apply_llama
# ---------------------------------------------------------------------------


def _stack_int4(ws):
    """[(L, din, dout_i)] -> the flat int4 leaf of their concatenation on
    dout, quantized layer by layer by JAX's quantize_int4."""
    qs = [j8.quantize_int4(jnp.concatenate([w[i] for w in ws], axis=1))
          for i in range(ws[0].shape[0])]
    return {"w4": jnp.stack([q["w4"] for q in qs]), "gscale": jnp.stack([q["gscale"] for q in qs])}


def _jax_tree(llama, name):
    """The JAX llama tree of decoder layout `name` from a dense one."""
    if name == "int8":
        return j8.quantize_llama(llama)
    layers = llama["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    norms = {"attn_norm": layers["attn_norm"], "mlp_norm": layers["mlp_norm"]}
    if name == "int4_flat":
        quant = {"int4": {"wqkv": _stack_int4([attn["wq"], attn["wk"], attn["wv"]]),
                          "wo": _stack_int4([attn["wo"]]),
                          "wgu": _stack_int4([mlp["w_gate"], mlp["w_up"]]),
                          "w_down": _stack_int4([mlp["w_down"]])}}
    else:
        quant = {grp: {k: _stack_int4([v]) for k, v in layers[grp].items()}
                 for grp in ("attn", "mlp")}
    return j8.quantize_lm_head(dict(llama, layers={**quant, **norms}))


def _dequantized(llama):
    """A flat int4 tree with its projections exactly dequantized (f32) into
    the dense layout; the int8 head stays."""
    def deq(leaf):
        w4, gs = np.asarray(leaf["w4"]), np.asarray(leaf["gscale"])
        q = np.stack([np.asarray(j8._unpack_int4(jnp.asarray(w), jnp.float32)) for w in w4])
        return jnp.asarray((q * gs[:, :, None, :]).reshape(w4.shape[0], -1, w4.shape[-1]))

    layers = llama["layers"]
    if "int4" in layers:
        i4, lc = layers["int4"], JCFG.llama
        qh, kh, f = lc.num_heads * lc.head_dim_, lc.kv_heads * lc.head_dim_, lc.intermediate_size
        wqkv, wgu = deq(i4["wqkv"]), deq(i4["wgu"])
        dense = {"attn": {"wq": wqkv[..., :qh], "wk": wqkv[..., qh:qh + kh],
                          "wv": wqkv[..., qh + kh:], "wo": deq(i4["wo"])},
                 "mlp": {"w_gate": wgu[..., :f], "w_up": wgu[..., f:],
                         "w_down": deq(i4["w_down"])}}
    else:
        dense = {grp: {k: deq(v) for k, v in layers[grp].items()} for grp in ("attn", "mlp")}
    return dict(llama, layers={**dense, "attn_norm": layers["attn_norm"],
                               "mlp_norm": layers["mlp_norm"]})


TREES = ["int8", "int4_flat", "int4_proj"]


@pytest.fixture(scope="module")
def trees(jparams):
    """name -> (JAX params with that decoder tree, the JAX llama tree that
    takes the exact product of the same weights (the tree itself for int8,
    the dequantized one for int4), the port's model holding the bytes)."""
    out = {}
    for name in TREES:
        params = dict(jparams, llama=_jax_tree(jparams["llama"], name))
        exact = params["llama"] if name == "int8" else _dequantized(params["llama"])
        out[name] = (params, exact, _port(params))
    return out


@pytest.mark.parametrize("name", TREES)
def test_from_jax_params_carries_each_tree(trees, name):
    params, _, model = trees[name]
    sd = from_jax_params(params)
    assert quantize_mode(sd) == name
    layers = params["llama"]["layers"]
    held = model.llama.int4 if name == "int4_flat" else model.llama.proj
    leaves = (layers["int4"].items() if name == "int4_flat" else
              [kv for grp in ("attn", "mlp") for kv in layers[grp].items()])
    for key, leaf in leaves:
        for buf, value in leaf.items():
            np.testing.assert_array_equal(getattr(held[key], buf).numpy(), np.asarray(value))
    head = params["llama"]["lm_head"]
    np.testing.assert_array_equal(model.llama.lm_head.w8.numpy(),
                                  np.asarray(head["w8"])[:, :CFG.llama.vocab_size].T)


def test_from_jax_params_refuses_an_unknown_layout(trees):
    params = trees["int8"][0]
    layers = params["llama"]["layers"]
    bad = dict(params, llama=dict(params["llama"], layers=dict(
        layers, attn=dict(layers["attn"], wq={"w2": layers["attn"]["wq"]["w8"]}))))
    with pytest.raises(ValueError, match="no known weight layout"):
        from_jax_params(bad)
    fused_qlora = dict(params, llama=dict(params["llama"], layers=dict(layers, int8={})))
    with pytest.raises(ValueError, match="no known weight layout"):
        from_jax_params(fused_qlora)


@pytest.mark.parametrize("name", TREES)
def test_decoder_prefill_matches_jax(trees, name):
    """A 130-row forward (int8: B9's plain version at any m; fused flat int4:
    B5a's; per-projection int4: B4a's at any m) against JAX's decoder:
    relative L2 1e-5 from the exact product of the same weights; the fused
    flat int4 prefill, which rounds to bf16 on both sides, 1e-3 from JAX's
    own int4 decoder (the Pallas prefill kernel)."""
    params, exact, model = trees[name]
    embeds = rand((1, 130, JCFG.llama.hidden_size), 9)
    got, _ = tllama.apply_llama(model.llama, CFG.llama, inputs_embeds=torch.from_numpy(embeds))
    ref = params["llama"] if name == "int4_flat" else exact
    want, _ = jllama.apply_llama(ref, JCFG.llama, inputs_embeds=jnp.asarray(embeds))
    tol = 1e-3 if name == "int4_flat" else 1e-5
    assert rel_l2(got.numpy(), want) <= tol, rel_l2(got.numpy(), want)


# each tree with both caches and both a decode step and a verify window
CACHED = [("int8", 1, None), ("int8", 4, "int8"), ("int4_flat", 4, None),
          ("int4_flat", 1, "int8"), ("int4_proj", 1, None), ("int4_proj", 4, "int8")]


@pytest.mark.parametrize("name,t,kv_quant", CACHED)
def test_decoder_cached_steps_match_jax(trees, name, t, kv_quant):
    """Cached steps of t rows over a 10-row prefill (a left pad in row 1),
    bf16-free fp32, over JAX's cache carried across (float or int8): the
    port's hidden states and logits within relative L2 1e-5 of JAX's decoder
    taking the exact product of the same weights (int8 itself; int4
    dequantized: B4c's and B4a's plain versions are exact)."""
    params, exact, model = trees[name]
    lc = JCFG.llama
    embeds, step = rand((2, 10, lc.hidden_size), 7), rand((2, t, lc.hidden_size), 8 + t)
    mask = np.ones((2, 16), bool)
    mask[1, :2] = False
    cache = jllama.KVCache.create(lc, 2, 16, jnp.float32)
    _, cache = jllama.apply_llama(exact, lc, inputs_embeds=jnp.asarray(embeds),
                                  attn_mask=jnp.asarray(mask), kv_cache=cache)
    if kv_quant:
        cache = jllama.quantize_kv_cache(cache)
        tcache = tllama.QuantKVCache(*(_t(getattr(cache, n)) for n in ("k", "v", "ks", "vs")),
                                     index=10)
    else:
        tcache = tllama.KVCache(k=_t(cache.k), v=_t(cache.v), index=10)
    want, _ = jllama.apply_llama(exact, lc, inputs_embeds=jnp.asarray(step),
                                 attn_mask=jnp.asarray(mask), kv_cache=cache)
    got, tcache = tllama.apply_llama(model.llama, CFG.llama, inputs_embeds=torch.from_numpy(step),
                                     attn_mask=torch.from_numpy(mask), kv_cache=tcache)
    assert tcache.index == 10 + t
    assert rel_l2(got.numpy(), want) <= 1e-5, rel_l2(got.numpy(), want)
    logits = tllama.lm_logits(model.llama, CFG.llama, got)
    assert rel_l2(logits.numpy(), jllama.lm_logits(exact, lc, want)) <= 1e-5


# ---------------------------------------------------------------------------
# The int8 slice: greedy decode and speculative decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def builder_int8():
    """The JAX builder's random int8 tree (`init_llama_int8`, drawn directly
    as int8) and the port's model holding its bytes."""
    params, _, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize="int8")
    return params, _port(params)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("source", ["quantize_llama", "init_llama_int8"])
def test_int8_greedy_prefix_matches_jax(trees, builder_int8, source, kv_quant):
    params, model = (trees["int8"][0], trees["int8"][2]) if source == "quantize_llama" \
        else builder_int8
    ids, frames, frame_map = _prompt()
    want = jax_generate_host(params, JCFG, ids, frames, jax.random.PRNGKey(7), frame_map=frame_map,
                             kv_quant=kv_quant, **KW)
    got = generate_host(model, CFG, ids, frames, None, frame_map=frame_map, kv_quant=kv_quant,
                        **KW)
    np.testing.assert_array_equal(got.sequences[0, :8], np.asarray(want.sequences)[0, :8])


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_int8_spec_matches_sequential_and_jax(trees, kv_quant):
    """Greedy generate_spec on the int8 model, k = 3: with no bank and the
    gate on, token-identical to sequential decode; with the sequential
    continuation as the bank and the gate off, fewer forwards than tokens
    and the same tokens, forwards, drafts found and acceptance histogram as
    JAX's generate_spec on the same int8 tree."""
    params, _, model = trees["int8"]
    ids, frames, frame_map = _prompt()
    seq = generate_host(model, CFG, ids, frames, None, frame_map=frame_map, kv_quant=kv_quant,
                        **KW)
    out, _ = generate_spec(model, CFG, ids, frames, None, k=3, frame_map=frame_map,
                           kv_quant=kv_quant, **KW)
    np.testing.assert_array_equal(out.sequences, seq.sequences)
    bank = _bank(ids, seq)
    got, stats = generate_spec(model, CFG, ids, frames, None, k=3, frame_map=frame_map,
                               bank_ids=bank, kv_quant=kv_quant, gate_tok_per_fwd=0.0, **KW)
    want, wstats = jspec.generate_spec(
        params, JCFG, ids, frames, jax.random.PRNGKey(7), k=3, frame_map=frame_map,
        bank_ids=bank, kv_quant=kv_quant, gate_tok_per_fwd=0.0, attn_impl="xla", **KW)
    np.testing.assert_array_equal(got.sequences, seq.sequences)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    for key in ("iters", "drafts_found", "tokens", "accept_hist", "gated"):
        assert stats[key] == wstats[key], (key, stats, wstats)
    assert stats["iters"] < stats["tokens"]
