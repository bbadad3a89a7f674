"""The port's flash attention (kernel B3) against the JAX package's.

`flash_attention_ref`, the kernel's plain version, is held against the
Pallas kernel (interpret mode off the TPU) and against both packages'
plain `attention_xla` on the same numpy inputs in fp32, output and
logsumexp at atol 2e-5 / rtol 1e-4 (the tolerance of the JAX package's own
flash tests: another summation order). Then the slice: a tiny prefill and
an 8-token greedy prefix with attn_impl="flash" in both packages, with and
without left padding.

A query row with no valid key (left padding under causal masking) averages
some keys in the Pallas kernel and in `attention_xla`, over different key
sets, and gives 0 in the port. Such rows are never read, so they are left
out of every comparison here, as tests/test_flash_attention.py and
tests/test_left_padding.py leave them out.

The backward's plain version (`flash_attention_bwd_ref`, kernel B3b's) is
held against `jax.vjp` of the JAX package's flash_attention, which runs
the Pallas dq and dk/dv kernels.

The kernels themselves are held against their plain versions on the card,
in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.constants import IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.sampler import generate_host as jax_generate_host
from handsonvlm_tpu.infer.sampler import prefill as jax_prefill
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops.attention import attention_xla as jax_attention_xla
from handsonvlm_tpu.ops.flash_attention import _fwd_call
from handsonvlm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.infer.sampler import generate_host, prefill
from handsonvlm_torch.models.llama import KVCache, apply_llama
from handsonvlm_torch.ops.attention import attention_xla
from handsonvlm_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

TOL = dict(atol=2e-5, rtol=1e-4)

# (B, T, S, H, K, D, causal, q_offset, mask)
CASES = {
    "causal": (1, 40, 40, 2, 2, 32, True, 0, None),
    "noncausal": (1, 40, 40, 2, 2, 32, False, 0, None),
    "key_mask_hole": (1, 24, 24, 2, 2, 32, True, 0, "hole"),
    "q_offset_decode_shape": (1, 1, 32, 2, 2, 32, True, 20, "written"),
    "non_divisible": (1, 37, 37, 2, 2, 32, True, 0, None),
    "gqa": (2, 19, 26, 8, 2, 16, True, 7, "written"),
    "left_pad_prefill_over_cache": (2, 21, 40, 4, 4, 16, True, 0, "left_pad"),
    "noncausal_masked": (2, 9, 30, 4, 2, 16, False, 0, "left_pad"),
}


def _inputs(case):
    B, T, S, H, K, D, causal, q_offset, mask_kind = CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = np.zeros((B, S), bool)
        mask[:, :q_offset + T] = True  # the written prefix of a cache
        if mask_kind == "hole":
            mask[:, 5:9] = False
        if mask_kind == "left_pad":
            mask[0, :3] = False
            mask[-1, :6] = False
    return q, k, v, mask, causal, q_offset


def _valid_rows(mask, causal, q_offset, b, t, s):
    """(B, T) bool: the query rows with at least one valid key."""
    ok = np.ones((b, t, s), bool)
    if mask is not None:
        ok &= mask[:, None, :]
    if causal:
        ok &= (np.arange(t)[:, None] + q_offset >= np.arange(s)[None, :])[None]
    return ok.any(axis=-1)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_flash_ref_matches_pallas_and_xla(case):
    q, k, v, mask, causal, q_offset = _inputs(case)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got, lse = flash_attention_ref(tq, tk, tv, key_mask=tmask, causal=causal,
                                   q_offset=q_offset)
    assert got.shape == (b, t, h, d) and lse.shape == (b, h, t) and lse.dtype == torch.float32
    valid = _valid_rows(mask, causal, q_offset, b, t, s)

    pallas = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 key_mask=jmask, causal=causal, q_offset=q_offset,
                                 block_q=8, block_k=8)
    jxla = jax_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jmask,
                             causal=causal, q_offset=q_offset)
    txla = attention_xla(tq, tk, tv, key_mask=tmask, causal=causal, q_offset=q_offset)
    for name, want in (("pallas", pallas), ("jax xla", jxla), ("port xla", txla.numpy())):
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                                   err_msg=name, **TOL)
    # a row with no valid key: 0 and NEG_INF here (never read)
    assert not got.numpy()[~valid].any()
    assert (lse.numpy().transpose(0, 2, 1)[~valid] == np.float32(NEG_INF)).all()

    # the logsumexp against the forward call the Pallas backward reads it from:
    # (B, H, T, D) layouts, kv heads repeated, padded to the 8-row blocks
    pad_t, pad_s = -t % 8, -s % 8
    rep = h // kh
    qt = jnp.pad(jnp.asarray(q).transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, pad_t), (0, 0)))
    kt, vt = (jnp.pad(jnp.repeat(jnp.asarray(x), rep, axis=2).transpose(0, 2, 1, 3),
                      ((0, 0), (0, 0), (0, pad_s), (0, 0))) for x in (k, v))
    m32 = jnp.pad(jnp.asarray(np.ones((b, s), bool) if mask is None else mask, jnp.int32),
                  ((0, 0), (0, pad_s)))
    _, want_lse = _fwd_call(qt, kt, vt, m32, q_offset, causal=causal,
                            scale=float(1.0 / d ** 0.5), block_q=8, block_k=8)
    want_lse = np.asarray(want_lse)[:, :, 0, :t]  # (B, H, T)
    vh = np.broadcast_to(valid[:, None, :], (b, h, t))
    np.testing.assert_allclose(lse.numpy()[vh], want_lse[vh], **TOL)


def test_flash_wrapper_on_cpu_runs_plain_version():
    q, k, v, mask, causal, q_offset = _inputs("gqa")
    args = tuple(torch.from_numpy(x) for x in (q, k, v))
    before = flash_attention.LAUNCHES
    got, lse = flash_attention(*args, key_mask=torch.from_numpy(mask), causal=causal,
                               q_offset=q_offset)
    assert flash_attention.LAUNCHES == before  # no kernel on the CPU
    want, want_lse = flash_attention_ref(*args, key_mask=torch.from_numpy(mask),
                                         causal=causal, q_offset=q_offset)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)


def test_flash_reads_a_cache_layer_view():
    """k, v as a view of one layer of the stacked cache (and of its first n
    positions) give what contiguous copies give: nothing is assumed of the
    batch and token strides."""
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.normal(size=(3, 2, 30, 2, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(2, 12, 4, 16)).astype(np.float32))
    view_k, view_v = cache[1][:, :20], cache[2][:, :20]
    got, _ = flash_attention(q, view_k, view_v, q_offset=8)
    want, _ = flash_attention(q, view_k.contiguous(), view_v.contiguous(), q_offset=8)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- the slice: prefill and greedy decode with attn_impl="flash" ------------------------

JCFG = jax_tiny_config()
CFG = tiny_config()


@pytest.fixture(scope="module")
def params():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def port(params):
    model = build_model(CFG, "cpu")
    load_state_dict_into(model, from_jax_params(params))
    return model


def _prompt(pad=0):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(1, 12))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    frames = rng.normal(size=(1, 4, 3, 56, 56)).astype(np.float32)
    frame_map = np.tile(np.arange(4, dtype=np.int32), CFG.num_frames // 4)
    attn = None
    if pad:
        ids = np.concatenate([np.zeros((1, pad), np.int64), ids], axis=1)
        attn = np.concatenate([np.zeros((1, pad), bool), np.ones((1, 12), bool)], axis=1)
    return ids, frames, frame_map, attn


@pytest.mark.parametrize("pad", [0, 5], ids=["unpadded", "left_padded"])
def test_flash_prefill_matches_jax(params, port, pad):
    """The last hidden state and the written cache rows of a prefill with
    attn_impl="flash", fp32, atol 1e-4 (32 positions of a 2-layer decoder):
    valid rows only under left padding (a pad row's k/v are never read)."""
    ids, frames, frame_map, attn = _prompt(pad)
    max_len = ids.shape[1] + CFG.num_visual_tokens - 1 + 9
    jh, jcache, jmask = jax_prefill(
        params, JCFG, jnp.asarray(ids), jnp.asarray(frames), max_len, attn_impl="flash",
        attn_mask=None if attn is None else jnp.asarray(attn),
        frame_map=jnp.asarray(frame_map))
    th, tcache, tmask = prefill(
        port, CFG, torch.from_numpy(ids), torch.from_numpy(frames), max_len,
        attn_impl="flash", attn_mask=None if attn is None else torch.from_numpy(attn),
        frame_map=torch.from_numpy(frame_map))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    assert tcache.index == int(jcache.index)
    rows = np.asarray(jmask)[0, :tcache.index]
    np.testing.assert_allclose(tcache.k.numpy()[:, 0, :tcache.index][:, rows],
                               np.asarray(jcache.k)[:, 0, :tcache.index][:, rows],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pad", [0, 5], ids=["unpadded", "left_padded"])
def test_flash_greedy_prefix_matches_jax(params, port, pad):
    """Prefill through flash, then 8 greedy tokens: the same in both
    packages (a decode step under attn_impl="flash" stays plain in both)."""
    ids, frames, frame_map, attn = _prompt(pad)
    want = jax_generate_host(params, JCFG, ids, frames, jax.random.PRNGKey(7),
                             max_new_tokens=8, temperature=0.0, frame_map=frame_map,
                             attn_impl="flash", attn_mask=attn)
    got = generate_host(port, CFG, ids, frames, None, max_new_tokens=8, temperature=0.0,
                        frame_map=frame_map, attn_impl="flash", attn_mask=attn)
    np.testing.assert_array_equal(got.sequences[0, :8], np.asarray(want.sequences)[0, :8])
    plain = generate_host(port, CFG, ids, frames, None, max_new_tokens=8, temperature=0.0,
                          frame_map=frame_map, attn_impl="xla", attn_mask=attn)
    np.testing.assert_array_equal(got.sequences, plain.sequences)


def test_flash_window_stays_plain_and_prefill_takes_flash(port, monkeypatch):
    """attn_impl="flash": a prefill reaches flash_attention once per layer
    with q_offset = the cache index over the layer's view of the cache (no
    copy); a window of T <= 8 rows does not."""
    from handsonvlm_torch.ops import attention as attn_mod

    calls = []
    real = attn_mod.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw["q_offset"], k.data_ptr()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", spy)
    cache = KVCache.create(CFG.llama, 1, 40, torch.float32, "cpu")
    emb = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 20, CFG.llama.hidden_size)).astype(np.float32))
    with torch.no_grad():
        apply_llama(port.llama, CFG.llama, inputs_embeds=emb[:, :12], kv_cache=cache,
                    attn_impl="flash")
        assert [c[:2] for c in calls] == [(12, 0)] * CFG.llama.num_layers
        assert [c[2] for c in calls] == [cache.k[i].data_ptr()
                                         for i in range(CFG.llama.num_layers)]
        # a second chunk of the prompt: q_offset is the cache index
        apply_llama(port.llama, CFG.llama, inputs_embeds=emb[:, 12:], kv_cache=cache,
                    attn_impl="flash")  # 8 rows: a window, plain
        assert len(calls) == CFG.llama.num_layers
        cache.index = 12
        apply_llama(port.llama, CFG.llama, inputs_embeds=emb[:, 11:], kv_cache=cache,
                    attn_impl="flash")  # 9 rows at index 12
        assert [c[:2] for c in calls[CFG.llama.num_layers:]] == [(9, 12)] * CFG.llama.num_layers


# ---------------------------------------------------------------------------
# B3b: the backward
# ---------------------------------------------------------------------------

BWD_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_CASES = ("causal", "key_mask_hole", "non_divisible", "gqa",
             "left_pad_prefill_over_cache", "noncausal_masked")


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_ref_matches_pallas_vjp(case):
    """`flash_attention_bwd_ref` (B3b's plain version) against `jax.vjp` of
    the JAX package's flash_attention, whose VJP runs the Pallas dq and
    dk/dv kernels (interpret mode), fp32: causal, q_offset, key masks and a
    GQA group of 4. dO is zero on rows with no valid key (the loss never
    reads them; the Pallas forward averages keys there, the port gives 0),
    so every dk / dv and the valid rows' dq compare. Tolerance atol / rtol
    1e-4: another summation order in f32."""
    q, k, v, mask, causal, q_offset = _inputs(case)
    b, t, h, d = q.shape
    s = k.shape[1]
    valid = _valid_rows(mask, causal, q_offset, b, t, s)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    do[~valid] = 0.0
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(
        q_, k_, v_, key_mask=jmask, causal=causal, q_offset=q_offset, block_q=8, block_k=8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    tout, lse = flash_attention_ref(tq, tk, tv, key_mask=tmask, causal=causal,
                                    q_offset=q_offset)
    got = flash_attention_bwd_ref(tq, tk, tv, tout, lse, torch.from_numpy(do),
                                  key_mask=tmask, causal=causal, q_offset=q_offset)
    assert [g.shape for g in got] == [tq.shape, tk.shape, tv.shape]
    np.testing.assert_allclose(got[0].numpy()[valid], want[0][valid], err_msg="dq", **BWD_TOL)
    assert not got[0].numpy()[~valid].any()
    np.testing.assert_allclose(got[1].numpy(), want[1], err_msg="dk", **BWD_TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], err_msg="dv", **BWD_TOL)


@pytest.mark.parametrize("case", ["causal", "gqa"])
def test_flash_wrapper_gradient_is_the_backward(case):
    """On a CPU tensor that requires grad, `flash_attention` is the
    autograd Function pairing B3 and B3b (plain versions): its gradient is
    `flash_attention_bwd_ref`'s and matches autograd through the plain
    attention; the logsumexp output carries no gradient."""
    q, k, v, mask, causal, q_offset = _inputs(case)
    tmask = None if mask is None else torch.from_numpy(mask)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    do = torch.from_numpy(np.random.default_rng(3).normal(size=q.shape).astype(np.float32))
    out, lse = flash_attention(*leaves, key_mask=tmask, causal=causal, q_offset=q_offset)
    assert out.grad_fn is not None and not lse.requires_grad
    got = torch.autograd.grad(out, leaves, do)
    ref_out = attention_xla(*leaves, key_mask=tmask, causal=causal, q_offset=q_offset)
    want = torch.autograd.grad(ref_out, leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, msg=name, **BWD_TOL)
    bwd = flash_attention_bwd_ref(*(x.detach() for x in leaves), out.detach(), lse, do,
                                  key_mask=tmask, causal=causal, q_offset=q_offset)
    for g, w in zip(got, bwd):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_vit_attention_gradient_matches_jax_vjp():
    """The CLIP attention's autograd Function (its backward recomputes the
    plain version, as the JAX package's custom_vjp recomputes through XLA)
    against `jax.vjp` of the JAX package's `vit_attention`, fp32, atol /
    rtol 1e-4."""
    from handsonvlm_tpu.ops.vit_attention import vit_attention as jax_vit_attention
    from handsonvlm_torch.ops.vit_attention import vit_attention, vit_attention_ref

    rng = np.random.default_rng(4)
    q, k, v, do = (rng.normal(size=(2, 17, 2, 64)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(jax_vit_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = vit_attention(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    plain = torch.autograd.grad(vit_attention_ref(*leaves), leaves, torch.from_numpy(do))
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **BWD_TOL)
        torch.testing.assert_close(g, p, atol=0, rtol=0)
