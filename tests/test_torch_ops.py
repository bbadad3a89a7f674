"""The port's attention ops against the JAX package's.

The plain versions of the Hopper attention kernels (the flash kernel's are in
test_torch_flash.py) are held against the Pallas
kernels (run in interpret mode off the TPU) on the same numpy inputs, in
fp32 at atol 1e-5 / rtol 1e-5. The kernels themselves are held against
their plain versions in test_torch_kernels.py, on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from handsonvlm_tpu.ops.attention import attention_xla as jax_attention_xla
from handsonvlm_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_stacked as jax_decode_attention_stacked,
)
from handsonvlm_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from handsonvlm_torch.ops.attention import FLASH_MIN_T, _best_impl, attention, attention_xla
from handsonvlm_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ref,
    decode_attention_stacked,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_ok,
    vit_attention_ref,
)
from test_torch_kernels import DECODE_CASES, decode_inputs as _decode_inputs

TOL = dict(atol=1e-5, rtol=1e-5)

@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_decode_attention_ref_matches_pallas(case):
    L, B, S, H, K, D, T, layer, length, mask_kind = DECODE_CASES[case]
    q, ck, cv, mask = _decode_inputs(L, B, S, H, K, D, T, mask_kind,
                                     seed=len(case))
    want = jax_decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), layer, length,
        key_mask=None if mask is None else jnp.asarray(mask), block_k=16)
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = decode_attention_stacked_ref(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        layer, length, key_mask=t_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mask_kind == "dead_row":
        assert not got[1].any() and not np.asarray(want)[1].any()


def test_decode_wrapper_on_cpu_runs_plain_version():
    q, ck, cv, mask = _decode_inputs(2, 2, 48, 4, 4, 16, 1, "pad_hole", seed=3)
    args = (torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), 1, 30)
    before = decode_attention_stacked.LAUNCHES
    got = decode_attention_stacked(*args, key_mask=torch.from_numpy(mask))
    assert decode_attention_stacked.LAUNCHES == before  # no kernel on the CPU
    want = decode_attention_stacked_ref(*args, key_mask=torch.from_numpy(mask))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # (B, H, D) queries come back in the same rank
    assert decode_attention_stacked(args[0][:, 0], *args[1:]).shape == (2, 4, 16)


@pytest.mark.parametrize("shape", [(4, 17, 2, 64), (2, 50, 4, 64)])
def test_vit_attention_ref_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = jax_vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = vit_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    before = vit_attention.LAUNCHES
    cpu = vit_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert vit_attention.LAUNCHES == before
    torch.testing.assert_close(cpu, got, atol=0, rtol=0)


@pytest.mark.parametrize("gqa,offset,masked", [
    (False, 0, False), (False, 5, True), (True, 7, True)])
def test_attention_xla_matches_jax(gqa, offset, masked):
    rng = np.random.default_rng(offset)
    b, t, s, h, d = 2, 6, 13, 4, 16
    kh = 2 if gqa else h
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, s), bool)
        mask[0, :3] = False
        mask[1, 8:10] = False
    want = jax_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             key_mask=None if mask is None else jnp.asarray(mask),
                             causal=True, q_offset=offset)
    got = attention_xla(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        key_mask=None if mask is None else torch.from_numpy(mask),
                        causal=True, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dispatch_on_cpu():
    """'auto' sends a cached window (decode_length given) to the stacked
    decode attention on every device, and anything else on a CPU tensor to
    the plain path; 'decode' on a one-layer cache (the single-query form at
    T == 1, the stacked one for a longer window) and 'flash' equal the plain
    causal attention."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    mask = torch.ones((2, 20), dtype=torch.bool)
    mask[:, 2:4] = False
    xla = attention_xla(q, k, v, key_mask=mask, q_offset=14)
    dec = attention(q, k, v, key_mask=mask, q_offset=14, impl="decode", decode_length=15)
    torch.testing.assert_close(dec, xla, **TOL)
    single = decode_attention(q, k, v, 15, key_mask=mask)
    torch.testing.assert_close(dec, single, atol=0, rtol=0)
    auto = attention(q, k, v, key_mask=mask, q_offset=14, decode_length=15)
    stacked = attention(q, k, v, key_mask=mask, q_offset=14, impl="stacked", decode_length=15)
    torch.testing.assert_close(auto, stacked, atol=0, rtol=0)
    torch.testing.assert_close(auto, xla, **TOL)
    auto = attention(q, k, v, key_mask=mask, q_offset=14)
    torch.testing.assert_close(auto, xla, atol=0, rtol=0)
    flash = attention(q, k, v, key_mask=mask, q_offset=14, impl="flash")
    torch.testing.assert_close(flash, xla, **TOL)
    # a window of 3 rows: 'decode' goes the stacked way
    q3 = torch.from_numpy(rng.normal(size=(2, 3, 4, 16)).astype(np.float32))
    kw = dict(key_mask=mask, q_offset=12, decode_length=15)
    torch.testing.assert_close(attention(q3, k, v, impl="decode", **kw),
                               attention(q3, k, v, impl="stacked", **kw), atol=0, rtol=0)
    torch.testing.assert_close(attention(q3, k, v, impl="decode", **kw),
                               attention_xla(q3, k, v, key_mask=mask, q_offset=12), **TOL)
    with pytest.raises(ValueError, match="decode_length"):
        attention(q, k, v, impl="decode")
    x = torch.zeros((2, 9, 4, 64))
    torch.testing.assert_close(attention(x, x, x, causal=False),
                               attention_xla(x, x, x, causal=False), atol=0, rtol=0)
    assert vit_attention_ok(x, x, x, None, causal=False)
    assert not vit_attention_ok(x, x, x, None, causal=True)
    assert not vit_attention_ok(x[..., :32], x[..., :32], x[..., :32], None, causal=False)


class _OnCard:
    """What `_best_impl` reads of a tensor, said to lie on a CUDA device."""

    is_cuda = True

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("t,d,want", [
    (2048, 128, "flash"), (4096, 256, "flash"), (2047, 128, "xla"), (2048, 64, "xla"),
    (2048, 96, "xla")])
def test_auto_takes_flash_only_on_the_card_from_2048_rows(t, d, want):
    """The JAX package's rule (T >= 2048 and a head size of 128 or 256),
    for a CUDA tensor only; a CPU tensor keeps the plain path."""
    q, kv = _OnCard(1, t, 32, d), _OnCard(1, t + 512, 32, d)
    assert FLASH_MIN_T == 2048
    assert _best_impl(q, kv, kv) == want
    # a needed gradient changes nothing: the flash wrapper raises there, and
    # the dispatch never gives way to the plain route on the card
    q.requires_grad = True
    assert _best_impl(q, kv, kv) == want
    cpu_q = torch.empty((1, t, 1, d), device="meta")
    assert _best_impl(cpu_q, cpu_q, cpu_q) == "xla"
    # a cached window stays with the stacked decode kernel on every device
    assert _best_impl(_OnCard(1, 5, 32, d), kv, kv, decode_length=t) == "stacked"
    assert _best_impl(cpu_q[:, :5], cpu_q, cpu_q, decode_length=t) == "stacked"


# (B, H, K, D, S, length, mask): the cases of the JAX package's own tests of
# its single-query kernel, and boundary lengths
SINGLE_CASES = {
    "mha": (2, 8, 8, 64, 96, 37, None),
    "gqa": (2, 8, 2, 64, 96, 37, None),
    "left_pad_mask": (2, 8, 8, 64, 96, 60, "left_pad"),
    "odd_cache_len": (1, 4, 4, 32, 300, 299, None),
    "length_1": (1, 4, 4, 32, 64, 1, None),
    "length_block_edge": (1, 4, 4, 32, 64, 16, None),
    "length_past_block_edge": (1, 4, 4, 32, 64, 17, None),
    "length_full": (2, 4, 2, 32, 64, 64, "left_pad"),
}


@pytest.mark.parametrize("case", list(SINGLE_CASES), ids=list(SINGLE_CASES))
def test_decode_attention_single_ref_matches_pallas(case):
    """Kernel B12's plain version against the Pallas single-query kernel
    (interpret mode) and the plain causal attention at the last position,
    fp32, atol/rtol 1e-5; (B, H, D) and (B, 1, H, D) queries keep their
    rank; on a CPU tensor the wrapper runs the plain version."""
    B, H, K, D, S, length, mask_kind = SINGLE_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    mask = None
    if mask_kind:
        mask = np.ones((B, S), bool)
        mask[0, :7] = False
        mask[1, :19] = False
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length,
                                key_mask=None if mask is None else jnp.asarray(mask),
                                block_k=16)
    t_mask = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = decode_attention_ref(tq, tk, tv, length, key_mask=t_mask)
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xla = attention_xla(tq, tk[:, :length], tv[:, :length],
                        key_mask=None if mask is None else t_mask[:, :length],
                        q_offset=length - 1)
    np.testing.assert_allclose(got.numpy(), xla.numpy(), **TOL)
    before = decode_attention.LAUNCHES
    cpu = decode_attention(tq[:, 0], tk, tv, length, key_mask=t_mask)
    assert decode_attention.LAUNCHES == before and cpu.shape == (B, H, D)
    torch.testing.assert_close(cpu, got[:, 0], atol=0, rtol=0)


def test_decode_attention_single_dead_row_and_window_refused():
    q = torch.ones((2, 1, 4, 16))
    kv = torch.ones((2, 32, 4, 16))
    mask = torch.ones((2, 32), dtype=torch.bool)
    mask[1] = False
    out = decode_attention(q, kv, kv, 20, key_mask=mask)
    assert not out[1].any() and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="one query position"):
        decode_attention(torch.ones((2, 3, 4, 16)), kv, kv, 20)
