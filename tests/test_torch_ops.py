"""The port's attention ops against the JAX package's.

The plain versions of the two Hopper kernels are held against the Pallas
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
    decode_attention_stacked as jax_decode_attention_stacked,
)
from handsonvlm_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from handsonvlm_torch.ops.attention import attention, attention_xla
from handsonvlm_torch.ops.decode_attention import (
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
    """'auto' sends a cached window (decode_length given) to 'decode' on
    every device, and anything else on a CPU tensor to the plain path;
    'decode' on a one-layer cache equals the plain causal attention at the
    last position."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 20, 4, 16)).astype(np.float32))
    mask = torch.ones((2, 20), dtype=torch.bool)
    mask[:, 2:4] = False
    xla = attention_xla(q, k, v, key_mask=mask, q_offset=14)
    dec = attention(q, k, v, key_mask=mask, q_offset=14, impl="decode", decode_length=15)
    torch.testing.assert_close(dec, xla, **TOL)
    auto = attention(q, k, v, key_mask=mask, q_offset=14, decode_length=15)
    torch.testing.assert_close(auto, dec, atol=0, rtol=0)
    auto = attention(q, k, v, key_mask=mask, q_offset=14)
    torch.testing.assert_close(auto, xla, atol=0, rtol=0)
    with pytest.raises(ValueError, match="decode_length"):
        attention(q, k, v, impl="decode")
    x = torch.zeros((2, 9, 4, 64))
    torch.testing.assert_close(attention(x, x, x, causal=False),
                               attention_xla(x, x, x, causal=False), atol=0, rtol=0)
    assert vit_attention_ok(x, x, x, None, causal=False)
    assert not vit_attention_ok(x, x, x, None, causal=True)
    assert not vit_attention_ok(x[..., :32], x[..., :32], x[..., :32], None, causal=False)
