"""The port's fused decode MLP (ops/fused_decode, kernel B11) against the
JAX package's, on the CPU: the port's op runs its plain version there, the
JAX package's Pallas kernel runs in interpret mode.

Ports of tests/test_fused_decode.py's 2 cases, plus the re-tiling helper:
- the plain version against JAX's `fused_mlp_stacked` on the same tiled
  int4 tree (B = 1 and 8 rows), per element within one bf16 step of the
  element plus 2e-3 x max|y| (the int4 gate of PERF.md §2: both round act
  and the output to bf16 after f32 sums taken in another order);
- against the port's unfused chain (rms_norm, the int4 GEMVs over gate and
  up, silu * up, the GEMV over w_down, the residual) under JAX's own rule,
  rel < 0.1 (the fused kernel dequantizes to bf16 before the products, the
  GEMV sums the exact products);
- `split_wgu_tiled` bit-equal to JAX's;
- the gate: off unless HANDSONVLM_FUSED_MLP=1, and never for a prefill.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from handsonvlm_tpu.ops import fused_decode as jfd
from handsonvlm_tpu.ops.int8_matmul import tile_int4_stacked as jax_tile_int4_stacked
from handsonvlm_torch.models.llama import rms_norm
from handsonvlm_torch.ops import fused_decode as tfd
from handsonvlm_torch.ops.int8_matmul import int4_matmul_stacked

L, D, F_, BN = 2, 256, 512, 128


def _leaf(key, din, dout, bn):
    """tests/test_fused_decode.py's random tiled int4 leaf."""
    g = din // 128
    w = jax.random.randint(key, (L, g, 64, dout), -128, 128, jnp.int32).astype(jnp.int8)
    s = jnp.abs(jax.random.normal(key, (L, g, dout))) * 0.01 + 0.005
    return jax_tile_int4_stacked(w, s.astype(jnp.float32), block_n=bn)


@pytest.fixture(scope="module")
def tree():
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    return {
        "wg": _leaf(ks[0], D, F_, BN),
        "wu": _leaf(ks[1], D, F_, BN),
        "w_down": _leaf(ks[2], F_, D, BN),
        "nrm": (1.0 + 0.1 * jax.random.normal(ks[4], (L, D))).astype(jnp.bfloat16),
    }


def _port(leaf):
    return {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}


def _rows(b, seed=3):
    return jax.random.normal(jax.random.PRNGKey(seed), (b, D)).astype(jnp.bfloat16)


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("b", [1, 8])
def test_fused_mlp_plain_matches_pallas_interpret(tree, b):
    x = _rows(b)
    want = np.asarray(jfd.fused_mlp_stacked(x, tree["nrm"], tree["wg"], tree["wu"],
                                            tree["w_down"], 1), np.float32)
    got = tfd.fused_mlp_stacked(_torch(x), _torch(tree["nrm"]), _port(tree["wg"]),
                                _port(tree["wu"]), _port(tree["w_down"]), 1)
    assert got.dtype == torch.bfloat16 and got.shape == (b, D)
    err = np.abs(got.float().numpy() - want)
    limit = 2e-3 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    assert (err <= limit).all(), float((err / limit).max())


def test_fused_mlp_matches_unfused_chain(tree):
    """JAX's own rule against the unfused path, here the port's: rms_norm,
    B4b's plain GEMV over gate and up, silu * up, over w_down, residual."""
    x = _torch(_rows(1))
    nrm = _torch(tree["nrm"])
    wg, wu, wd = _port(tree["wg"]), _port(tree["wu"]), _port(tree["w_down"])
    out = tfd.fused_mlp_stacked(x, nrm, wg, wu, wd, 1)
    xn = rms_norm(x, nrm[1], 1e-6)
    g = int4_matmul_stacked(xn, wg["w4t"], wg["gst"], 1)
    u = int4_matmul_stacked(xn, wu["w4t"], wu["gst"], 1)
    act = (F.silu(g.float()) * u.float()).to(x.dtype)
    ref = (x.float() + int4_matmul_stacked(act, wd["w4t"], wd["gst"], 1).float()).to(x.dtype)
    a, r = out.float().numpy(), ref.float().numpy()
    rel = np.abs(a - r).max() / (np.abs(r).max() + 1e-9)
    assert rel < 0.1, rel


def test_split_wgu_tiled_bit_equal_to_jax():
    """The fused gate|up leaf (the int4 decoder's `wgu`, tiles of 512) split
    into gate and up leaves of 256-column tiles, as JAX's helper splits it."""
    key = jax.random.PRNGKey(7)
    f = 768
    wgu = _leaf(key, D, 2 * f, 512)
    want = jfd.split_wgu_tiled(wgu, f)
    got = tfd.split_wgu_tiled(_port(wgu), f)
    for w, g in zip(want, got):
        assert g["w4t"].shape[-1] == 256
        for k in ("w4t", "gst"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_fused_mlp_gated_off_by_default(tree, monkeypatch):
    leaves = {k: _port(tree[k]) for k in ("wg", "wu", "w_down")}
    monkeypatch.delenv("HANDSONVLM_FUSED_MLP", raising=False)
    assert not tfd.fused_mlp_ok(leaves, D, 1, 1)
    monkeypatch.setenv("HANDSONVLM_FUSED_MLP", "1")
    assert tfd.fused_mlp_ok(leaves, D, 1, 1)
    assert not tfd.fused_mlp_ok(leaves, D, 2, 1)  # prefill-shaped: never
    assert not tfd.fused_mlp_ok(leaves, D, 1, tfd.ROWS + 1)
    assert jfd.fused_mlp_ok(tree, D, 1, 1)  # the JAX gate agrees under the same variable
