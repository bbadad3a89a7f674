"""The port's fused QLoRA matmuls (ops/qlora_fused, kernels B10a / B10b)
against the JAX package's, on the CPU: the port's ops run their plain
versions there, the JAX package's Pallas kernels run in interpret mode.

Ports of tests/test_qlora_fused.py's 8 cases, each held against the JAX
function itself rather than against the unfused route:
- `int8_matmul_stacked` and `int8_lora_matmul_stacked` forward at r = 128
  and a small r (8), for every layer of the stack;
- their gradients against `jax.vjp` (dx, da, db, and a zero dls);
- `apply_llama` over the JAX package's `layers["int8"]` tree, loaded
  through `from_jax_params` into `quantize="int8_fused"`, and its adapters'
  gradients under remat;
- the fused tree's layout (`quantize_mode`, the route, the bytes).

Tolerances. The outputs are bf16 in both packages (the kernels cast their
f32 tile once) and the f32 sums run in another order, so an element near a
rounding boundary lands one bf16 step apart: the int8 gate of PERF.md §2,
|got - want| <= 2e-3 x max|want| + 2^-7 x |want| per element, for the
forward and for dx, da and db (da and db read bf16(v) and bf16(u), which
can flip the same way). Through the tiny decoder the hidden states agree
to 6.9e-8 relative L2 (held to 1e-6); the adapters' gradients go through a
bf16 dx, bf16(u) and bf16(v) at every projection of the backward, where a
flip moves them by 1.0e-3 to 4.6e-3 relative L2 (measured per target, held
to 1e-2; JAX's own fused route lies 3.2e-3 to 1.5e-2 from its unfused one
on the same inputs).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.models.llama import apply_llama as jax_apply_llama
from handsonvlm_tpu.models.lora import init_lora as jax_init_lora
from handsonvlm_tpu.ops import int8_matmul as j8
from handsonvlm_tpu.ops import qlora_fused as jq
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into, quantize_mode
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.models.llama import apply_llama
from handsonvlm_torch.models.lora import LoRA
from handsonvlm_torch.ops import qlora_fused as tq

L, D, N, R = 3, 256, 384, 128
JCFG = jax_tiny_config()
CFG = tiny_config()


def _mk(seed=0, r=R, m=20):
    """tests/test_qlora_fused.py's inputs: a quantized (L, D, N) stack, x
    bf16 (m, D), a (D, r), b (r, N), ls = 2."""
    rng = np.random.default_rng(seed)
    leaf = j8.quantize_stacked_int8(jnp.asarray(rng.normal(size=(L, D, N)) * 0.02, jnp.float32))
    x = rng.normal(size=(m, D)).astype(np.float32)
    a = (rng.normal(size=(D, r)) * 0.02).astype(np.float32)
    b = (rng.normal(size=(r, N)) * 0.1).astype(np.float32)
    return leaf, x, a, b, 2.0


def _port_leaf(leaf):
    return torch.from_numpy(np.array(leaf["w8"])), torch.from_numpy(np.array(leaf["scale"]))


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def assert_bf16_close(got, want, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    limit = 2e-3 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    assert (err <= limit).all(), (what, float((err / np.maximum(limit, 1e-30)).max()))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_base_forward_matches_jax():
    leaf, x, *_ = _mk()
    w8, sc = _port_leaf(leaf)
    for layer in range(L):
        want = jq.int8_matmul_stacked(jnp.asarray(x, jnp.bfloat16), leaf["w8"], leaf["scale"],
                                      layer)
        got = tq.int8_matmul_stacked(_bf16(x), w8, sc, layer)
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, want, f"layer {layer}")


@pytest.mark.parametrize("r", [R, 8], ids=["r128", "r8"])
def test_fused_forward_matches_jax(r):
    """r = 128, and r = 8, which the JAX package pads to 128 (zero rows and
    columns) and the port takes as it is."""
    leaf, x, a, b, ls = _mk(seed=3 if r == 8 else 0, r=r)
    w8, sc = _port_leaf(leaf)
    layer = 2 if r == 8 else 1
    want = jq.int8_lora_matmul_stacked(jnp.asarray(x, jnp.bfloat16), leaf["w8"], leaf["scale"],
                                       jnp.asarray(a), jnp.asarray(b), jnp.float32(ls), layer)
    got = tq.int8_lora_matmul_stacked(_bf16(x), w8, sc, torch.from_numpy(a),
                                      torch.from_numpy(b), ls, layer)
    assert_bf16_close(got, want)


def test_fused_forward_f32_input_casts_back():
    """An f32 x is rounded to bf16 and the bf16 result cast back to f32, as
    JAX's `_int8_lora_fwd_impl` does."""
    leaf, x, a, b, ls = _mk(seed=4, r=16)
    w8, sc = _port_leaf(leaf)
    want = jq.int8_lora_matmul_stacked(jnp.asarray(x), leaf["w8"], leaf["scale"],
                                       jnp.asarray(a), jnp.asarray(b), jnp.float32(ls), 0)
    got = tq.int8_lora_matmul_stacked(torch.from_numpy(x), w8, sc, torch.from_numpy(a),
                                      torch.from_numpy(b), ls, 0)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert_bf16_close(got, want)


@pytest.mark.parametrize("r", [R, 8], ids=["r128", "r8"])
def test_fused_grads_match_jax_vjp(r):
    """dx, da, db against `jax.vjp` of the JAX package's custom_vjp on the
    same cotangent; dls is zero in both."""
    leaf, x, a, b, ls = _mk(seed=1, r=r)
    w8, sc = _port_leaf(leaf)
    dy = np.random.default_rng(9).normal(size=(x.shape[0], N)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, a_, b_, ls_: jq.int8_lora_matmul_stacked(
        x_, leaf["w8"], leaf["scale"], a_, b_, ls_, 0), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(a), jnp.asarray(b), jnp.float32(ls))
    want = vjp(jnp.asarray(dy, jnp.bfloat16))
    leaves = [_bf16(x).requires_grad_(), torch.from_numpy(a).requires_grad_(),
              torch.from_numpy(b).requires_grad_(), torch.tensor(ls).requires_grad_()]
    y = tq.int8_lora_matmul_stacked(leaves[0], w8, sc, leaves[1], leaves[2], leaves[3], 0)
    got = torch.autograd.grad(y, leaves, _bf16(dy))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, g, w in zip(("dx", "da", "db"), got[:3], want[:3]):
        assert_bf16_close(g, w, name)
    assert float(got[3]) == 0.0 and float(want[3]) == 0.0


def test_base_grad_dx_matches_jax_vjp():
    leaf, x, *_ = _mk(seed=2)
    w8, sc = _port_leaf(leaf)
    dy = np.random.default_rng(5).normal(size=(x.shape[0], N)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: jq.int8_matmul_stacked(x_, leaf["w8"], leaf["scale"], 2),
                     jnp.asarray(x, jnp.bfloat16))
    want = vjp(jnp.asarray(dy, jnp.bfloat16))[0]
    tx = _bf16(x).requires_grad_()
    got = torch.autograd.grad(tq.int8_matmul_stacked(tx, w8, sc, 2), tx, _bf16(dy))[0]
    assert_bf16_close(got, want)
    # the plain route gives the wrapper's numbers on the CPU
    tx2 = _bf16(x).requires_grad_()
    plain = torch.autograd.grad(tq.int8_matmul_stacked(tx2, w8, sc, 2, plain=True), tx2,
                                _bf16(dy))[0]
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


@pytest.fixture(scope="module")
def fused_tree():
    """JAX's tiny model with its decoder quantized and stacked for the fused
    route (quantize_llama + stack_llama_int8) and LoRA r=8 with non-zero B."""
    params = jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0))
    llama = jq.stack_llama_int8(j8.quantize_llama(params["llama"]))
    lora = jax_init_lora(jax.random.PRNGKey(1), JCFG.llama, r=8, alpha=16.0)
    lora["adapters"] = jax.tree_util.tree_map(lambda v: v + 0.01, lora["adapters"])
    return dict(params, llama=llama, lora=lora)


def _port_model(params):
    sd = from_jax_params(params)
    model = build_model(CFG, "cpu", quantize="int8_fused")
    model.lora = LoRA(CFG.llama, r=8, alpha=16.0)
    load_state_dict_into(model, sd)
    return model


def test_fused_tree_loads_into_the_fused_route(fused_tree):
    """`from_jax_params` takes `layers["int8"]`: its layout is the int8 one
    (the route is the caller's `quantize="int8_fused"`), and the stacks
    hold JAX's bytes."""
    sd = from_jax_params(fused_tree)
    assert quantize_mode(sd) == "int8"
    model = _port_model(fused_tree)
    assert model.llama.quantize == "int8_fused" and model.llama.proj is not None
    assert set(model.llama.proj) == set(fused_tree["llama"]["layers"]["int8"])
    for name, leaf in fused_tree["llama"]["layers"]["int8"].items():
        np.testing.assert_array_equal(model.llama.proj[name].w8.numpy(), np.asarray(leaf["w8"]))
        np.testing.assert_array_equal(model.llama.proj[name].scale.numpy(),
                                      np.asarray(leaf["scale"]))


def test_apply_llama_fused_matches_jax(fused_tree):
    ids = np.random.default_rng(0).integers(3, CFG.llama.vocab_size, size=(2, 16))
    want, _ = jax_apply_llama(fused_tree["llama"], JCFG.llama, input_ids=jnp.asarray(ids),
                              lora=fused_tree["lora"])
    model = _port_model(fused_tree)
    with torch.no_grad():
        got, _ = apply_llama(model.llama, CFG.llama, input_ids=torch.from_numpy(ids),
                             lora=model.lora)
    assert _rel(got.numpy(), want) <= 1e-6


def test_apply_llama_fused_lora_grads_match_jax(fused_tree):
    """The adapters' gradients of sum(h^2) under remat "full" through the
    fused route, against JAX's through its `proj8` route."""
    ids = np.random.default_rng(0).integers(3, CFG.llama.vocab_size, size=(1, 12))

    def loss(lo):
        h, _ = jax_apply_llama(fused_tree["llama"], JCFG.llama, input_ids=jnp.asarray(ids),
                               lora=lo, remat="full")
        return jnp.sum(h.astype(jnp.float32) ** 2)

    want = jax.grad(loss)(fused_tree["lora"])["adapters"]
    model = _port_model(fused_tree)
    h, _ = apply_llama(model.llama, CFG.llama, input_ids=torch.from_numpy(ids),
                       lora=model.lora, remat="full")
    (h.float() ** 2).sum().backward()
    for target, ad in model.lora.adapters.items():
        for key in ("a", "b"):
            w = np.asarray(want[target][key])
            assert _rel(getattr(ad, key).grad.numpy(), w) <= 1e-2, (target, key)
