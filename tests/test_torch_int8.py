"""The port's int8 weight-only matmul and the flat int4 layouts against the
JAX package's, at small sizes in fp32 on the CPU (every op runs its plain
version); tests/test_torch_int8_slice.py holds the decoders built on them.

- `quantize_stacked_int8` and `quantize_llama` give bytes and scales
  bit-identical to the JAX package's.
- The plain versions against the Pallas kernels, run in interpret mode off
  the TPU: B9's (`int8_matmul_ref`) within 1e-5 x max|y| of `int8_matmul`
  (summation order only: bf16(int8) is exact); B4a's and B4c's, the exact
  product, against `int4_matmul` and the flat `_int4_matmul_stacked_impl`
  (and the float64 product), B5a's against `int4_matmul_prefill`, under the
  tolerances test_torch_quant.py holds B4b and B5b to.
- `maybe_int8_matmul` on dense, w8 and w4 leaves, as JAX's; the builder's
  `quantize="int8"`.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops import int8_matmul as j8
from handsonvlm_torch.config import get_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into, quantize_mode
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.infer.sampler import generate_host
from handsonvlm_torch.models import llama as tllama
from handsonvlm_torch.ops import int8_matmul as t8
from test_torch_quant import mean_rel, rand
from test_torch_spec import _prompt

JCFG = jax_tiny_config()
CFG = get_config("tiny")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Quantizers: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 136, 40)])
def test_quantize_stacked_int8_bit_equal(shape):
    w = rand(shape, sum(shape), 0.05)
    w[1, :, 5] = 0.0  # a zero column takes scale 1
    want = j8.quantize_stacked_int8(jnp.asarray(w))
    w8, scale = t8.quantize_stacked_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(want["w8"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(3))


def _port(params):
    """The port's model in the layout of `params`'s decoder, holding its bytes."""
    sd = from_jax_params(params)
    model = build_model(CFG, "cpu", quantize=quantize_mode(sd))
    load_state_dict_into(model, sd)
    return model


def test_quantize_llama_bit_equal(jparams):
    """quantize_llama on a dense port model gives the bytes of the JAX
    package's quantize_llama for the same weights (projections and head)
    and frees the dense projections; dequantize_llama restores w8 x scale."""
    model = _port(jparams)
    tllama.quantize_llama(model.llama, CFG.llama)
    want = j8.quantize_llama(jparams["llama"])
    for grp in ("attn", "mlp"):
        for key, leaf in want["layers"][grp].items():
            np.testing.assert_array_equal(model.llama.proj[key].w8.numpy(), np.asarray(leaf["w8"]))
            np.testing.assert_array_equal(model.llama.proj[key].scale.numpy(),
                                          np.asarray(leaf["scale"]))
    np.testing.assert_array_equal(model.llama.lm_head.w8.numpy(),
                                  np.asarray(want["lm_head"]["w8"]).T)
    assert model.llama.layers[0].self_attn is None and model.llama.int4 is None
    tllama.dequantize_llama(model.llama, CFG.llama, torch.float32)
    down = want["layers"]["mlp"]["w_down"]
    w = np.asarray(down["w8"], np.float32)[1] * np.asarray(down["scale"])[1]
    np.testing.assert_array_equal(model.llama.layers[1].mlp.down_proj.weight.numpy(), w.T)


# ---------------------------------------------------------------------------
# Plain versions of the kernels against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 5, 130])
def test_int8_matmul_plain_vs_pallas(m):
    """B9's plain version against `int8_matmul` (the Pallas kernel), f32
    output, max abs <= 1e-5 x max|y|; the wrapper runs it on a CPU tensor."""
    w8, scale = j8.quantize_int8(jnp.asarray(rand((384, 640), m, 0.05)))
    x = rand((m, 384), m + 1, 0.3)
    want = np.asarray(j8.int8_matmul(jnp.asarray(x), w8, scale))
    tw8, tscale = _t(w8), _t(scale)
    got = t8.int8_matmul_ref(torch.from_numpy(x), tw8, tscale)
    assert got.dtype == torch.float32 and got.shape == want.shape == (m, 640)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    before = t8.int8_matmul.LAUNCHES
    torch.testing.assert_close(t8.int8_matmul(torch.from_numpy(x), tw8, tscale), got,
                               atol=0, rtol=0)
    assert t8.int8_matmul.LAUNCHES == before  # no kernel on the CPU


def _flat_int4(d, n, layers, seed):
    """JAX-quantized flat stacks (numpy) and each layer's exact dequantized
    weight (float64)."""
    qs = [j8.quantize_int4(jnp.asarray(rand((d, n), seed + i, 0.05))) for i in range(layers)]
    exact = [(np.asarray(j8._unpack_int4(q["w4"], jnp.float32), np.float64)
              * np.asarray(q["gscale"], np.float64)[:, None, :]).reshape(d, n) for q in qs]
    return (np.stack([np.asarray(q["w4"]) for q in qs]),
            np.stack([np.asarray(q["gscale"]) for q in qs]), exact)


@pytest.mark.parametrize("m", [1, 5, 130])
@pytest.mark.parametrize("d", [128, 384])
def test_int4_matmul_plain_vs_exact_and_pallas(d, m):
    """B4a's plain version (one flat matrix, any m) is the exact product:
    mean-relative <= 1e-5 from float64 and nearer than `int4_matmul`'s
    biased-nibble bf16 algebra, within 5e-2 of it."""
    w4, gs, exact = _flat_int4(d, 256, 1, seed=d + m)
    x = rand((m, d), m, 0.3)
    want = x.astype(np.float64) @ exact[0]
    got = t8.int4_matmul_ref(torch.from_numpy(x), _t(w4[0]), _t(gs[0])).numpy()
    pallas = np.asarray(j8.int4_matmul(jnp.asarray(x), jnp.asarray(w4[0]), jnp.asarray(gs[0])))
    assert mean_rel(got, want) <= 1e-5, mean_rel(got, want)
    assert mean_rel(got, want) < mean_rel(pallas, want)
    assert mean_rel(got, pallas) <= 5e-2, mean_rel(got, pallas)


@pytest.mark.parametrize("m", [1, 8, 100])
@pytest.mark.parametrize("d", [128, 384])
def test_int4_gemv_flat_plain_vs_exact_and_pallas(d, m):
    """B4c's plain version (a layer of the flat stack, m < 128) against the
    flat branch of `_int4_matmul_stacked_impl`, as B4b's against the tiled
    GEMV; and equal to B4b's plain version over the same weight's tiles up
    to f32 summation."""
    w4, gs, exact = _flat_int4(d, 256, 2, seed=d + m)
    w4t, gst = t8.tile_int4_stacked(_t(w4), _t(gs))
    x = rand((m, d), m, 0.3)
    for layer in (0, 1):
        want = x.astype(np.float64) @ exact[layer]
        got = t8.int4_gemv_flat_ref(torch.from_numpy(x), _t(w4), _t(gs), layer).numpy()
        pallas = np.asarray(j8._int4_matmul_stacked_impl(jnp.asarray(x), jnp.asarray(w4),
                                                         jnp.asarray(gs), layer))
        assert mean_rel(got, want) <= 1e-5, (layer, mean_rel(got, want))
        assert mean_rel(got, want) < mean_rel(pallas, want)
        assert mean_rel(got, pallas) <= 5e-2, mean_rel(got, pallas)
        tiled = t8.int4_gemv_tiled_ref(torch.from_numpy(x), w4t, gst, layer).numpy()
        np.testing.assert_allclose(got, tiled, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [128, 200])
def test_int4_prefill_flat_plain_vs_pallas(m):
    """B5a's plain version makes the Pallas prefill kernel's bf16 roundings:
    within 1e-3 x max|y| of `int4_matmul_prefill`, and bit-equal to B5b's
    plain version over the same weight's tiles."""
    w4, gs, _ = _flat_int4(384, 512, 2, seed=m)
    w4t, gst = t8.tile_int4_stacked(_t(w4), _t(gs))
    x = rand((1, m, 384), m, 0.3)
    for layer in (0, 1):
        want = np.asarray(j8.int4_matmul_prefill(jnp.asarray(x), jnp.asarray(w4),
                                                 jnp.asarray(gs), layer))
        got = t8.int4_matmul_prefill_ref(torch.from_numpy(x), _t(w4), _t(gs), layer)
        assert got.shape == want.shape == (1, m, 512)
        assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
        tiled = t8.int4_matmul_prefill_tiled_ref(torch.from_numpy(x), w4t, gst, layer)
        torch.testing.assert_close(got, tiled, atol=0, rtol=0)


def test_untile_and_flat_dispatch():
    """untile_int4_stacked inverts tile_int4_stacked bit for bit, and
    int4_matmul_stacked sends a flat stack's 127 rows to B4c, 128 to B5a
    (their plain versions on the CPU: no launch)."""
    w4, gs, _ = _flat_int4(128, 256, 2, seed=9)
    tiled = j8.tile_int4_stacked(jnp.asarray(w4), jnp.asarray(gs))
    fw, fg = t8.untile_int4_stacked(_t(tiled["w4t"]), _t(tiled["gst"]))
    np.testing.assert_array_equal(fw.numpy(), w4)
    np.testing.assert_array_equal(fg.numpy(), gs)
    before = (t8.int4_gemv_flat.LAUNCHES, t8.int4_matmul_prefill.LAUNCHES)
    for rows, ref in ((127, t8.int4_gemv_flat_ref), (128, t8.int4_matmul_prefill_ref)):
        x = torch.from_numpy(rand((rows, 128), rows))
        want = ref(x, fw, fg, 1)
        for plain in (False, True):
            torch.testing.assert_close(t8.int4_matmul_stacked(x, fw, fg, 1, plain=plain), want,
                                       atol=0, rtol=0)
    assert (t8.int4_gemv_flat.LAUNCHES, t8.int4_matmul_prefill.LAUNCHES) == before


@pytest.mark.parametrize("kind", ["dense", "w8", "w4"])
def test_maybe_int8_matmul_matches_jax(kind):
    """maybe_int8_matmul over a dense weight, an int8 leaf (JAX's default
    fused-upcast dot: the exact product) and a flat int4 leaf (JAX's
    int4_matmul: the biased-nibble algebra), fp32; in bf16 the output is
    x's dtype, as JAX casts."""
    x, w = rand((2, 3, 128), 1, 0.3), rand((128, 256), 2, 0.05)
    if kind == "dense":
        jleaf, tleaf = jnp.asarray(w), torch.from_numpy(w)
    else:
        q = (j8.quantize_int8(jnp.asarray(w)) if kind == "w8" else j8.quantize_int4(jnp.asarray(w)))
        jleaf = dict(zip(("w8", "scale"), q)) if kind == "w8" else q
        tleaf = {key: _t(v) for key, v in jleaf.items()}
    want = np.asarray(j8.maybe_int8_matmul(jnp.asarray(x), jleaf))
    got = t8.maybe_int8_matmul(torch.from_numpy(x), tleaf).numpy()
    assert got.shape == want.shape == (2, 3, 256)
    if kind == "w4":
        assert mean_rel(got, want) <= 5e-2
        exact = t8.int4_matmul_ref(torch.from_numpy(x), tleaf["w4"], tleaf["gscale"]).numpy()
        np.testing.assert_array_equal(got, exact)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bleaf = tleaf.to(torch.bfloat16) if kind == "dense" else tleaf
    assert t8.maybe_int8_matmul(xb, bleaf).dtype == torch.bfloat16


def test_load_pretrained_int8_random_and_generate():
    """`load_pretrained_model(..., quantize="int8")` builds the int8 layout
    from the random init (seven int8 projections per layer, an int8 head),
    and generate_host decodes with it over either cache."""
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu", quantize="int8")
    assert model.llama.int4 is None and isinstance(model.llama.lm_head, tllama.Int8Head)
    assert sorted(model.llama.proj) == sorted(tllama.projection_shapes(cfg.llama))
    assert model.llama.proj["w_down"].w8.shape == (2, 128, 64)
    ids, frames, frame_map = _prompt()
    for kv_quant in (None, "int8"):
        out = generate_host(model, cfg, ids, frames, None, frame_map=frame_map, max_new_tokens=4,
                            temperature=0.0, kv_quant=kv_quant)
        assert out.sequences.shape == (1, 4) and int(out.num_tokens[0]) >= 1


# ---------------------------------------------------------------------------
# B7a / B7b (the int4 transpose product) and the quantized matmuls' gradients
# ---------------------------------------------------------------------------


def _w_down_stacks(n=128, layers=2, seed=5):
    """JAX-quantized flat stacks at w_down's contraction d = 11008 (no
    multiple of 512, JAX's widest block) and their tiles."""
    w4, gs, _ = _flat_int4(11008, n, layers, seed)
    tiled = j8.tile_int4_stacked(jnp.asarray(w4), jnp.asarray(gs))
    return {"flat": (w4, gs), "tiled": (np.asarray(tiled["w4t"]), np.asarray(tiled["gst"]))}


@pytest.mark.parametrize("layout", ["tiled", "flat"])
def test_int4_transpose_plain_vs_pallas(layout):
    """B7b's and B7a's plain versions against `int4_matmul_stacked_T` (the
    Pallas transpose kernels, interpret mode) at d = 11008: dy rounded to
    bf16 and each weight to bf16(bf16(nibble) * bf16(scale)) in both, so
    they differ only in f32 summation order, <= 1e-5 x max|y|; the two
    layouts' plain versions are bit-equal, and the dispatch runs them on a
    CPU tensor (no launch)."""
    stacks = _w_down_stacks()
    w, s = stacks[layout]
    dy = rand((2, 8, 128), 11, 0.3)
    before = (t8.int4_matmul_T_tiled.LAUNCHES, t8.int4_matmul_T_flat.LAUNCHES)
    for layer in (0, 1):
        want = np.asarray(j8.int4_matmul_stacked_T(jnp.asarray(dy), jnp.asarray(w),
                                                   jnp.asarray(s), layer))
        ref = t8.int4_matmul_T_tiled_ref if layout == "tiled" else t8.int4_matmul_T_flat_ref
        got = ref(torch.from_numpy(dy), _t(w), _t(s), layer)
        assert got.shape == want.shape == (2, 8, 11008) and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        other = stacks["flat" if layout == "tiled" else "tiled"]
        other_ref = t8.int4_matmul_T_flat_ref if layout == "tiled" else t8.int4_matmul_T_tiled_ref
        torch.testing.assert_close(other_ref(torch.from_numpy(dy), *map(_t, other), layer), got,
                                   atol=0, rtol=0)
        torch.testing.assert_close(t8.int4_matmul_stacked_T(torch.from_numpy(dy), _t(w), _t(s),
                                                            layer), got, atol=0, rtol=0)
    assert (t8.int4_matmul_T_tiled.LAUNCHES, t8.int4_matmul_T_flat.LAUNCHES) == before


@pytest.mark.parametrize("route", ["wrapper", "plain"])
@pytest.mark.parametrize("m", [16, 130], ids=["gemv", "prefill"])
@pytest.mark.parametrize("layout", ["tiled", "flat", "one_matrix"])
def test_int4_gradient_matches_jax_vjp(layout, m, route):
    """dx through the int4 products (the autograd Function of each layout,
    run on the CPU through the kernel wrappers, which take their plain
    versions there, or through the dispatchers' `plain` route, the
    reference path on any device) against `jax.vjp` of the JAX
    package's `int4_matmul_stacked` (its custom_vjp: the Pallas transpose
    kernel), fp32, <= 1e-5 x max|dx|: GEMV-sized and prefill-sized x, the
    tiled and flat stacks and one flat matrix (B4a, whose JAX counterpart
    is the flat stack of one). The packed weights get no gradient."""
    w4, gs, _ = _flat_int4(384, 256, 2, seed=m)
    if layout == "tiled":
        tiled = j8.tile_int4_stacked(jnp.asarray(w4), jnp.asarray(gs))
        jw, js, layer = tiled["w4t"], tiled["gst"], 1
    elif layout == "flat":
        jw, js, layer = jnp.asarray(w4), jnp.asarray(gs), 1
    else:
        jw, js, layer = jnp.asarray(w4[1:]), jnp.asarray(gs[1:]), 0
    x, dy = rand((1, m, 384), m, 0.3), rand((1, m, 256), m + 1, 0.3)
    _, vjp = jax.vjp(lambda x_: j8.int4_matmul_stacked(x_, jw, js, layer), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    tx = torch.from_numpy(x).requires_grad_()
    plain = route == "plain"
    if layout == "one_matrix":
        y = t8.maybe_int8_matmul(tx, {"w4": _t(w4[1]), "gscale": _t(gs[1])}, plain=plain)
    else:
        y = t8.int4_matmul_stacked(tx, _t(jw), _t(js), layer, plain=plain)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, tx, torch.from_numpy(dy))[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gradient_matches_jax_vjp(dtype):
    """dx through `maybe_int8_matmul` over a w8 leaf (B9 forward, the plain
    backward dy @ (w8 * scale)^T) against `jax.vjp` of the JAX package's
    (its default XLA int8 dot) on the same x and dy: fp32 within 1e-5 x
    max|dx|; in bf16 (both take bf16 x and dy and return a bf16 dx; the
    port rounds dy * scale to bf16 before the product) within the bf16 rule,
    2e-3 x max|dx| plus one rounding step of the element."""
    w8, scale = j8.quantize_int8(jnp.asarray(rand((384, 640), 3, 0.05)))
    x, dy = rand((2, 5, 384), 4, 0.3), rand((2, 5, 640), 5, 0.3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda x_: j8.maybe_int8_matmul(x_, {"w8": w8, "scale": scale}),
                     jnp.asarray(x, jdt))
    want = np.asarray(vjp(jnp.asarray(dy, jdt))[0].astype(jnp.float32))
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    leaf = {"w8": _t(w8), "scale": _t(scale)}
    y = t8.maybe_int8_matmul(tx, leaf)
    got = torch.autograd.grad(y, tx, torch.from_numpy(dy).to(dtype))[0]
    assert got.dtype == dtype and got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * np.abs(want).max()
    else:
        assert (err <= 2e-3 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)).all()
