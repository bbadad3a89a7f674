"""The port's tensor-parallel decode against the JAX package's.

`handsonvlm_torch/parallel/tp.py` runs in 4 gloo ranks spawned once for
the module (`tests/_parallel_ranks.tp_rank`): tp = 4 over all of them and
tp = 2 over the pairs (0, 1), (2, 3). The references are
`handsonvlm_tpu/parallel/tp.py`'s shard_map ops on the 8-device CPU mesh of
`tests/conftest.py` (data x model = 4 x 2 or 2 x 4), the Pallas kernels in
interpret mode as `tests/test_tp_kernels.py` runs them, and JAX's
`generate_host(tp_mesh=)`. Inputs come from numpy seeds and go to both.

Tolerances:
- the int4 matmuls: the port's tensor-parallel op against its unsharded op
  atol 1e-5 x max|y|, rtol 1e-5 (the same f32 sums, another blocking);
  against JAX's, the port's single-device rules against the Pallas
  kernels (`tests/test_torch_quant.py`): the GEMV (decode rows) within a
  mean relative 5e-2 (the Pallas GEMV's bf16 algebra; the port's plain
  version is the exact product's), the prefill matmul within 1e-3 x
  max|y| (both round x and each weight to bf16 alike);
- the int8-cache attention (f32): atol = rtol = 1e-5, the port's
  single-device op tests' (`tests/test_torch_ops.py`);
- bf16-cache attention: both sides sum in f32 and round once to bf16, so
  at most one bf16 step apart: rtol 2^-7 (one step of a value's binade)
  and atol 1e-2 (phase 2's bf16 attention bound);
- the greedy tokens and the shards' bytes: exact.
"""

import copy
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _parallel_ranks as ranks
from handsonvlm_tpu.constants import IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.sampler import generate_host as jax_generate_host
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops.int8_matmul import quantize_llama_int4 as jax_quantize_llama_int4
from handsonvlm_tpu.parallel import tp as jtp
from handsonvlm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.infer.sampler import generate_host
from handsonvlm_torch.models.llama import Llama, apply_llama, quantize_llama, quantize_llama_int4
from handsonvlm_torch.models.lora import init_lora
from handsonvlm_torch.ops.int8_matmul import (
    int4_matmul_stacked,
    quantize_int4,
    tile_int4_stacked,
    untile_int4_stacked,
)
from handsonvlm_torch.parallel.distributed import spawn
from handsonvlm_torch.parallel.tp import (
    TPGroup,
    check_layout,
    heads_shard,
    int4_shard_ok,
    shard_int4_stacked,
    shard_llama_tp,
    tp_size,
)

CFG = tiny_config()
JCFG = jax_tiny_config()
WORLD = 4
TP = (2, 4)
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=2.0 ** -7)
ROWS = (1, 130)  # a decode row (B4b / B4c) and a prefill of 128 rows or more (B5b / B5a)
D_IN = 256  # two groups of 128
# n = 2048 tiles into 4 blocks of 512 (both tp split it, and its flat
# layout), n = 1536 into 3 (neither does: the JAX rule's fallback)
WIDTHS = (2048, 1536)
INT4_NAMES = ("tiled n=2048", "tiled n=1536", "flat n=2048")


def _mesh(tp):
    return jax_create_mesh(data=8 // tp, model=tp)


def _int4_cases():
    """Stacked int4 weights of two layers (the port's quantizer, whose bytes
    are the JAX package's: tests/test_torch_quant.py), tiled and flat."""
    rng = np.random.default_rng(0)
    out = {}
    for n in WIDTHS:
        w = torch.from_numpy(rng.normal(size=(2, D_IN, n)).astype(np.float32))
        packed = [quantize_int4(w[i]) for i in range(2)]
        w4 = torch.stack([p[0] for p in packed])
        gs = torch.stack([p[1] for p in packed])
        w4t, gst = tile_int4_stacked(w4, gs)
        xs = {m: rng.normal(size=(1, m, D_IN)).astype(np.float32) for m in ROWS}
        out[f"tiled n={n}"] = (w4t.numpy(), gst.numpy(), xs, 1)
        if n == WIDTHS[0]:
            out[f"flat n={n}"] = (w4.numpy(), gs.numpy(), xs, 1)
    return out


def _attn_cases():
    """A GQA cache (8 query heads over 4 kv heads, both split by 2 and 4):
    bf16 and int8, T = 1 and a window of 5."""
    rng = np.random.default_rng(1)
    L, B, S, H, K, D = 2, 2, 64, 8, 4, 16
    ck = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    cv = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(L, B, S, K, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(L, B, S, K, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, size=(L, B, K, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(L, B, K, S)).astype(np.float32)
    out = {}
    for t in (1, 5):
        q = rng.normal(size=(B, t, H, D)).astype(np.float32)
        out[f"bf16 T={t}"] = dict(q=q, ck=ck, cv=cv, bf16=True, layer=1, length=40)
        out[f"kv8 T={t}"] = dict(q=q, ck=k8, cv=v8, ks=ks, vs=vs, bf16=False, layer=1,
                                 length=40)
    return out


def _flat(tree):
    """JAX's tiled int4 leaves untiled into the flat layout (both packages
    run it; the same bytes)."""
    out = {}
    for name, leaf in tree.items():
        w4, gs = untile_int4_stacked(torch.from_numpy(np.asarray(leaf["w4t"])),
                                     torch.from_numpy(np.asarray(leaf["gst"])))
        out[name] = {"w4": jnp.asarray(w4.numpy()), "gscale": jnp.asarray(gs.numpy())}
    return out


@pytest.fixture(scope="module")
def jax_model():
    """The JAX tiny model in the flat int4 layout and a prompt."""
    params = dict(jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0)))
    llama = jax.jit(jax_quantize_llama_int4)(dict(params["llama"]))
    llama["layers"] = dict(llama["layers"], int4=_flat(llama["layers"]["int4"]))
    params["llama"] = llama
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(1, 12))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    images = rng.normal(size=(1, CFG.num_frames, 3, CFG.vision.image_size,
                              CFG.vision.image_size)).astype(np.float32)
    return params, ids, images


@pytest.fixture(scope="module")
def cases():
    return {"int4": _int4_cases(), "attn": _attn_cases()}


@pytest.fixture(scope="module")
def spawned(cases, jax_model):
    """The ranks, started in the background: the JAX references below are
    computed while they run."""
    params, ids, images = jax_model
    state = {k: np.asarray(v) for k, v in from_jax_params(params).items()}
    gen = {"cfg": CFG, "state": state, "ids": ids, "images": images}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, ranks.tp_rank, WORLD, cases, gen)


# JAX's head-sharded attention gives each head the unsharded kernel's
# result whatever the mesh (its own test_tp_kernels holds tp_out to the
# unsharded kernel): one JAX reference per case, on the mesh named here
ATTN_MESH = {"bf16 T=1": 2, "bf16 T=5": 4, "kv8 T=1": 4, "kv8 T=5": 2}


@pytest.fixture(scope="module")
def jax_refs(spawned, cases, jax_model):
    """Every JAX reference: the int4 ops at each case, row count and tp,
    the attention cases, and generate_host(tp_mesh=) at tp = 2 over the
    int8 cache."""
    out = {}
    for name in INT4_NAMES:
        w, s, xs, layer = cases["int4"][name]
        for m in ROWS:
            for tp in TP:
                out[("int4", name, m, tp)] = np.asarray(jax.jit(
                    lambda x, w, s: jtp.int4_matmul_stacked_tp(x, w, s, layer, mesh=_mesh(tp)))(
                        jnp.asarray(xs[m]), jnp.asarray(w), jnp.asarray(s)))
    for name, tp in ATTN_MESH.items():
        c = cases["attn"][name]
        dtype = jnp.bfloat16 if c["bf16"] else jnp.float32
        q = jnp.asarray(c["q"], dtype)
        if "ks" in c:
            want = jtp.decode_attention_stacked_q_tp(
                q, jnp.asarray(c["ck"]), jnp.asarray(c["cv"]), jnp.asarray(c["ks"]),
                jnp.asarray(c["vs"]), c["layer"], c["length"], mesh=_mesh(tp))
        else:
            want = jtp.decode_attention_stacked_tp(
                q, jnp.asarray(c["ck"], dtype), jnp.asarray(c["cv"], dtype), c["layer"],
                c["length"], mesh=_mesh(tp))
        out[("attn", name)] = np.asarray(want.astype(jnp.float32))
    params, ids, images = jax_model
    jout = jax_generate_host(params, JCFG, jnp.asarray(ids), jnp.asarray(images),
                             jax.random.PRNGKey(3), max_new_tokens=8, temperature=0.0,
                             tp_mesh=_mesh(2), kv_quant="int8")
    out["generate"] = np.asarray(jout.sequences)
    return out


@pytest.fixture(scope="module")
def port(spawned, jax_refs):
    return spawned.result()[0]


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name", INT4_NAMES)
def test_int4_matmul_tp_matches_jax(port, jax_refs, cases, name, m, tp):
    w, s, xs, layer = cases["int4"][name]
    got = port[("int4", name, m, tp)]
    whole = int4_matmul_stacked(torch.from_numpy(xs[m]), torch.from_numpy(w),
                                torch.from_numpy(s), layer).numpy()
    np.testing.assert_allclose(got, whole, atol=F32["atol"] * np.abs(whole).max(),
                               rtol=F32["rtol"])
    want = jax_refs[("int4", name, m, tp)]
    if m < 128:  # the GEMV
        assert np.abs(got - want).mean() / np.abs(want).mean() <= 5e-2
    else:
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    # the split is made exactly where the JAX rule makes it (interpret mode:
    # no lane rule), the tiled n = 1536 (3 tiles) nowhere
    assert port[("int4 split", name, tp)] == int4_shard_ok(w.shape, tp, on_card=False)
    assert port[("int4 split", name, tp)] == (name != "tiled n=1536")


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("name", list(ATTN_MESH))
def test_decode_attention_tp_matches_jax(port, jax_refs, cases, name, tp):
    tol = BF16 if cases["attn"][name]["bf16"] else F32
    np.testing.assert_allclose(port[("attn", name, tp)], jax_refs[("attn", name)], **tol)


def test_generate_host_tp_matches_unsharded_and_jax(port, jax_refs, jax_model):
    """A tiny greedy decode of 8 tokens, flat int4 (every projection split,
    heads split), over the model's cache and the int8 one: the tp = 2 and
    tp = 4 streams equal the unsharded port's, and at tp = 2 over the int8
    cache JAX's generate_host(tp_mesh=) on a 4 x 2 mesh."""
    params, ids, images = jax_model
    model = build_model(CFG, "cpu", quantize="int4_flat")
    load_state_dict_into(model, from_jax_params(params))
    for kv in (None, "int8"):
        want = generate_host(model, CFG, ids, images, torch.Generator().manual_seed(0),
                             max_new_tokens=8, temperature=0.0, kv_quant=kv).sequences
        for tp in TP:
            np.testing.assert_array_equal(port[("generate", kv, tp)][0], want)
    np.testing.assert_array_equal(port[("generate", "int8", 2)][0], jax_refs["generate"])
    for tp in TP:
        layout = port[("layout", tp)]
        assert layout["heads"] and all(layout["int4"].values()) and not layout["fallbacks"]


@pytest.mark.parametrize("tp", TP)
def test_collectives_per_decode_step(port, tp):
    """Flat int4 at tiny (2 layers, every projection split): per forward,
    five all-gathers a layer (wqkv, the heads, wo, wgu, w_down); per
    sampled token the token and its waypoint broadcast. 8 tokens: 1
    prefill + 7 steps, 8 samples."""
    forwards, samples = 8, 8
    want = forwards * 5 * CFG.llama.num_layers + 2 * samples
    for kv in (None, "int8"):
        assert port[("generate", kv, tp)][1] == want


def _wide_cfg():
    """The tiny decoder with an MLP wide enough that the tiled wgu spans 4
    tiles of 512 (the others stay 1 tile: the JAX rule's fallback)."""
    import dataclasses

    return dataclasses.replace(CFG, llama=dataclasses.replace(CFG.llama,
                                                              intermediate_size=1024))


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("mode", ["dense", "int4", "int4_flat"])
def test_shard_llama_tp_slices_are_the_full_model(tp, mode, caplog):
    """Every rank's shard is the matching slice of the full decoder's bytes:
    concatenated over the ranks, bit-equal to it; a weight the rule leaves
    whole is the full one on every rank, and logged."""
    cfg = _wide_cfg()
    full = build_model(cfg, "cpu")
    full.llama.init_weights(torch.Generator().manual_seed(4))
    llama0 = full.llama
    if mode != "dense":
        quantize_llama_int4(llama0, cfg.llama)
        if mode == "int4_flat":
            import chip_smoke

            llama0.int4 = chip_smoke.flat_int4(llama0, cfg.llama)
            llama0.quantize = "int4_flat"
    shards = []
    with caplog.at_level(logging.WARNING, logger="handsonvlm_torch.parallel.tp"):
        for r in range(tp):
            shards.append(shard_llama_tp(copy.deepcopy(llama0), cfg.llama, r, tp))
    layouts = [s.tp_layout for s in shards]
    assert [(lay.rank, lay.size) for lay in layouts] == [(r, tp) for r in range(tp)]
    if mode == "dense":
        for i, lp in enumerate(llama0.layers):
            for sub, lin, dim in (("self_attn", "q_proj", 0), ("self_attn", "k_proj", 0),
                                  ("self_attn", "v_proj", 0), ("self_attn", "o_proj", 1),
                                  ("mlp", "gate_proj", 0), ("mlp", "up_proj", 0),
                                  ("mlp", "down_proj", 1)):
                parts = [getattr(getattr(s.layers[i], sub), lin).weight for s in shards]
                assert all(p.shape[dim] * tp == getattr(getattr(lp, sub), lin).weight.shape[dim]
                           for p in parts)
                torch.testing.assert_close(torch.cat(parts, dim=dim),
                                           getattr(getattr(lp, sub), lin).weight, atol=0, rtol=0)
        assert layouts[0].heads and layouts[0].mlp and not layouts[0].fallbacks
    else:
        for name, w in llama0.int4.items():
            whole = w.packed()
            split = int4_shard_ok(tuple(whole[0].shape), tp, on_card=False)
            assert layouts[0].int4[name] == split
            for j, t in enumerate(whole):
                parts = [s.int4[name].packed()[j] for s in shards]
                dim = 1 if t.dim() in (4, 5) and mode == "int4" else t.dim() - 1
                if split:
                    assert torch.equal(torch.cat(parts, dim=dim), t)
                else:
                    assert all(torch.equal(p, t) for p in parts)
        if mode == "int4":
            # at this width the tiled wgu splits (4 tiles); the rest are 1 tile
            assert layouts[0].int4 == {"wqkv": False, "wo": False, "wgu": True,
                                       "w_down": False}
            assert len(layouts[0].fallbacks) == 3
            assert "runs unsharded on every rank" in caplog.text
        else:
            assert all(layouts[0].int4.values()) and not layouts[0].fallbacks
    for s in shards:  # norms, the embedding and the head stay whole
        torch.testing.assert_close(s.norm.weight, llama0.norm.weight, atol=0, rtol=0)
        torch.testing.assert_close(s.embed_tokens.weight, llama0.embed_tokens.weight,
                                   atol=0, rtol=0)


def test_tp_rules_follow_jax():
    """The split conditions are the JAX package's (`tp.py:71`, `:131`,
    `:185-197`), at 7B's shapes: H = K = 32 heads split by 2 and 4; the
    tiled wgu (43 tiles) splits by neither, the other tiled projections
    (24, 8, 32 tiles) by both; every flat projection splits (22016 / 4 =
    5504 = 43 x 128)."""
    assert heads_shard(32, 32, 2) and heads_shard(32, 32, 4) and not heads_shard(32, 32, 1)
    assert not heads_shard(6, 6, 4) and not heads_shard(8, 6, 4)
    tiles = {"wqkv": 24, "wo": 8, "wgu": 43, "w_down": 32}
    for name, nb in tiles.items():
        for tp in TP:
            assert int4_shard_ok((32, nb, 32, 64, 512), tp) == (name != "wgu")
    for n in (12288, 4096, 22016):
        assert int4_shard_ok((32, 32, 64, n), 4) and int4_shard_ok((32, 32, 64, n), 2)
    assert not int4_shard_ok((1, 1, 16, 96), 4)  # 24 columns a rank: under 128 lanes
    assert int4_shard_ok((1, 1, 16, 96), 4, on_card=False)  # interpret mode: any width
    assert shard_int4_stacked(torch.zeros((1, 3, 1, 1, 8), dtype=torch.int8),
                              torch.zeros((1, 3, 1, 8)), 0, 2) is None
    assert tp_size(None) == 1 and tp_size(TPGroup(1, 4)) == 4


def test_tp_refusals():
    """What has no tensor-parallel route refuses: the per-projection flat
    int4 leaves (the JAX package runs them replicated), a shard called
    without its group (or the whole decoder with one), whole LoRA adapters
    on a dense shard. The int8 leaves, refused before training took a
    model axis, are cut by Megatron's rule: each rank's w8 and scales are
    the matching slices of the whole decoder's."""
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    int8 = copy.deepcopy(model)
    quantize_llama(int8.llama, cfg.llama)
    whole = copy.deepcopy(int8.llama.proj)
    shard_llama_tp(int8.llama, cfg.llama, 1, 2)
    layout = int8.llama.tp_layout
    assert layout.heads and layout.mlp and all(layout.int8.values()) and not layout.fallbacks
    for name, w in whole.items():
        col = name not in ("wo", "w_down")
        dim = 2 if col else 1
        n = w.w8.shape[dim] // 2
        assert torch.equal(int8.llama.proj[name].w8, w.w8.narrow(dim, n, n)), name
        assert torch.equal(int8.llama.proj[name].scale,
                           w.scale[:, n:] if col else w.scale), name
    with pytest.raises(ValueError, match="no tensor-parallel route"):
        shard_llama_tp(Llama(cfg.llama, quantize="int4_proj"), cfg.llama, 0, 2)
    with pytest.raises(ValueError, match="not cut for rank"):
        check_layout(model.llama, TPGroup(0, 2))
    shard_llama_tp(model.llama, cfg.llama, 1, 2)
    with pytest.raises(ValueError, match="call it with its TPGroup"):
        check_layout(model.llama, None)
    with pytest.raises(ValueError, match="not cut for rank 0 of 2"):
        check_layout(model.llama, TPGroup(0, 2))
    model.lora = init_lora(torch.Generator().manual_seed(0), cfg.llama, r=2, alpha=4.0)
    with pytest.raises(ValueError, match="merge them"):
        apply_llama(model.llama, cfg.llama, input_ids=torch.zeros((1, 4), dtype=torch.long),
                    lora=model.lora, tp=TPGroup(1, 2))
    with pytest.raises(ValueError, match="outside a group"):
        shard_llama_tp(Llama(cfg.llama), cfg.llama, 2, 2)
