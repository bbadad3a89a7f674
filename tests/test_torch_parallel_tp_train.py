"""Tensor parallelism inside training: the port against its one-rank step
and the JAX package's.

The port cuts the decoder Megatron-style over a ('data', 'model') mesh and
shards the slices with FSDP2 over 'data' (`handsonvlm_torch/parallel/tp.py`
`shard_for_training`, `parallel/partition.shard_model`,
`train/step.make_train_step(mesh=)`). Four gloo ranks are spawned once for
the module (`tests/_parallel_ranks.tp_train_rank`), in the background while
the JAX references run: at (data=2, model=2) and (data=1, model=4), full
SFT, LoRA r = 4, and QLoRA over the tiled int4 base (at this width every
tiled projection is one tile, so each stays whole: the fallbacks), the
flat int4 base (its columns cut: the int4 column route), int8 and
int8_fused, 2 steps each; then the checkpoint round trips at (2, 2) and the
train CLI with `--model-axis 2`. Inputs come from numpy seeds and JAX's
init and go to both packages; the CVAE draws are JAX's
(`normal(fold_in(rng, step))`).

Tolerances:
- against the port's one-rank step: rtol 1e-5 on the losses and
  grad_norm, atol = rtol = 1e-5 on each rank's gradients at the first step
  (f32 partial sums reassociated over the ranks), and atol 5e-5, rtol 1e-5
  on the parameters after the steps (Adam divides an element's step by its
  own gradient's size: where the gradient is a near cancellation, the
  reassociated sums move the step by a share of lr, 2.3e-5 at most here).
  Over the QLoRA int4 base B5b / B7b round x and dy to bf16, and over
  int8_fused B10a / B10b round their outputs, each rank's partial (a
  row-parallel product's, a column-parallel product's dx) where the
  one-rank product rounds the whole sum once: an f32 difference upstream
  then flips an element one bf16 step now and then. Their weights are held
  by `tests/test_torch_train.py`'s QLoRA rule (each within 3 lr, the mean
  difference over all of them within 1e-5) and their gradients within
  1e-2 of each tensor's largest element; int8_fused's losses and
  grad_norm by its 1e-3 (measured: 8e-5 and 1.2e-4 at this size);
- against JAX's `make_train_step` on the same params, batch and draws:
  `tests/test_torch_parallel_train.py`'s rules (loss rtol 1e-5, grad_norm
  1e-4, parameters 1e-4), under LoRA the grad_norm against the norm JAX's
  clip reads (`train/step.py`'s convention: JAX's logged norm also counts
  the frozen decoder); the QLoRA int4 and int8_fused bases round to bf16
  in both packages, so those use `tests/test_torch_train.py`'s rules
  (losses 5e-4 / 1e-3, the QLoRA weight rule). Dense and LoRA are also
  held against JAX on `create_mesh(data=2, model=2)`;
- the gradients of the parameters a model group holds whole: bit-equal
  across its ranks; checkpoints: bit-equal across rank counts.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _parallel_ranks as ranks
from handsonvlm_tpu.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.models.lora import init_lora as jax_init_lora
from handsonvlm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from handsonvlm_tpu.parallel.partition import shard_params
from handsonvlm_tpu.train import step as jstep
from handsonvlm_tpu.train import train_state as jts
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.core.checkpoint import latest_step, restore_train_state, save_train_state
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.models.lora import LoRA
from handsonvlm_torch.parallel.distributed import spawn
from handsonvlm_torch.train import train
from handsonvlm_torch.train.step import make_train_step
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

CFG = tiny_config()
JCFG = jax_tiny_config()
LR, STEPS, R = 1e-3, 2, 4
SHAPES = [(2, 2), (1, 4)]
# the decoder's quantize mode in each run; int4_flat is the tiled base untiled
QUANT = {"sft": None, "lora": None, "qlora_int4": "int4", "qlora_int4_flat": "int4_flat",
         "qlora_int8": "int8", "qlora_int8_fused": "int8_fused"}
MODES = list(QUANT)
JAX_OF = {m: "qlora_int4" if m == "qlora_int4_flat" else m for m in MODES}
ONE_RANK = 1e-5
# Adam divides each element's step by its own gradient's size, so where a
# gradient is a near cancellation the reassociated sums move its step by a
# share of lr: the weights within 5e-5 (5% of a step at lr 1e-3)
PARAM_TOL = dict(atol=5e-5, rtol=ONE_RANK)
JAX_LOSS = {"sft": 1e-5, "lora": 1e-5, "qlora_int4": 5e-4, "qlora_int8": 1e-5,
            "qlora_int8_fused": 1e-3}
JAX_NORM = {"sft": 1e-4, "lora": 1e-4, "qlora_int4": 1e-4, "qlora_int8": 1e-4,
            "qlora_int8_fused": 1e-3}
CKPT_MODES = ("sft", "qlora_int8_fused")


def _bf16_rounded(mode):
    """Whether the base's kernels round to bf16 on the way (B5 / B7 round x
    and dy, B10a / B10b their outputs): an f32 difference upstream then
    flips an element one bf16 step now and then."""
    return mode in ("qlora_int4", "qlora_int4_flat", "qlora_int8_fused")


def _batch(b=2, t=112, seed=2):
    """tests/test_torch_parallel_train.py's batch, longer: 135 rows a sample
    after the splice, one sample a data rank at (2, 2), so that every rank
    and JAX run the int4 products on their prefill route (from 128 rows),
    as tests/test_torch_train.py does."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(b, t))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[:, [8, 10, 12, 14]] = HAND_TOKEN_ID
    labels = np.full((b, t), IGNORE_INDEX)
    labels[:, 7:] = ids[:, 7:]
    return {
        "input_ids": ids, "attn_mask": np.ones((b, t), bool),
        "image": rng.normal(size=(b, CFG.num_frames, 3, CFG.vision.image_size,
                                  CFG.vision.image_size)).astype(np.float32),
        "labels": labels,
        "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
        "future_valid": np.ones((b, 2), np.float32),
    }


_JAX_PARAMS = {}


def _jax_params(mode):
    """tests/test_torch_train.py's parameters: JAX's init (or its QLoRA
    base) and r = 4 adapters with b ~ 0.02 N(0, 1); a fresh copy of them
    each call (JAX's step donates its state)."""
    if mode not in _JAX_PARAMS:
        _JAX_PARAMS[mode] = jax.device_get(_make_jax_params(mode))
    return jax.tree_util.tree_map(jnp.asarray, _JAX_PARAMS[mode])


def _make_jax_params(mode):
    if QUANT[mode]:
        params, _, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize=QUANT[mode])
    else:
        params = init_handsonvlm(jax.random.PRNGKey(0), JCFG)
    if mode != "sft":
        lora = jax_init_lora(jax.random.PRNGKey(3), JCFG.llama, r=R, alpha=2.0 * R)
        rng = np.random.default_rng(8)
        lora["adapters"] = {t: {"a": ad["a"], "b": jnp.asarray(
            0.02 * rng.normal(size=ad["b"].shape), jnp.float32)}
            for t, ad in lora["adapters"].items()}
        params = dict(params, lora=lora)
    return params


def _port_model(mode, state=None):
    model = build_model(CFG, "cpu", quantize=QUANT[mode])
    if mode != "sft":
        model.lora = LoRA(CFG.llama, r=R, alpha=2.0 * R)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _freeze(mode):
    return ("vision",) if mode == "sft" else ("vision", "llama")


@pytest.fixture(scope="module")
def setup():
    """Each mode's port state dict (numpy) from JAX's parameters, the
    batch and the CVAE draws."""
    import chip_smoke

    with ThreadPoolExecutor(4) as pool:  # JAX's parameters of every base at once
        list(pool.map(_jax_params, dict.fromkeys(JAX_OF.values())))
    states = {}
    for mode in MODES:
        if mode == "qlora_int4_flat":
            model = _port_model("qlora_int4", states["qlora_int4"])
            model.llama.int4 = chip_smoke.flat_int4(model.llama, CFG.llama)
            model.llama.quantize = "int4_flat"
        else:
            model = _port_model(mode)
            load_state_dict_into(model, from_jax_params(_jax_params(mode)))
        states[mode] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    batch = _batch()
    rng = jax.random.PRNGKey(1)
    n_eps = batch["input_ids"].shape[0] * 2 * 4
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(rng, i), (n_eps, CFG.traj.latent_dim)))
           for i in range(STEPS)]
    return {"states": states, "batch": batch, "rng": rng, "eps": eps}


def _one_rank_record(setup, mode, ckpt=None):
    """The port's one-rank steps of `mode`: metrics, trained parameters,
    the first step's gradients; with `ckpt` the train state written there
    and kept whole."""
    model = _port_model(mode, setup["states"][mode])
    opt = make_optimizer(model, learning_rate=LR, freeze_top_keys=_freeze(mode))
    state = create_train_state(model, opt)
    step = make_train_step(CFG, opt, attn_impl="xla")
    metrics, grads = [], None
    for e in setup["eps"]:
        metrics.append(step(state, setup["batch"], 1, eps=torch.from_numpy(e.copy())))
        grads = grads or {n: p.grad.detach().numpy().copy()
                          for n, p in model.named_parameters() if p.grad is not None}
    out = {"metrics": metrics, "grads": grads,
           "state": {n: p.detach().numpy().copy() for n, p in model.named_parameters()
                     if p.requires_grad}}
    if ckpt is not None:
        save_train_state(str(ckpt / mode), state, state.step)
        out["whole"] = (model.state_dict(), opt.state_dict())
    return out


@pytest.fixture(scope="module")
def one_rank_ckpt(setup, tmp_path_factory):
    """The one-rank checkpoints the ranks restore (before they start)."""
    ckpt = tmp_path_factory.mktemp("one_rank_ckpt")
    return {"dir": ckpt, **{m: _one_rank_record(setup, m, ckpt) for m in CKPT_MODES}}





def _cli_argv(out, steps):
    return ["--model-path", "random:tiny", "--preset", "tiny", "--device", "cpu",
            "--output-dir", str(out), "--synthetic", "4", "--samples-per-epoch", "4",
            "--batch-size", "2", "--max-steps", str(steps), "--log-every", "1",
            "--learning-rate", "1e-3", "--lora-r", "4", "--lora-alpha", "8",
            "--qlora", "int8_fused"]


@pytest.fixture(scope="module")
def spawned(setup, one_rank_ckpt, tmp_path_factory):
    """The four ranks, started in the background: every run, the
    checkpoint round trips, and the CLI under --model-axis 2 resuming a
    one-rank checkpoint."""
    cli = tmp_path_factory.mktemp("cli") / "run"
    train.main(_cli_argv(cli, 1))  # one rank writes checkpoint 1
    written = tmp_path_factory.mktemp("tp_ckpt")
    job = dict(cfg=CFG, states=setup["states"], quant=QUANT, r=R, lr=LR, batch=setup["batch"],
               eps=setup["eps"], runs=[(s, m) for s in SHAPES for m in MODES],
               ckpt=[(m, str(one_rank_ckpt["dir"] / m), str(written / m)) for m in CKPT_MODES],
               argv=_cli_argv(cli, 3) + ["--model-axis", "2"])
    with ThreadPoolExecutor(1) as pool:
        yield {"ranks": pool.submit(spawn, ranks.tp_train_rank, 4, job), "cli": cli,
               "written": written}


# ---------------------------------------------------------------------------
# JAX references (computed while the ranks run)
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _jax_steps(setup, mode, mesh=None, clip_norm=False):
    """JAX's make_train_step for STEPS steps: the metrics of each, with
    `clip_norm` the norm its clip reads at step 0 (its gradients over its
    trainable mask), and the trained parameters loaded into a port model."""
    params = _jax_params(mode)
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    if mesh is not None:
        params = shard_params(params, mesh)
        batch = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
    if clip_norm:
        grads = jax.jit(jax.grad(lambda p: jstep.loss_fn(
            p, JCFG, batch, jax.random.fold_in(setup["rng"], 0), "xla")[0],
            allow_int=True))(params)
        mask = dict(_leaves(jts._trainable_mask(params, _freeze(mode))))
        clip_norm = float(np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                                      for path, g in _leaves(grads)
                                      if mask[path] == "train" and g.dtype != jax.dtypes.float0)))
    tx = jts.make_optimizer(learning_rate=LR, params_template=params,
                            freeze_top_keys=_freeze(mode))
    state = jts.create_train_state(params, tx)
    step = jstep.make_train_step(JCFG, tx, attn_impl="xla")
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch, setup["rng"])
        metrics.append({k: float(v) for k, v in m.items()})
    ref = _port_model(mode)
    load_state_dict_into(ref, from_jax_params(jax.device_get(state.params)))
    return {"metrics": metrics, "clip_norm": clip_norm,
            "state": {n: p.detach().numpy() for n, p in ref.named_parameters()}}


@pytest.fixture(scope="module")
def refs(spawned, setup, one_rank_ckpt):
    """The JAX references and the one-rank steps of every mode, on threads
    while the ranks run. The QLoRA modes' one-rank grad_norm is held to
    JAX's clip norm by tests/test_torch_train.py; here LoRA over the dense
    base stands for it."""
    mesh = jax_create_mesh(data=2, model=2, devices=jax.devices()[:4])
    jobs = {("jax", m): (_jax_steps, setup, m, None, m == "lora")
            for m in dict.fromkeys(JAX_OF.values())}
    jobs.update({("mesh", m): (_jax_steps, setup, m, mesh) for m in ("sft", "lora")})
    jobs.update({("one", m): (_one_rank_record, setup, m) for m in MODES
                 if m not in one_rank_ckpt})
    with ThreadPoolExecutor(4) as pool:
        done = {k: pool.submit(*job) for k, job in jobs.items()}
        out = {k: f.result() for k, f in done.items()}
    jax_out = {m: v for (kind, m), v in out.items() if kind == "jax"}
    jax_out["mesh"] = {m: v for (kind, m), v in out.items() if kind == "mesh"}
    one = {m: v for (kind, m), v in out.items() if kind == "one"}
    one.update({m: one_rank_ckpt[m] for m in CKPT_MODES})
    return {"jax": jax_out, "one": one}


@pytest.fixture(scope="module")
def jax_refs(refs):
    return refs["jax"]


@pytest.fixture(scope="module")
def one_rank(refs):
    return refs["one"]


@pytest.fixture(scope="module")
def results(spawned, refs):
    return spawned["ranks"].result()


def _run(results, shape, mode, rank=0):
    return results[rank]["runs"][(shape, mode)]


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def _close_params(got, want, mode, tol):
    """The trained parameters within `tol`; over a base that rounds to
    bf16, each within 3 lr and all of them within 1e-5 on the mean."""
    names = [n for n in want if n in got]
    assert names
    if _bf16_rounded(mode) or (tol is None and QUANT[mode]):
        # Adam moves an element by about lr a step whatever its gradient's
        # size: a tiny gradient of the other sign after a bf16 rounding
        # flip lands up to 2 lr a step away
        diffs = [np.abs(got[n] - want[n]).ravel() for n in names]
        worst = max(names, key=lambda n: np.abs(got[n] - want[n]).max())
        assert np.abs(got[worst] - want[worst]).max() <= 3 * LR, worst
        assert np.concatenate(diffs).mean() <= 1e-5
        return
    for name in names:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **(tol or dict(atol=1e-4, rtol=1e-4)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_tp_steps_match_one_rank(results, one_rank, shape, mode):
    """Loss, grad_norm and the trained parameters against the one-rank
    port step on the same global batch and draws."""
    got, want = _run(results, shape, mode), one_rank[mode]
    rtol = 1e-3 if mode == "qlora_int8_fused" else ONE_RANK
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "text_loss", "traj_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"step {i} {k}")
    assert set(got["state"]) == set(want["state"])
    _close_params(got["state"], want["state"], mode, PARAM_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_tp_steps_match_jax(results, jax_refs, shape, mode):
    """The same runs against JAX's make_train_step on one device."""
    got, ref = _run(results, shape, mode), jax_refs[JAX_OF[mode]]
    jmode = JAX_OF[mode]
    for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in ("loss", "text_loss", "traj_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=JAX_LOSS[jmode], err_msg=f"step {i} {k}")
    if mode in ("sft", "lora"):
        want_norm = ref["metrics"][0]["grad_norm"] if mode == "sft" else ref["clip_norm"]
        np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want_norm,
                                   rtol=JAX_NORM[jmode])
    else:  # JAX's logged norm counts the frozen decoder's float leaves too
        assert ref["metrics"][0]["grad_norm"] >= got["metrics"][0]["grad_norm"]
    _close_params(got["state"], ref["state"], mode, None)


@pytest.mark.parametrize("mode", ["sft", "lora"])
def test_tp_steps_match_jax_on_a_2x2_mesh(results, jax_refs, mode):
    """Dense and LoRA at (2, 2) against JAX's step with params and batch on
    create_mesh(data=2, model=2) (GSPMD over 'model')."""
    got, ref = _run(results, (2, 2), mode), jax_refs["mesh"][mode]
    for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in ("loss", "text_loss", "traj_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=JAX_LOSS[mode], err_msg=f"step {i} {k}")
    want_norm = (ref["metrics"][0]["grad_norm"] if mode == "sft"
                 else jax_refs["lora"]["clip_norm"])
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want_norm, rtol=JAX_NORM[mode])
    _close_params(got["state"], ref["state"], mode, None)


# ---------------------------------------------------------------------------
# Gradients on each rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_replicated_grads_bit_equal_across_model_ranks(results, shape, mode):
    """Every gradient of a parameter the model group holds whole (the
    embedding, norms, head, projector, CVAE head, the adapters' whole
    factors after their sum) is the same bits on each rank of the group."""
    runs = [_run(results, shape, mode, r) for r in range(4)]
    for data in range(shape[0]):
        group = [run for run in runs if run["data rank"] == data]
        assert sorted(run["model rank"] for run in group) == list(range(shape[1]))
        whole = [n for n in group[0]["grads"] if n not in group[0]["cuts"]]
        assert whole
        for run in group[1:]:
            for name in whole:
                assert np.array_equal(run["grads"][name], group[0]["grads"][name]), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_slice_grads_are_slices_of_the_one_rank_grads(results, one_rank, shape, mode):
    """Each rank's gradient of a model slice (the decoder's weights under
    SFT, the adapters' cut factors over the dense and int8 bases) is the
    matching slice of the one-rank gradient; a whole parameter's gradient
    is the one-rank one."""
    want = one_rank[mode]["grads"]
    sliced = 0
    for r in range(4):
        run = _run(results, shape, mode, r)
        assert set(run["grads"]) == set(want)
        for name, g in run["grads"].items():
            w = want[name]
            if name in run["cuts"]:
                dim = run["cuts"][name]
                n = w.shape[dim] // shape[1]
                w = np.take(w, range(run["model rank"] * n, (run["model rank"] + 1) * n),
                            axis=dim)
                sliced += 1
            if _bf16_rounded(mode):
                np.testing.assert_allclose(g, w, atol=1e-2 * np.abs(w).max(), err_msg=name)
            else:
                np.testing.assert_allclose(g, w, atol=ONE_RANK, rtol=ONE_RANK, err_msg=name)
    cut_modes = ("sft", "lora", "qlora_int8", "qlora_int8_fused")
    assert (sliced > 0) == (mode in cut_modes), (mode, sliced)


def test_layouts_and_collectives(results):
    """What each run cut: at (1, 4) the heads (one of 4 a rank) and the MLP;
    the tiled int4 projections (one tile each at this width) whole and
    logged, the flat ones by columns; the int8 leaves by Megatron's cuts."""
    for shape in SHAPES:
        for mode in MODES:
            run = _run(results, shape, mode)
            lay = run["layout"]
            assert lay["size"] == shape[1] and lay["heads"]
            cuts = run["cuts"]
            if mode == "qlora_int4":
                assert not any(lay["int4"].values()) and len(lay["fallbacks"]) == 4
                assert not cuts
            elif mode == "qlora_int4_flat":
                assert all(lay["int4"].values()) and not lay["fallbacks"]
                assert cuts["llama.int4.wqkv.w4"] == 3 and cuts["llama.int4.wo.gscale"] == 2
            elif mode in ("qlora_int8", "qlora_int8_fused"):
                assert all(lay["int8"].values()) and not lay["fallbacks"]
                assert cuts["llama.proj.wq.w8"] == 2 and cuts["llama.proj.wq.scale"] == 1
                assert cuts["llama.proj.wo.w8"] == 1 and "llama.proj.wo.scale" not in cuts
                assert cuts["lora.adapters.wq.b"] == 2 and cuts["lora.adapters.w_down.a"] == 1
            else:
                assert lay["mlp"]
                assert cuts["llama.layers.1.self_attn.q_proj.weight"] == 0
                assert cuts["llama.layers.1.mlp.down_proj.weight"] == 1
            assert run["collectives"] > 0


# ---------------------------------------------------------------------------
# Checkpoints and the CLI across rank counts
# ---------------------------------------------------------------------------


def _equal_states(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), k


def _equal_opt(got, want):
    assert got["count"] == want["count"]
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


@pytest.mark.parametrize("mode", CKPT_MODES)
def test_checkpoints_resume_across_rank_counts(results, one_rank, spawned, mode):
    """A train state written at (2, 2) restores bit-equal at one rank (model
    and moments, the one-rank layout), and a one-rank state restored at
    (2, 2) gathers back bit-equal."""
    ck = results[0]["ckpt"][mode]
    model = _port_model(mode)
    opt = make_optimizer(model, learning_rate=LR, freeze_top_keys=_freeze(mode))
    template = create_train_state(model, opt)
    restore_train_state(str(spawned["written"] / mode), template)
    assert template.step == STEPS
    _equal_states(model.state_dict(), ck["mine"][0])
    _equal_opt(opt.state_dict(), ck["mine"][1])
    model_one, opt_one = one_rank[mode]["whole"]
    _equal_states(ck["back"][0], model_one)
    _equal_opt(ck["back"][1], opt_one)
    assert ck["step"] == STEPS


def test_cli_model_axis_resumes_across_rank_counts(results, spawned, capsys):
    """One rank writes checkpoint 1; four ranks with --model-axis 2 (a 2 x 2
    mesh, QLoRA int8_fused r = 4) resume it and train steps 2 and 3; one
    rank resumes their checkpoint 3. The adapter artifacts are whole and
    the builder loads the output directory."""
    out = spawned["cli"]
    ckpt = str(out / "checkpoints")
    assert results[0]["cli step"] == 3 and latest_step(ckpt) == 3
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    saved = torch.load(os.path.join(ckpt, "3", "model.pt"), weights_only=True)
    whole = _port_model("qlora_int8_fused")
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(v.shape) for k, v in whole.state_dict().items()}
    lora = torch.load(out / "lora" / "tree.pt", weights_only=True)
    assert {k: tuple(v.shape) for k, v in lora.items()} == {
        k: tuple(v.shape) for k, v in whole.lora.state_dict().items()}
    final = train.main(_cli_argv(out, 4))
    assert "resumed from step 3" in capsys.readouterr().out
    assert final.step == 4
    model, _, _ = load_pretrained_model(str(out), "tiny", "cpu")
    assert torch.equal(model.projector.weight, final.model.projector.weight.detach())
