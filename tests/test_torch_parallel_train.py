"""The port's parallel training path against the JAX package's.

Ring attention (`handsonvlm_torch/parallel/ring_attention.py`), the FSDP2
step (`parallel/partition.shard_model` + `train/step.make_train_step`
with a mesh), the sequence-parallel step and the train CLI launched over
ranks run in gloo ranks (`tests/_parallel_ranks.train_rank`), spawned
twice for the module and in the background while the JAX references are
computed on the 8-device CPU mesh of `tests/conftest.py`: 4 ranks for the
ring at P = 4 and P = 2 (a 2 x 2 ('data', 'seq') mesh) and the
sequence-parallel step on that 2 x 2 mesh, 2 ranks for the FSDP step and
the CLI (2 steps after a one-rank step, then resumed in one rank). Inputs
come from numpy seeds and go to both packages; the CVAE draws are JAX's
(`jax.random.normal(fold_in(rng, step))`, as tests/test_torch_train.py).

Tolerances:
- ring attention and its gradients against JAX's `ring_attention` and
  `jax.vjp` of it: atol = rtol = 1e-5 (f32 online softmax in both, summed
  in another order; the JAX package's own ring test holds its gradients to
  1e-4 of plain attention);
- the train steps' losses: rtol 1e-5, `tests/test_torch_train.py`'s for
  SFT; grad_norm rtol 1e-4 (its rule); the parameters after the steps:
  atol = rtol = 1e-4 against JAX (its rule), 1e-6 against the one-rank
  port step (the same sums, split over the ranks);
- checkpoints resume bit-equal, across rank counts.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _parallel_ranks as ranks
from handsonvlm_tpu.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from handsonvlm_tpu.parallel.partition import shard_params
from handsonvlm_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from handsonvlm_tpu.train import step as jstep
from handsonvlm_tpu.train import train_state as jts
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.core.checkpoint import latest_step, restore_train_state
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.models.lora import init_lora
from handsonvlm_torch.parallel import distributed
from handsonvlm_torch.parallel.distributed import spawn
from handsonvlm_torch.parallel.partition import _clamp_spec, data_dim, spec_for_path
from handsonvlm_torch.train import train
from handsonvlm_torch.train.step import make_train_step
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

CFG = tiny_config()
JCFG = jax_tiny_config()
RING = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_TOL = 1e-5, 1e-4, dict(atol=1e-4, rtol=1e-4)
LR = 1e-3
STEPS = 2


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _ring_cases():
    """(B, T, H, D) q and (B, T, K, D) k, v with a cotangent: causal and
    not at P = 4, GQA (4 heads over 2) with a key mask (right padding and a
    row whose keys are all masked) at P = 2 and 4."""
    rng = np.random.default_rng(0)
    out = {}
    for name, causal, k_heads, masked in (("causal", True, 4, False), ("full", False, 4, False),
                                          ("gqa masked", True, 2, True)):
        b, t, h, d = 2, 16, 4, 8
        c = {"q": rng.normal(size=(b, t, h, d)), "k": rng.normal(size=(b, t, k_heads, d)),
             "v": rng.normal(size=(b, t, k_heads, d)), "dy": rng.normal(size=(b, t, h, d)),
             "causal": causal, "mask": None}
        c = {k: v.astype(np.float32) if isinstance(v, np.ndarray) else v for k, v in c.items()}
        if masked:
            mask = np.ones((b, t), bool)
            mask[0, 11:] = False  # right padding
            mask[1, :] = False  # no valid key: the row's output is 0
            c["mask"] = mask
        out[name] = c
    return out


RING_P = {"causal": (2, 4), "full": (4,), "gqa masked": (2, 4)}


def _batch(b=2, t=17, seed=2):
    """tests/test_torch_train.py's batch (the image sentinel at 1, four hand
    tokens, labels from position 7); t = 17 splices to 40 rows, which P = 2
    divides."""
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


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0))
    batch = _batch()
    assert (batch["input_ids"].shape[1] + CFG.num_visual_tokens - 1) % 2 == 0
    rng = jax.random.PRNGKey(1)
    n_eps = batch["input_ids"].shape[0] * 2 * 4
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(rng, i), (n_eps, CFG.traj.latent_dim)))
           for i in range(STEPS)]
    state = {k: np.asarray(v) for k, v in from_jax_params(params).items()}
    return {"params": params, "batch": batch, "rng": rng, "eps": eps, "state": state}


def _job(setup, **kw):
    return dict(kind="step", cfg=CFG, state=setup["state"], batch=setup["batch"],
                eps=setup["eps"], lr=LR, freeze=("vision",), **kw)


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """Both launches, started in the background."""
    out = tmp_path_factory.mktemp("cli") / "run"
    train.main(_cli_argv(out, 1))  # one rank writes checkpoint 1
    four = {"kind": "ring+seq", "ring": _ring_cases(), "seq": _job(setup, seq=2)}
    two = {"kind": "step+cli", "step": _job(setup), "argv": _cli_argv(out, 3)}
    with ThreadPoolExecutor(2) as pool:
        yield {"four": pool.submit(spawn, ranks.train_rank, 4, four),
               "two": pool.submit(spawn, ranks.train_rank, 2, two), "out": out}


def _cli_argv(out, steps):
    return ["--model-path", "random:tiny", "--preset", "tiny", "--device", "cpu",
            "--output-dir", str(out), "--synthetic", "4", "--samples-per-epoch", "4",
            "--batch-size", "2", "--max-steps", str(steps), "--log-every", "1",
            "--learning-rate", "1e-3", "--lora-r", "4", "--lora-alpha", "8"]


# ---------------------------------------------------------------------------
# JAX references (computed while the ranks run)
# ---------------------------------------------------------------------------


def _jax_ring(c, p):
    mesh = Mesh(np.array(jax.devices()[:p]), ("seq",))
    mask = None if c["mask"] is None else jnp.asarray(c["mask"])

    def f(q, k, v):
        return jax_ring_attention(q, k, v, mesh=mesh, causal=c["causal"], key_mask=mask)

    y, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(c[n]) for n in ("q", "k", "v")))
    return [np.asarray(y), *(np.asarray(g) for g in vjp(jnp.asarray(c["dy"])))]


def _jax_steps(setup, mesh=None, seq_mesh=None):
    """JAX's make_train_step for STEPS steps (SFT, vision frozen): the
    metrics of each and the parameters after, on `mesh` (params and batch
    sharded over 'data') or with `seq_mesh`."""
    params = jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    if mesh is not None:
        params = shard_params(params, mesh)
        batch = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
    tx = jts.make_optimizer(learning_rate=LR, params_template=params, freeze_top_keys=("vision",))
    state = jts.create_train_state(params, tx)
    step = jstep.make_train_step(JCFG, tx, attn_impl="xla", seq_mesh=seq_mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch, setup["rng"])
        metrics.append({k: float(v) for k, v in m.items()})
    ref = build_model(CFG, "cpu")
    load_state_dict_into(ref, from_jax_params(jax.device_get(state.params)))
    return metrics, {n: p.detach().numpy() for n, p in ref.named_parameters()}


@pytest.fixture(scope="module")
def jax_refs(spawned, setup):
    cases = _ring_cases()
    ring = {(name, p): _jax_ring(cases[name], p) for name, ps in RING_P.items() for p in ps}
    data = _jax_steps(setup, mesh=jax_create_mesh(data=2, model=1, devices=jax.devices()[:2]))
    seq = _jax_steps(setup, seq_mesh=Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                                          ("data", "seq")))
    return {"ring": ring, "data": data, "seq": seq}


@pytest.fixture(scope="module")
def four(spawned, jax_refs):
    return spawned["four"].result()[0]


@pytest.fixture(scope="module")
def two(spawned, jax_refs):
    return spawned["two"].result()[0]


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, p", [(n, p) for n, ps in RING_P.items() for p in ps])
def test_ring_attention_and_grads_match_jax(four, jax_refs, name, p):
    got = four["ring"][(name, p)]
    want = jax_refs["ring"][(name, p)]
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=what, **RING)
    if name == "gqa masked":  # a row with every key masked returns 0
        assert not got[0][1].any()


def test_ring_refuses_an_indivisible_sequence(four):
    """T % P raises, with the JAX package's message."""
    assert four["indivisible"][4] == "T=17 must divide the 'seq' axis (4)"
    assert four["indivisible"][2] == "T=9 must divide the 'seq' axis (2)"
    x = jnp.zeros((1, 17, 2, 8))
    with pytest.raises(ValueError, match=r"T=17 must divide the 'seq' axis \(4\)"):
        jax_ring_attention(x, x, x, mesh=Mesh(np.array(jax.devices()[:4]), ("seq",)))


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _compare(got_metrics, got_params, want_metrics, want_params, tol=PARAM_TOL):
    for i, (g, w) in enumerate(zip(got_metrics, want_metrics)):
        for k in ("loss", "text_loss", "traj_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_NORM_RTOL,
                                   err_msg=f"step {i} grad_norm")
    for name, w in want_params.items():
        np.testing.assert_allclose(got_params[name], w, err_msg=name, **tol)


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's one-rank step (no mesh) on the same batch and draws."""
    model = build_model(CFG, "cpu")
    load_state_dict_into(model, setup["state"])
    opt = make_optimizer(model, learning_rate=LR, freeze_top_keys=("vision",))
    state = create_train_state(model, opt)
    step = make_train_step(CFG, opt, attn_impl="xla")
    metrics = [step(state, setup["batch"], 1, eps=torch.from_numpy(e)) for e in setup["eps"]]
    return metrics, {n: p.detach().numpy() for n, p in model.named_parameters()}


def test_fsdp_step_matches_one_rank_and_jax(two, one_rank, jax_refs):
    """2 ranks, FSDP2 over ('data',), one row each: the metrics and the
    trained parameters against the one-rank port step and JAX's step with
    params and batch sharded over a 2-device data mesh."""
    got = two["step"]
    _compare(got["metrics"], got["state"], *one_rank, tol=dict(atol=1e-6, rtol=1e-6))
    _compare(got["metrics"], got["state"], *jax_refs["data"])
    assert list(got["ranks"]) == [0, 1]  # gather_metrics: every rank's rows, in rank order


def test_seq_parallel_step_matches_jax(four, jax_refs):
    """4 ranks on a 2 x 2 ('data', 'seq') mesh: FSDP over 'data' (a row a
    data rank), the ring over 'seq' (20 of 40 rows a rank), against JAX's
    make_train_step(seq_mesh=) on the same mesh shape."""
    got = four["seq"]
    _compare(got["metrics"], got["state"], *jax_refs["seq"])


def test_sharded_step_refuses_an_indivisible_batch(two):
    assert "not divisible by the 2 ranks of the 'data' axis" in two["odd batch"]


# ---------------------------------------------------------------------------
# Checkpoints and the CLI across rank counts
# ---------------------------------------------------------------------------


def test_cli_checkpoints_resume_across_rank_counts(two, spawned, capsys):
    """One rank writes checkpoint 1; two ranks (torchrun's launch) resume
    it and train steps 2 and 3 (rank 0 logs and writes whole state dicts);
    one rank resumes their checkpoint 3 and trains step 4. Each restore is
    bit-equal to the state that was saved."""
    out = spawned["out"]
    ckpt = str(out / "checkpoints")
    assert two["cli step"] == 3 and latest_step(ckpt) == 3
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [1, 2, 3]
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]  # rank 0 alone logged 2 and 3
    saved = torch.load(os.path.join(ckpt, "3", "model.pt"), weights_only=True)
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    assert set(saved) == set(model.state_dict()) | {
        k for k in saved if k.startswith("lora.")}  # the one-rank layout, whole
    final = train.main(_cli_argv(out, 4))
    assert "resumed from step 3" in capsys.readouterr().out
    assert final.step == 4
    model.lora = init_lora(torch.Generator().manual_seed(0), cfg.llama, r=4, alpha=8.0)
    template = create_train_state(model, make_optimizer(model, 1e-3,
                                                        freeze_top_keys=("vision", "llama")))
    restore_train_state(ckpt, template, step=3)
    for k, v in template.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


# ---------------------------------------------------------------------------
# Rules, meshes, process groups
# ---------------------------------------------------------------------------


def test_partition_rules_follow_jax():
    """The table's translation: 'data' on the same logical dimension as the
    JAX rule's, clamped where the size does not divide, and the axes a mesh
    lacks dropped."""
    sizes = {"data": 4, "model": 1}
    assert spec_for_path("llama.layers.3.self_attn.q_proj.weight") == ("model", "data")
    assert spec_for_path("llama.layers.3.self_attn.o_proj.weight") == ("data", "model")
    assert spec_for_path("llama.layers.0.input_layernorm.weight") == ()
    assert spec_for_path("lora.adapters.wq.a") == (None, "data", None)
    assert spec_for_path("vision.encoder.layers.0.layer_norm1.bias") == ()
    assert spec_for_path("unknown.leaf") == ()
    assert _clamp_spec(("data", "model"), (32101, 4096), sizes) == (None, "model")
    assert _clamp_spec(("model", "data"), (32101, 4096), sizes) == ("model", "data")
    assert _clamp_spec(("model", "data"), (32101, 4096), {"data": 4, "model": 2}) == (None, "data")
    assert _clamp_spec(("data", "model"), (4096, 4096), {"data": 2, "seq": 2}) == ("data", None)
    assert data_dim("llama.embed_tokens.weight", (32101, 4096), sizes) is None
    assert data_dim("llama.lm_head.weight", (32101, 4096), sizes) == 1
    assert data_dim("llama.layers.0.mlp.down_proj.weight", (4096, 11008), sizes) == 0


def test_mesh_and_process_group_errors(two):
    """create_mesh keeps the JAX package's checks (with 2 ranks); an NCCL
    start without a card raises (no gloo fallback); one process needs no
    group, and gathers its own metrics."""
    assert two["mesh errors"] == [
        "seq and model axes are mutually exclusive", "mesh 3x1 != 2 devices",
        "2 devices not divisible by 4"]
    assert two["main"] == [True, False]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="without a card"):
            distributed.initialize("tcp://localhost:1", 2, 0, device="cuda")
    got = distributed.gather_metrics({"ade": np.asarray([1.5, 2.5]), "n": [np.asarray(3)]})
    assert got["ade"].tolist() == [1.5, 2.5] and got["n"][0].tolist() == 3
    assert distributed.is_main_process()
