"""The train CLI's `--eval-every` over several ranks: the EK100 evaluation of
a model sharded for training, each eval group decoding its share of the
clips on its ranks' shards (`handsonvlm_torch/eval/evaluator.evaluate_sharded`,
`parallel/partition.eval_model`, `parallel/distributed.gather_records`).

Four gloo ranks are spawned once for the module
(`tests/_parallel_ranks.eval_rank`), in the background while the references
run. The model is JAX's tiny224 init (the EK fixture's 224 px frames) with
its head steered to <hand_traj> (+u on its row, -u on every other, as
tests/test_torch_eval_cli.py rigs it), brought across with `from_jax_params`;
the EK100 layout is chip_smoke's `write_ek_fixture` with 4 validation
clips, of which the runs decode 3 at 8 new tokens (so the groups hold
unequal numbers of clips, and at (4, 1) one rank none).

- Several ranks against one: full SFT at (data, model) = (4, 1) (FSDP2
  alone), (2, 2) and (1, 4) (Megatron slices) over the dense, LoRA r = 4,
  QLoRA tiled int4 and int8_fused bases, and `--seq-parallel 2` (a
  ('data', 'seq') mesh of 2 x 2) on the dense one: the same per-clip
  generated ids as the one-rank evaluation of the same state, waypoints
  within 1e-5, ADE / FDE / WDE within 1e-5 and the same n (f32 partial
  sums reassociated over a model group; the FSDP gathers are exact).
- Against the JAX package: greedy decode with the CVAE latent pinned to 0
  in both (the frameworks draw differently; the head's steering leaves an
  exact tie between the other tokens, which both argmaxes break alike), the
  port sharded at (2, 2) and (1, 4) against JAX's `evaluate_epic_kitchen_traj`
  on the same weights and items: the same n, ADE / FDE / WDE within 1e-4.
- The train CLI with `--model-axis 2 --eval-every 1 --eval-samples 4` (full
  SFT over `--synthetic 4`, 2 steps): one `eval/*` line a step, printed by
  rank 0 alone and logged; the losses and the checkpoint (weights and Adam
  moments) bit-equal to the same launch without `--eval-every`; the
  checkpoint resumed and evaluated on one rank.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _parallel_ranks as ranks
import chip_smoke
from handsonvlm_tpu.core.config import get_config as jax_get_config
from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JMockTokenizer
from handsonvlm_tpu.eval import evaluator as jax_evaluator
from handsonvlm_tpu.models import traj_cvae as jax_traj_cvae
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_torch.config import get_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.data.draws import keyed
from handsonvlm_torch.data.epic_dataset import EpicConversationDataset
from handsonvlm_torch.data.epic_structures import get_epic_hoi_dataset_by_name
from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
from handsonvlm_torch.data.synthetic import SyntheticConversationDataset
from handsonvlm_torch.eval.evaluator import (
    InferenceEngine,
    clip_item,
    evaluate_epic_kitchen_traj,
    evaluate_sharded,
    score_clips,
)
from handsonvlm_torch.infer.builder import build_model, quantize_model
from handsonvlm_torch.models.lora import LoRA
from handsonvlm_torch.parallel.distributed import gather_records, spawn
from handsonvlm_torch.parallel.tp import TPGroup
from handsonvlm_torch.train import train
from handsonvlm_torch.train.loader import PrefetchLoader

CFG = get_config("tiny224")
JCFG = jax_get_config("tiny224")
CLIPS, NEW_TOKENS, SEED, R = 3, 8, 5, 4
QUANT = {"sft": None, "lora": None, "qlora_int4": "int4", "qlora_int8_fused": "int8_fused"}
RUNS = ([((4, 1), "sft")] + [(s, m) for s in ((2, 2), (1, 4)) for m in QUANT]
        + [("seq2", "sft")])
PINNED = [(2, 2), (1, 4)]
ONE_RANK = 1e-5
# B10a's plain version rounds each rank's row-parallel partial to bf16 where
# the one-rank product rounds the whole sum once, so a waypoint of the
# int8_fused base moves by a few 1e-5 (3.7e-5 measured at (2, 2))
WAYPOINT_TOL = {"qlora_int8_fused": 1e-4}
JAX_TOL = 1e-4


def _steered_jax_params():
    """JAX's tiny224 init, its head +u on <hand_traj> and -u elsewhere."""
    params = jax.tree_util.tree_map(np.asarray, init_handsonvlm(jax.random.PRNGKey(0), JCFG))
    d, v = params["llama"]["lm_head"]["weight"].shape
    u = np.ones((d,), np.float32) * 2.0
    w = np.tile(-u[:, None], (1, v))
    w[:, JCFG.hand_token_id] = u
    params["llama"]["lm_head"]["weight"] = w
    return params


def _model(mode, state=None):
    model = build_model(CFG, "cpu", quantize=QUANT[mode])
    if mode != "sft":
        model.lora = LoRA(CFG.llama, r=R, alpha=2.0 * R)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _states(params):
    """Each base's port state dict (numpy): the dense model, and over it or
    its QLoRA quantization LoRA r = 4 adapters with b ~ 0.02 N(0, 1)."""
    states = {}
    for mode, quant in QUANT.items():
        model = build_model(CFG, "cpu")
        load_state_dict_into(model, from_jax_params(params))
        if quant:
            quantize_model(model, CFG, quant)
        if mode != "sft":
            gen = torch.Generator().manual_seed(3)
            model.lora = LoRA(CFG.llama, r=R, alpha=2.0 * R)
            with torch.no_grad():
                for ad in model.lora.adapters.values():
                    ad.a.normal_(0.0, 0.02, generator=gen)
                    ad.b.normal_(0.0, 0.02, generator=gen)
        states[mode] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return states


def _dataset():
    hoi = get_epic_hoi_dataset_by_name("ek100", "validation", load_images=True,
                                       rephrase_rate=0.0, use_percentage=1.0)
    return EpicConversationDataset(MockTokenizer(), hoi, deterministic=True)


def _cli_argv(out, steps, eval_every=True, model_axis=2):
    return (["--model-path", "random:tiny224", "--preset", "tiny224", "--device", "cpu",
             "--output-dir", str(out), "--synthetic", "4", "--samples-per-epoch", "4",
             "--batch-size", "2", "--max-steps", str(steps), "--log-every", "1",
             "--learning-rate", "1e-3", "--model-axis", str(model_axis)]
            + (["--eval-every", "1", "--eval-samples", "4"] if eval_every else []))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The EK100 layout (4 validation clips) under HANDSONVLM_DATA_ROOT, the
    steered parameters and each base's state."""
    root = tmp_path_factory.mktemp("ek")
    chip_smoke.write_ek_fixture(str(root), n_val=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HANDSONVLM_DATA_ROOT", str(root))
        mp.setenv("HANDSONVLM_ASSETS_DIR", str(root / "assets"))
        params = _steered_jax_params()
        yield {"root": root, "params": params, "states": _states(params),
               "cli": tmp_path_factory.mktemp("cli")}


@pytest.fixture(scope="module")
def spawned(env):
    """The four ranks, started in the background: every run, then the CLI
    with and without --eval-every."""
    cli = env["cli"]
    job = dict(cfg=CFG, states=env["states"], quant=QUANT, r=R, root=str(env["root"]),
               seed=SEED, clips=CLIPS, new_tokens=NEW_TOKENS,
               runs=[(s, m, False) for s, m in RUNS] + [(s, "sft", True) for s in PINNED],
               cli={"eval": _cli_argv(cli / "eval", 2),
                    "plain": _cli_argv(cli / "plain", 2, eval_every=False)})
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, ranks.eval_rank, 4, job)


def _one_rank(env, mode):
    return evaluate_sharded(_model(mode, env["states"][mode]), CFG, MockTokenizer(), _dataset(),
                            seed=SEED, limit=CLIPS, max_new_tokens=NEW_TOKENS)


def _pinned_jax(env):
    """JAX's evaluator, greedy, with its CVAE latent pinned to 0, over the
    items the port's per-clip draws read; its jit caches are cleared around
    the patch, so no trace of the pinned head outlives it."""
    items = [clip_item(_dataset(), i, SEED) for i in range(CLIPS)]

    def at_zero(params, cfg, cond, rng):
        z = jnp.zeros((cond.shape[0], cfg.latent_dim), cond.dtype)
        return jax_traj_cvae._cvae_decode(params, z, cond)

    engine = jax_evaluator.InferenceEngine(params=env["params"], cfg=JCFG,
                                           tokenizer=JMockTokenizer(),
                                           max_new_tokens=NEW_TOKENS, temperature=0.0)
    draw = jax_traj_cvae.cvae_inference
    jax.clear_caches()
    jax_traj_cvae.cvae_inference = at_zero
    try:
        return jax_evaluator.evaluate_epic_kitchen_traj(engine, items, seed=0, log_every=0)
    finally:
        jax_traj_cvae.cvae_inference = draw
        jax.clear_caches()


@pytest.fixture(scope="module")
def refs(env, spawned):
    """The one-rank evaluation of every base and the pinned JAX one, on
    threads while the ranks run."""
    with ThreadPoolExecutor(3) as pool:
        one = {m: pool.submit(_one_rank, env, m) for m in QUANT}
        jax_ref = pool.submit(_pinned_jax, env)
        return {"one": {m: f.result() for m, f in one.items()}, "jax": jax_ref.result()}


@pytest.fixture(scope="module")
def results(spawned, refs):
    return spawned.result()


def _key(shape):
    return shape if shape == "seq2" else tuple(shape)


# ---------------------------------------------------------------------------
# The sharded evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, mode", RUNS,
                         ids=[f"{s if s == 'seq2' else '%dx%d' % s}-{m}" for s, m in RUNS])
def test_sharded_eval_matches_one_rank(results, refs, shape, mode):
    """Per clip the generated ids and waypoints of the one-rank evaluation
    of the same state, and its scores; every clip decoded once, by its
    group."""
    got = results[0]["runs"][(_key(shape), mode, False)]["res"]
    want = refs["one"][mode]
    assert sorted(got["val_info"]) == sorted(want["val_info"]) == list(range(CLIPS))
    for r in (1, 2, 3):  # every rank holds the union and its scores
        other = results[r]["runs"][(_key(shape), mode, False)]["res"]
        assert {k: other[k] for k in ("n", "ade", "fde", "wde")} == \
            {k: got[k] for k in ("n", "ade", "fde", "wde")}
        assert list(other["val_info"]) == list(got["val_info"])
    for i, w in want["val_info"].items():
        g = got["val_info"][i]
        np.testing.assert_array_equal(g["gen_ids"], w["gen_ids"], err_msg=f"clip {i}")
        assert g["prompt"] == w["prompt"] and g["num_tokens"] == w["num_tokens"]
        np.testing.assert_allclose(g["pred_samples"], w["pred_samples"],
                                   atol=WAYPOINT_TOL.get(mode, ONE_RANK), err_msg=f"clip {i}")
    assert got["n"] == want["n"] > 0
    for k in ("ade", "fde", "wde"):
        np.testing.assert_allclose(got[k], want[k], rtol=ONE_RANK, atol=ONE_RANK, err_msg=k)


@pytest.mark.parametrize("shape", PINNED, ids=["2x2", "1x4"])
def test_sharded_eval_matches_jax(results, refs, shape):
    """Greedy, the CVAE latent pinned to 0: the port sharded over `shape`
    against the JAX package's evaluator on the same weights and items."""
    got = results[0]["runs"][(shape, "sft", True)]["res"]
    want = refs["jax"]
    assert got["n"] == want["n"] > 0
    for k in ("ade", "fde", "wde"):
        np.testing.assert_allclose(got[k], want[k], rtol=JAX_TOL, atol=JAX_TOL, err_msg=k)
    for i, w in want["val_info"].items():
        assert got["val_info"][i]["pred_trajectory_is_valid"] == w["pred_trajectory_is_valid"]
        if w["pred_trajectory_is_valid"]:
            np.testing.assert_allclose(got["val_info"][i]["pred_hand_trajectory"],
                                       w["pred_hand_trajectory"], atol=JAX_TOL)


def test_only_model_groups_communicate_while_decoding(results):
    """A decode step's collectives are its model group's (the sampler's
    row-parallel sums and broadcasts): none where each rank decodes on its
    own (FSDP2 alone, the seq mesh), the same count on each rank of a
    group, and a group with fewer clips issues fewer."""
    count = {r: {k: run["collectives"] for k, run in results[r]["runs"].items()}
             for r in range(4)}
    for r in range(4):
        assert count[r][((4, 1), "sft", False)] == count[r][("seq2", "sft", False)] == 0
        assert count[r][((1, 4), "sft", False)] == count[0][((1, 4), "sft", False)] > 0
    # (2, 2): group 0 (ranks 0, 1) decodes clips 0 and 2, group 1 clip 1
    two = [count[r][((2, 2), "sft", False)] for r in range(4)]
    assert two[0] == two[1] > two[2] == two[3] > 0


# ---------------------------------------------------------------------------
# The train CLI over four ranks
# ---------------------------------------------------------------------------


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _checkpoint(out, step):
    d = out / "checkpoints" / str(step)
    return (torch.load(d / "model.pt", weights_only=True),
            torch.load(d / "optimizer.pt", weights_only=True))


def _bit_equal(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _bit_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            _bit_equal(g, w, f"{path}[{j}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_cli_eval_every_under_four_ranks(results, env, capsys):
    """`--model-axis 2 --eval-every 1`: rank 0 alone prints and logs one
    eval line a step; the steps' losses and the checkpoint equal those of
    the launch without evaluation, bit for bit; the checkpoint resumes on
    one rank, which evaluates its step."""
    out = env["cli"] / "eval"
    evals = {r: [m for m in _lines(results[r]["cli"]["eval"]["stdout"]) if "eval/n" in m]
             for r in range(4)}
    assert [m["step"] for m in evals[0]] == [1, 2] and not any(evals[r] for r in (1, 2, 3))
    assert all(set(m) == {"eval/ade", "eval/fde", "eval/wde", "eval/n", "step"}
               and 0 <= m["eval/n"] <= 4 for m in evals[0])
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged if "eval/n" in r] == [1, 2]
    steps = {name: [m for m in _lines(results[0]["cli"][name]["stdout"]) if "loss" in m]
             for name in ("eval", "plain")}
    assert [m["step"] for m in steps["eval"]] == [m["step"] for m in steps["plain"]] == [1, 2]
    for got, want in zip(steps["eval"], steps["plain"]):
        for k in ("loss", "text_loss", "traj_loss", "traj_kl_loss", "grad_norm"):
            assert got[k] == want[k], (got["step"], k)
    assert results[0]["cli"]["eval"]["step"] == results[0]["cli"]["plain"]["step"] == 2
    _bit_equal(_checkpoint(out, 2), _checkpoint(env["cli"] / "plain", 2))
    state = train.main(_cli_argv(out, 3, model_axis=1))
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and state.step == 3
    assert [m["step"] for m in _lines(text) if "eval/n" in m] == [3]


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


def test_per_clip_draws_do_not_depend_on_the_clips_decoded(env):
    """A clip decoded alone, or after others, gives the record it gives in
    the whole run; the union of two runs' records scores as the whole
    run."""
    model = _model("lora", env["states"]["lora"])
    engine = InferenceEngine(model=model, cfg=CFG, tokenizer=MockTokenizer(),
                             max_new_tokens=NEW_TOKENS)
    run = dict(seed=SEED, log_every=0, limit=CLIPS)
    whole = evaluate_epic_kitchen_traj(engine, _dataset(), clips=range(CLIPS), **run)
    parts = [evaluate_epic_kitchen_traj(engine, _dataset(), clips=c, **run)
             for c in ([2, 0], [1])]
    union = gather_records({**parts[0]["val_info"], **parts[1]["val_info"]})
    assert list(union) == list(range(CLIPS))
    for i, w in whole["val_info"].items():
        np.testing.assert_array_equal(union[i]["gen_ids"], w["gen_ids"])
        np.testing.assert_array_equal(union[i]["pred_samples"], w["pred_samples"])
    assert score_clips(union) == {k: whole[k] for k in ("ade", "fde", "wde", "n")}


def test_engine_refuses_what_takes_no_group():
    """Speculative decode and the continuous-batching scheduler run whole
    models on one rank: with a tensor-parallel group they are refused."""
    tp = TPGroup(0, 2)
    with pytest.raises(ValueError, match="speculative"):
        InferenceEngine(model=None, cfg=CFG, tokenizer=None, spec_k=2, tp=tp)
    engine = InferenceEngine(model=None, cfg=CFG, tokenizer=None, tp=tp)
    with pytest.raises(ValueError, match="scheduler"):
        evaluate_epic_kitchen_traj(engine, [], batched=2)


def test_loader_makes_the_same_batches_in_every_process():
    """The loader makes each item under its (step, place) key: synthetic
    batches read on 8 threads are the same, in order, in two loaders (two
    processes' or two runs'), and another first step draws others."""
    ds = SyntheticConversationDataset(MockTokenizer(), get_config("tiny"), n=8)

    def batches(first_step=0):
        loader = PrefetchLoader(ds, lambda items: {"ids": [i["input_ids"] for i in items],
                                                   "hands": [i["future_hands"] for i in items]},
                                4, 3, num_workers=8, first_step=first_step)
        return [(b["ids"], np.stack(b["hands"])) for b in loader]

    a, b, later = batches(), batches(), batches(first_step=3)
    for (ids_a, h_a), (ids_b, h_b) in zip(a, b):
        assert all(np.array_equal(x, y) for x, y in zip(ids_a, ids_b))
        np.testing.assert_array_equal(h_a, h_b)
    assert not np.array_equal(a[0][1], later[0][1])
    with keyed((0, 1)):
        np.testing.assert_array_equal(ds[5]["future_hands"], a[0][1][1])
