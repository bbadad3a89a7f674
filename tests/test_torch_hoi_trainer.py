"""The port's hoi-forecast trainer (train/hoi_trainer.py) and its CLI
(train/hoi_train.py) against the JAX package's.

- the warmup-wrapped cosine schedule, step by step against optax's;
- the weight-decay split against `_vae_mask` leaf for leaf (the JAX mask
  tree carried to the port's names by the weights bridge);
- each optimizer kind (adam, adamw, sgd, rms) over 5 steps on the same
  gradients, from the same weights, against the optax chain of
  `make_hoi_optimizer` with weight decay 0.1 and the warmup schedule (its
  first step at lr 0); `rms` keeps optax's eps inside the square root,
  which torch.optim.RMSprop does not;
- a 4-step loss trajectory against `make_hoi_train_step` (JAX's draws,
  fold_in(rng, step), passed in as `eps`);
- `epoch_pass` / `epoch_evaluate`, and the CLI on `--device cpu` over a
  tiny EK100 fixture: two epochs with evaluation, then a run that restores
  the checkpoint and, as the JAX CLI does, starts its epoch loop at epoch 0
  with the restored step.

Tolerances (fp32): the schedule to f32 rounding (rtol 1e-6); the weights
after 5 optimizer steps rtol 1e-5 / atol 1e-7 (a few f32 roundings of the
moments); the loss trajectory rtol 1e-4 and the trained weights atol 2e-6
(4 steps of Adam at lr 1e-3 amplify f32 summation-order noise).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import chip_smoke
from handsonvlm_tpu.models import object_transformer as jot
from handsonvlm_tpu.train import hoi_trainer as jht
from handsonvlm_tpu.train.train_state import create_train_state as jax_create_train_state
from handsonvlm_torch.convert.object_transformer import from_jax_object_transformer, load_named
from handsonvlm_torch.models import object_transformer as tot
from handsonvlm_torch.train import hoi_train
from handsonvlm_torch.train import hoi_trainer as tht
from handsonvlm_torch.train.train_state import create_train_state

DIMS = dict(token_dim=32, coord_dim=8, num_heads=4, enc_depth=1, dec_depth=1,
            hidden_dim=16, latent_dim=8)
LAMBDAS = dict(lambda_obj=0.1, lambda_traj=1.0, lambda_obj_kl=1e-3,
               lambda_traj_kl=1e-3, lambda_last_hand=1e-3)


def _batches(n=3, b=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        valid = np.ones((b, 5, 10), np.float32)
        valid[:, 2, ::3] = 0
        out.append({
            "feat": rng.normal(size=(b, 5, 10, 1024)).astype(np.float32),
            "bbox_feat": rng.uniform(size=(b, 4, 10, 4)).astype(np.float32),
            "valid_mask": valid,
            "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
            "contact_point": rng.uniform(size=(b, 2)).astype(np.float32),
            "future_valid": np.ones((b, 2), np.float32),
        })
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jot.ObjectTransformerConfig(**DIMS)
    return jcfg, tot.ObjectTransformerConfig(**DIMS), jot.init_object_transformer(
        jax.random.PRNGKey(0), jcfg)


def _port(cfg, params):
    model = tot.ObjectTransformer(cfg)
    load_named(model, from_jax_object_transformer(params))
    return model


def test_warmup_schedule_against_optax():
    want = jht.warmup_schedule(1e-3, 10, optax.cosine_decay_schedule(1e-3, 100))
    got = tht.warmup_schedule(1e-3, 10, tht.cosine_decay_schedule(1e-3, 100))
    assert got(0) == 0.0
    for step in (0, 1, 5, 9, 10, 11, 50, 109, 110, 200):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-6,
                                   err_msg=str(step))
    ratio = tht.warmup_schedule(2e-4, 4, tht.cosine_decay_schedule(2e-4, 8), init_lr_ratio=0.5)
    want_ratio = jht.warmup_schedule(2e-4, 4, optax.cosine_decay_schedule(2e-4, 8), 0.5)
    for step in range(14):
        np.testing.assert_allclose(ratio(step), float(want_ratio(jnp.int32(step))), rtol=1e-6)


def test_weight_decay_split_equals_vae_mask(weights):
    _, cfg, params = weights
    mask = from_jax_object_transformer(jht._vae_mask(params, exempt=True))
    model = _port(cfg, params)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(mask)
    for n in names:
        assert tht.vae_exempt(n) == bool(mask[n]), n
    opt = tht.make_hoi_optimizer(model, "adam", weight_decay=0.1)
    groups = {g["name"]: g for g in opt.param_groups}
    assert groups["vae"]["weight_decay"] == 0.0 and groups["decayed"]["weight_decay"] == 0.1
    assert len(groups["vae"]["params"]) == sum(bool(v) for v in mask.values())


def _grad_trees(params, n, seed=3):
    """n gradient trees, each leaf N(0, 1) x 1e-3 x a per-leaf scale in
    [0.1, 1] (small enough that rms's eps placement shows)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    scales = rng.uniform(0.1, 1.0, size=len(leaves))
    return [jax.tree_util.tree_unflatten(treedef, [
        (rng.normal(size=x.shape) * 1e-3 * s).astype(np.float32) for x, s in zip(leaves, scales)])
        for _ in range(n)]


@pytest.mark.parametrize("kind", tht.KINDS)
def test_optimizer_kinds_five_steps_on_the_same_gradients(weights, kind):
    jcfg, cfg, params = weights
    grads = _grad_trees(params, 5)
    sched = jht.warmup_schedule(1e-3, 2, optax.cosine_decay_schedule(1e-3, 10))
    tx = jht.make_hoi_optimizer(params, kind, schedule=sched, weight_decay=0.1)
    j_params, j_state = params, tx.init(params)
    for g in grads:
        updates, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    want = from_jax_object_transformer(j_params)

    model = _port(cfg, params)
    opt = tht.make_hoi_optimizer(model, kind, weight_decay=0.1, schedule=tht.warmup_schedule(
        1e-3, 2, tht.cosine_decay_schedule(1e-3, 10)))
    named = dict(model.named_parameters())
    for g in grads:
        for n, t in from_jax_object_transformer(g).items():
            named[n].grad = torch.from_numpy(t.copy())
        opt.step()
    assert opt.count == 5
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5, atol=1e-7, err_msg=n)
    if kind == "rms":
        # torch.optim.RMSprop puts eps outside the sqrt: a different first step
        ref = _port(cfg, params)
        torch_rms = torch.optim.RMSprop(ref.parameters(), lr=1e-3, alpha=0.99, eps=1e-8)
        one = _port(cfg, params)
        mine = tht.make_hoi_optimizer(one, "rms", lr=1e-3)
        g0 = from_jax_object_transformer(grads[0])
        for m in (ref, one):
            for n, p in m.named_parameters():
                p.grad = torch.from_numpy(g0[n].copy())
        torch_rms.step()
        mine.step()
        a = ref.oct_encoder.norm.bias.detach() - torch.from_numpy(
            from_jax_object_transformer(params)["oct_encoder.norm.bias"])
        b = one.oct_encoder.norm.bias.detach() - torch.from_numpy(
            from_jax_object_transformer(params)["oct_encoder.norm.bias"])
        assert float((a - b).abs().max()) > 0.05 * float(b.abs().max())


def _eps(key, b, latent):
    r_tf, r_r, r_l = jax.random.split(key, 3)
    return {"traj": torch.from_numpy(np.array(jax.random.normal(r_tf, (b * 2 * 4, latent)))),
            "obj_r": torch.from_numpy(np.array(jax.random.normal(r_r, (b, latent)))),
            "obj_l": torch.from_numpy(np.array(jax.random.normal(r_l, (b, latent))))}


def test_train_loss_trajectory_against_make_hoi_train_step(weights):
    jcfg, cfg, params = weights
    batch = _batches(1)[0]
    tx = jht.make_hoi_optimizer(params, "adam", lr=1e-3, weight_decay=0.01)
    state = jax_create_train_state(params, tx)
    step = jht.make_hoi_train_step(jcfg, tx, LAMBDAS)
    key = jax.random.PRNGKey(1)
    want = []
    for _ in range(4):
        state, ls = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want.append(float(ls["total_loss"]))

    model = _port(cfg, params)
    opt = tht.make_hoi_optimizer(model, "adam", lr=1e-3, weight_decay=0.01)
    t_state = create_train_state(model, opt)
    t_step = tht.make_hoi_train_step(cfg, opt, LAMBDAS)
    got = []
    for i in range(4):
        eps = _eps(jax.random.fold_in(key, i), 2, cfg.latent_dim)
        got.append(t_step(t_state, batch, 1, eps=eps)["total_loss"])
    assert t_state.step == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    final = from_jax_object_transformer(state.params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[n], atol=2e-6, err_msg=n)


def test_epoch_pass_and_evaluate(weights):
    _, cfg, params = weights
    model = _port(cfg, params)
    opt = tht.make_hoi_optimizer(model, "adamw", lr=1e-4, weight_decay=0.01)
    state = create_train_state(model, opt)
    step = tht.make_hoi_train_step(cfg, opt, LAMBDAS)
    state, means = tht.epoch_pass(_batches(2), state, step, 2)
    assert state.step == 2 and "total_loss" in means and np.isfinite(means["total_loss"])
    metrics = tht.epoch_evaluate(_batches(2), model, cfg, 3, num_samples=2)
    assert set(metrics) == {"ade", "fde", "wde"}
    assert all(np.isfinite(v) for v in metrics.values())


def _lines(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_hoi_train_cli_on_cpu_with_resume(tmp_path, monkeypatch, capsys):
    """The CLI over chip_smoke's EK100 fixture (one labelled train clip,
    two validation clips): 2 epochs with evaluation each epoch, checkpoints
    at steps 1 and 2; then a 1-epoch run restores step 2, runs epoch 0
    again and saves step 3."""
    root = tmp_path / "ek"
    chip_smoke.write_ek_fixture(str(root), n_val=2, train_label=True)
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(root))
    out = str(tmp_path / "run")
    argv = ["--embed-dim", "32", "--coord-dim", "8", "--num-heads", "4", "--enc-depth", "1",
            "--dec-depth", "1", "--hidden-dim", "16", "--latent-dim", "8", "--batch-size", "4",
            "--warmup-epochs", "1", "--eval-every", "1", "--num-samples", "2",
            "--device", "cpu", "--output-dir", out]
    hoi_train.main(argv + ["--epochs", "2"])
    lines = _lines(capsys.readouterr().out)
    train = [x for x in lines if "total_loss" in x]
    val = [x for x in lines if "val/ade" in x]
    assert [x["epoch"] for x in train] == [0, 1] and [x["epoch"] for x in val] == [0, 1]
    assert all(np.isfinite(x[k]) for x in train for k in ("total_loss", "step_ms"))
    assert all(np.isfinite(x[k]) for x in val for k in ("val/ade", "val/fde", "val/wde"))
    ckpt = tmp_path / "run" / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["1", "2"]

    hoi_train.main(argv + ["--epochs", "1"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {"restored_step": 2}
    assert [x["epoch"] for x in lines if "total_loss" in x] == [0]
    assert sorted(p.name for p in ckpt.iterdir()) == ["1", "2", "3"]
    assert json.loads((ckpt / "3" / "step.json").read_text()) == {"step": 3}


def test_hoi_train_cli_keeps_the_jax_flags_and_defaults():
    args = hoi_train.parse_args(["--output-dir", "x"])
    assert (args.batch_size, args.epochs, args.warmup_epochs, args.lr, args.optimizer,
            args.eval_every, args.num_samples, args.embed_dim, args.enc_depth,
            args.dec_depth, args.device) == (128, 35, 5, 1e-4, "adam", 5, 5, 512, 6, 4, "cuda")
