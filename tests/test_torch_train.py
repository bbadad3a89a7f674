"""The port's train step (handsonvlm_torch/train) against the JAX package's.

- Ports of tests/test_train_step.py's single-device tests: the loss falls
  with the CLIP tower frozen and bit-identical; the cosine schedule (also
  against optax's, step by step); a QLoRA int4 step keeps the packed base
  bit-identical and moves the adapters; every remat policy gives no-remat's
  numbers; an unknown policy raises.
- Three steps against JAX's `make_train_step` from the same weights, in
  fp32 at the tiny preset, for full SFT, LoRA, QLoRA int4 (the tiled
  int4 base, every projection on B5b / B7b's plain versions: 142 rows, the
  Pallas kernels in interpret mode on the JAX side) and QLoRA int8_fused
  (B10a / B10b's plain versions against JAX's fused kernels). The CVAE
  draws are JAX's, `normal(fold_in(rng, step))`, passed in as `eps`. Each
  step's loss within 1e-5 relative (the QLoRA modes: see LOSS_RTOL), the
  trainable
  weights after three steps within
  1e-4 (atol and rtol: f32 sums in another order, through three AdamW
  steps), and the first step's `grad_norm` against the norm JAX's clip
  reads, computed here from JAX's gradients and its trainable mask (JAX's
  logged norm also counts the frozen decoder's gradients under LoRA).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.models.lora import init_lora as jax_init_lora
from handsonvlm_tpu.train import step as jstep
from handsonvlm_tpu.train import train_state as jts
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.models.llama import REMAT_POLICIES, apply_llama
from handsonvlm_torch.models.lora import LoRA, init_lora
from handsonvlm_torch.train.step import make_eval_step, make_train_step
from handsonvlm_torch.train.train_state import (
    AdamW,
    cosine_schedule,
    create_train_state,
    make_optimizer,
)

JCFG = jax_tiny_config()
CFG = tiny_config()
LORA_FREEZE = ("vision", "llama")


def _batch(b=2, t=16, seed=0):
    """tests/test_train_step.py's batch: the image sentinel at 1, four hand
    tokens, labels from position 7 (numpy)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(b, t))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[:, [8, 10, 12, 14]] = HAND_TOKEN_ID
    labels = np.full((b, t), IGNORE_INDEX)
    labels[:, 7:] = ids[:, 7:]
    return {
        "input_ids": ids,
        "attn_mask": np.ones((b, t), bool),
        "image": rng.normal(size=(b, CFG.num_frames, 3, CFG.vision.image_size,
                                  CFG.vision.image_size)).astype(np.float32),
        "labels": labels,
        "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
        "future_valid": np.ones((b, 2), np.float32),
    }


def _lora_model(quantize=None, r=2, alpha=4.0):
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu", quantize=quantize)
    model.lora = init_lora(torch.Generator().manual_seed(3), cfg.llama, r=r, alpha=alpha)
    return model, cfg


# ---------------------------------------------------------------------------
# Ports of tests/test_train_step.py
# ---------------------------------------------------------------------------


def test_loss_decreases_and_vision_frozen():
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    vision_before = {k: v.clone() for k, v in model.vision.state_dict().items()}
    opt = make_optimizer(model, learning_rate=1e-3)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="xla")
    batch = _batch()
    losses = [step(state, batch, 1)["loss"] for _ in range(5)]
    assert losses[-1] < losses[0], losses
    assert state.step == 5
    for k, v in model.vision.state_dict().items():
        torch.testing.assert_close(v, vision_before[k], atol=0, rtol=0)
    assert not any(p.requires_grad for p in model.vision.parameters())
    assert all(p.requires_grad for p in model.llama.parameters())
    metrics = make_eval_step(cfg, attn_impl="xla")(model, batch, 1)
    assert set(metrics) == {"loss", "text_loss", "traj_loss", "traj_kl_loss"}


def test_encode_video_stops_clip_gradient():
    """The CLIP features carry no gradient (the JAX package's stop_gradient
    on the frozen tower), even when the tower's weights would take one; the
    projector after it still gets its gradient."""
    from handsonvlm_torch.models.handsonvlm import encode_video

    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    model.requires_grad_(True)
    images = torch.from_numpy(_batch()["image"])
    encode_video(model, cfg, images, attn_impl="xla").square().sum().backward()
    assert all(p.grad is None for p in model.vision.parameters())
    assert model.projector.weight.grad is not None
    assert float(model.projector.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("mu_bf16", [False, True], ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_optax(max_norm, weight_decay, mu_bf16):
    """`AdamW` against optax's chain(clip_by_global_norm, adamw) on the same
    f32 parameters and gradients over four steps of a cosine schedule (the
    first at lr 0): the clip's trigger and scale, the bias correction, the
    first moment stored in bf16 (`mu_dtype`), the decoupled weight decay;
    parameters within 1e-6 relative, the returned norm equal to optax's
    global norm."""
    import optax

    rng = np.random.default_rng(4)
    shapes = [(3, 5), (7,), (2, 2, 4)]
    params = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = [[rng.normal(size=sh).astype(np.float32) for sh in shapes] for _ in range(4)]
    sched = jts.cosine_schedule(1e-2, total_steps=10, warmup_ratio=0.2)
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adamw(sched, weight_decay=weight_decay,
                                 mu_dtype=jnp.bfloat16 if mu_bf16 else None))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW([{"params": tp}], cosine_schedule(1e-2, 10, 0.2), weight_decay=weight_decay,
                max_grad_norm=max_norm, mu_dtype=torch.bfloat16 if mu_bf16 else None)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rtol=1e-6)
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if mu_bf16:
        assert opt.state[tp[0]]["mu"].dtype == torch.bfloat16


def test_cosine_schedule():
    sched = cosine_schedule(2e-5, total_steps=1000, warmup_ratio=0.03)
    assert float(sched(0)) == 0.0
    assert float(sched(30)) == np.float32(2e-5)
    assert float(sched(1000)) < 1e-7
    assert 0 < float(sched(500)) < 2e-5
    want = jts.cosine_schedule(2e-5, total_steps=1000, warmup_ratio=0.03)
    for s in (0, 1, 7, 29, 30, 31, 250, 500, 999, 1000, 1200):
        np.testing.assert_allclose(sched(s), float(want(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(s))


def test_qlora_int4_step():
    """QLoRA: the frozen tiled int4 base + trainable adapters. The gradient
    runs through the int4 products (their autograd Function, B7b's plain
    version on the CPU); the loss falls, the packed base and its scales stay
    bit-identical, and the adapters move."""
    model, cfg = _lora_model("int4")
    int4_before = {k: v.clone() for k, v in model.llama.int4.state_dict().items()}
    b_before = model.lora.adapters["wq"].b.detach().clone()
    opt = make_optimizer(model, learning_rate=5e-3, freeze_top_keys=LORA_FREEZE)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="xla")
    batch = _batch()
    losses = [step(state, batch, 1)["loss"] for _ in range(5)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    for k, v in model.llama.int4.state_dict().items():
        torch.testing.assert_close(v, int4_before[k], atol=0, rtol=0)
    assert float((model.lora.adapters["wq"].b.detach() - b_before).abs().max()) > 0


def test_remat_policies_match():
    """Every remat policy gives no-remat's loss, gradient norm and updated
    adapters (remat changes what is saved for the backward, never the
    math): bit for bit on the CPU, where the recompute repeats the same
    ops."""
    batch = _batch(seed=5)
    results = {}
    for remat in (False, *REMAT_POLICIES):
        model, cfg = _lora_model()
        with torch.no_grad():
            model.lora.adapters["wq"].b.normal_(0, 0.02, generator=torch.Generator().manual_seed(1))
        opt = make_optimizer(model, learning_rate=1e-3, freeze_top_keys=LORA_FREEZE)
        m = make_train_step(cfg, opt, attn_impl="xla", remat=remat)(
            create_train_state(model, opt), batch, 1)
        results[remat] = (m["loss"], m["grad_norm"],
                          [p.detach().clone() for p in model.lora.parameters()])
    base = results[False]
    for k, v in results.items():
        assert v[0] == base[0] and v[1] == base[1], (k, v[:2], base[:2])
        for a, b in zip(v[2], base[2]):
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=str(k))


def test_remat_bad_policy_raises():
    model, cfg = _lora_model()
    ids = torch.arange(6)[None] + 3
    with pytest.raises(ValueError, match="save_lora"):
        apply_llama(model.llama, cfg.llama, input_ids=ids, attn_impl="xla", remat="nope")


# ---------------------------------------------------------------------------
# Three steps against the JAX package's make_train_step
# ---------------------------------------------------------------------------


# the decoder's quantize mode in each parity case
QUANT = {"sft": None, "lora": None, "qlora_int4": "int4", "qlora_int8_fused": "int8_fused"}


def _jax_params(mode):
    if QUANT[mode]:
        params, _, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize=QUANT[mode])
    else:
        params = jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0))
    if mode != "sft":
        lora = jax_init_lora(jax.random.PRNGKey(3), JCFG.llama, r=4, alpha=8.0)
        rng = np.random.default_rng(8)
        lora["adapters"] = {t: {"a": ad["a"], "b": jnp.asarray(
            0.02 * rng.normal(size=ad["b"].shape), jnp.float32)}
            for t, ad in lora["adapters"].items()}
        params = dict(params, lora=lora)
    return params


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


# each step's losses, relative. The int4 products round their input to bf16
# (B5b's contract, the same in both packages), so an f32 difference upstream
# (CLIP, the norms: another summation order) now and then lands an element
# one bf16 step apart; at 142 rows that moves the forward's hidden states by
# 2.1e-4 relative L2 and the trajectory loss by 3.7e-5 (the text loss by
# 6e-7) before any training, and the trajectory loss by 2.4e-4 at the second
# step (the loss by 1.1e-4), hence 5e-4 for QLoRA int4; its weights after
# three steps are held by their mean difference (1e-5) and, element by
# element, by three Adam steps (3 lr). QLoRA int8_fused: B10a / B10b round
# every projection's output and dx to bf16 (the fused kernels' contract, in
# both packages), so the same flips move the trajectory loss by 2.1e-4 at
# the first step and 4.8e-4 at the third (the text loss by 1.6e-6), hence
# 1e-3; its weights under QLoRA int4's rule (measured mean 7.8e-6, max
# 2.0e-3), and its first grad_norm (the adapters' gradients see the same
# flips through bf16 dx, u and v: 1.8e-4 from JAX's clip norm) within 1e-3.
LOSS_RTOL = {"sft": 1e-5, "lora": 1e-5, "qlora_int4": 5e-4, "qlora_int8_fused": 1e-3}
GRAD_NORM_RTOL = {"sft": 1e-4, "lora": 1e-4, "qlora_int4": 1e-4, "qlora_int8_fused": 1e-3}
LR = 1e-3


@pytest.mark.parametrize("mode", ["sft", "lora", "qlora_int4", "qlora_int8_fused"])
def test_three_steps_match_jax(mode):
    freeze = ("vision",) if mode == "sft" else LORA_FREEZE
    params = _jax_params(mode)
    batch = _batch(t=48, seed=2)  # 2 x 71 = 142 rows after the splice
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    n_eps = batch["input_ids"].shape[0] * 2 * 4

    # the norm JAX's clip reads at step 0: its gradients over the trainable mask
    grads = jax.jit(jax.grad(lambda p: jstep.loss_fn(
        p, JCFG, jbatch, jax.random.fold_in(rng, 0), "xla")[0], allow_int=True))(params)
    mask = dict(_leaves(jts._trainable_mask(params, freeze)))
    clip_norm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for path, g in _leaves(grads)
                            if mask[path] == "train" and g.dtype != jax.dtypes.float0))

    # the port's model from the same weights (JAX's step donates its state)
    model = build_model(CFG, "cpu", quantize=QUANT[mode])
    if mode != "sft":
        model.lora = LoRA(CFG.llama, r=4, alpha=8.0)
    load_state_dict_into(model, from_jax_params(params))

    tx = jts.make_optimizer(learning_rate=LR, params_template=params,
                            freeze_top_keys=freeze)
    jstate = jts.create_train_state(params, tx)
    jtrain = jstep.make_train_step(JCFG, tx, attn_impl="xla")
    want = []
    for _ in range(3):
        jstate, m = jtrain(jstate, jbatch, rng)
        want.append({k: float(v) for k, v in m.items()})

    opt = make_optimizer(model, learning_rate=LR, freeze_top_keys=freeze)
    state = create_train_state(model, opt)
    step = make_train_step(CFG, opt, attn_impl="xla")
    got = []
    for i in range(3):
        eps = np.asarray(jax.random.normal(jax.random.fold_in(rng, i),
                                           (n_eps, CFG.traj.latent_dim)))
        got.append(step(state, batch, 1, eps=torch.from_numpy(eps.copy())))

    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "text_loss", "traj_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL[mode],
                                       err_msg=f"step {i} {k}")
    np.testing.assert_allclose(got[0]["grad_norm"], clip_norm, rtol=GRAD_NORM_RTOL[mode])
    if mode != "sft":  # JAX's logged norm also counts the frozen decoder
        assert want[0]["grad_norm"] > 1.01 * clip_norm

    # JAX's weights after its three steps, loaded into a second port model
    ref = build_model(CFG, "cpu", quantize=QUANT[mode])
    ref.lora = None if mode == "sft" else LoRA(CFG.llama, r=4, alpha=8.0)
    load_state_dict_into(ref, from_jax_params(jstate.params))
    ref_params = dict(ref.named_parameters())
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trained} == (
        {"llama", "projector", "traj"} if mode == "sft" else {"lora", "projector", "traj"})
    for name, p in trained:
        got_p, want_p = p.detach().numpy(), ref_params[name].detach().numpy()
        if QUANT[mode]:
            # Adam moves each element by about lr a step whatever its
            # gradient's size: an element whose tiny gradient took the other
            # sign after a rounding flip lands up to 2 lr a step away
            diff = np.abs(got_p - want_p)
            assert diff.mean() <= 1e-5 and diff.max() <= 3 * LR, (name, diff.mean(), diff.max())
        else:
            np.testing.assert_allclose(got_p, want_p, atol=1e-4, rtol=1e-4, err_msg=name)
    for (name, buf), (_, want_buf) in zip(model.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(buf, want_buf, atol=0, rtol=0, msg=name)
