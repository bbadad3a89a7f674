"""The port's ObjectTransformer (models/object_transformer.py) and its
reference-checkpoint loader (convert/object_transformer.py) against the
JAX package's.

Tiny widths (token_dim 32, 4 heads, 2 + 2 blocks), inputs from a numpy
seed with masked tokens (a stream missing at some frames) and one invalid
hand, the JAX weights carried over by `from_jax_object_transformer`, and
JAX's own draws fed to the port (`eps`, `z`), so both compute the same
numbers. The JAX side runs jitted, once per function and shape (module
fixtures). Tolerances: fp32 throughout, rtol 1e-5 / atol 1e-6 on losses
and activations (sums in another order), rtol 1e-4 / atol 1e-6 on the
gradients and the rollout (through four decoder passes and the CVAE).
"""

import numpy as np
import pytest
import jax
import torch

from handsonvlm_tpu.convert.object_transformer import convert_object_transformer
from handsonvlm_tpu.models import object_transformer as jot
from handsonvlm_torch.convert.object_transformer import (
    from_jax_object_transformer,
    load_named,
    load_object_transformer,
)
from handsonvlm_torch.models import object_transformer as tot

DIMS = dict(token_dim=32, coord_dim=8, num_heads=4, enc_depth=2, dec_depth=2,
            hidden_dim=16, latent_dim=8)
GLOBAL = dict(DIMS, num_patches=1, global_only=True)
KEYS = ("feat", "bbox_feat", "valid_mask", "future_hands", "contact_point", "future_valid")
TOL = dict(rtol=1e-5, atol=1e-6)
DEEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(b=3, t=10, seed=0):
    """Stream 2 (the left hand) missing at odd frames, the left object
    missing throughout, clip 1 with no valid right hand."""
    rng = np.random.default_rng(seed)
    valid = np.ones((b, 5, t), np.float32)
    valid[:, 2, 1::2] = 0
    valid[:, 4] = 0
    fv = np.ones((b, 2), np.float32)
    fv[1, 0] = 0
    return {
        "feat": rng.normal(size=(b, 5, t, 1024)).astype(np.float32),
        "bbox_feat": rng.uniform(size=(b, 4, t, 4)).astype(np.float32),
        "valid_mask": valid,
        "future_hands": rng.uniform(size=(b, 2, 5, 2)).astype(np.float32),
        "contact_point": rng.uniform(size=(b, 2)).astype(np.float32),
        "future_valid": fv,
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def forward_eps(key, b, t_pred, latent):
    """JAX's draws in `object_transformer_forward` (and lita_hoi_forward's
    after its encode key): split(key, 3) -> traj, obj_r, obj_l noise."""
    r_tf, r_r, r_l = jax.random.split(key, 3)
    return {"traj": _t(jax.random.normal(r_tf, (b * 2 * (t_pred - 1), latent))),
            "obj_r": _t(jax.random.normal(r_r, (b, latent))),
            "obj_l": _t(jax.random.normal(r_l, (b, latent)))}


def rollout_z(rngs, b, latent, z_scale, pred_len=4):
    """JAX's latents in the rollout from its split keys (first_r, first_l,
    roll_r, roll_l, contact_r, contact_l): z_scale * normal."""
    def nz(k):
        return z_scale * np.asarray(jax.random.normal(k, (b, latent)))

    def roll(k):
        return np.stack([nz(jax.random.fold_in(k, i)) for i in range(pred_len)])

    z = {"first_r": nz(rngs[0]), "first_l": nz(rngs[1]), "roll_r": roll(rngs[2]),
         "roll_l": roll(rngs[3]), "contact_r": nz(rngs[4]), "contact_l": nz(rngs[5])}
    return {k: _t(v) for k, v in z.items()}


def inference_z(key, b, cfg, pred_len=4):
    rngs = jax.random.split(key, 2 * (pred_len + 1) + 3)
    return rollout_z(rngs, b, cfg.latent_dim, cfg.z_scale, pred_len)


class Pair:
    def __init__(self, dims, seed=0):
        self.jcfg = jot.ObjectTransformerConfig(**dims)
        self.cfg = tot.ObjectTransformerConfig(**dims)
        self.params = jot.init_object_transformer(jax.random.PRNGKey(seed), self.jcfg)
        self.model = tot.ObjectTransformer(self.cfg)
        load_named(self.model, from_jax_object_transformer(self.params))
        jcfg = self.jcfg
        self.j_forward = jax.jit(lambda p, bt, k: jot.object_transformer_forward(
            p, jcfg, *(bt[n] for n in KEYS), k))
        self.j_loss = jax.jit(lambda p, bt, k: jot.hoi_forecast_loss(p, jcfg, bt, k))
        self.j_grad = jax.jit(jax.grad(lambda p, bt, k: jot.hoi_forecast_loss(p, jcfg, bt, k)[0]))
        self.j_infer = jax.jit(lambda p, bt, k: jot.object_transformer_inference(
            p, jcfg, bt["feat"], bt["bbox_feat"], bt["valid_mask"], bt["future_valid"], k))


@pytest.fixture(scope="module")
def pair():
    return Pair(DIMS)


@pytest.fixture(scope="module")
def pair_global():
    return Pair(GLOBAL, seed=1)


def test_sinusoidal_time_encoding_matches_jax():
    np.testing.assert_array_equal(tot.sinusoidal_time_encoding(10, 32).numpy(),
                                  np.asarray(jot.sinusoidal_time_encoding(10, 32)))


def test_encoder_with_masked_tokens(pair):
    """encoder_input + apply_encoder with masked tokens against JAX; a
    masked stream's values reach no other token."""
    batch = _batch()
    src = batch["valid_mask"].transpose(0, 2, 1)
    jt, jm = jot.encoder_input(pair.params, pair.jcfg, batch["feat"], batch["bbox_feat"], src)
    want = jot.apply_encoder(pair.params["encoder"], pair.jcfg, jt, jm)
    with torch.no_grad():
        tt, tm = tot.encoder_input(pair.model, pair.cfg, _t(batch["feat"]),
                                   _t(batch["bbox_feat"]), _t(src))
        got = tot.apply_encoder(pair.model.oct_encoder, pair.cfg, tt, tm)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        mask2 = tm.clone()
        mask2[:, :, 2] = 0
        a = tot.apply_encoder(pair.model.oct_encoder, pair.cfg, tt, mask2)
        perturbed = tt.clone()
        perturbed[:, :, 2] += 100.0
        c = tot.apply_encoder(pair.model.oct_encoder, pair.cfg, perturbed, mask2)
    keep = [0, 1, 3, 4]
    np.testing.assert_allclose(a[:, :, keep].numpy(), c[:, :, keep].numpy(), atol=1e-4)
    assert not np.allclose(a.numpy(), got.numpy())


def test_decoder_against_jax_and_causal(pair):
    rng = np.random.default_rng(3)
    mem = rng.normal(size=(2, 5, 32)).astype(np.float32)
    mem_mask = np.ones((2, 1, 5), np.float32)
    mem_mask[1, 0, 3:] = 0
    coords = rng.uniform(size=(2, 4, 2)).astype(np.float32)
    want = jot.apply_decoder(pair.params["decoder"], pair.jcfg, coords, mem, mem_mask)
    with torch.no_grad():
        got = tot.apply_decoder(pair.model.oct_decoder, pair.cfg, _t(coords), _t(mem),
                                _t(mem_mask))
        coords2 = _t(coords)
        coords2[:, 3] = 99.0
        got2 = tot.apply_decoder(pair.model.oct_decoder, pair.cfg, coords2, _t(mem),
                                 _t(mem_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[:, :3].numpy(), got2[:, :3].numpy(), atol=1e-6)
    assert not np.allclose(got[:, 3].numpy(), got2[:, 3].numpy())


@pytest.mark.parametrize("case", ["mixed", "no_valid_hand", "global_only"])
def test_forward_losses(pair, pair_global, case):
    """Every per-clip loss against JAX's, with masked tokens and an invalid
    hand ("mixed"), with no valid hand in the batch (the batch-global gate:
    the contact loss is 0 for every clip) and in the global-only variant."""
    p = pair_global if case == "global_only" else pair
    batch = _batch()
    if case == "no_valid_hand":
        batch["future_valid"] = np.zeros_like(batch["future_valid"])
    key = jax.random.PRNGKey(7)
    want = p.j_forward(p.params, batch, key)
    with torch.no_grad():
        got = tot.object_transformer_forward(p.model, p.cfg, *(_t(batch[k]) for k in KEYS),
                                             eps=forward_eps(key, 3, 5, p.cfg.latent_dim))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (3,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    if case == "no_valid_hand":
        for k in ("traj_loss", "obj_loss", "obj_kl_loss", "last_hand_loss"):
            assert not got[k].any(), k


def test_hoi_forecast_loss_and_gradients(pair):
    """hoi_forecast_loss's terms, and jax.grad against torch autograd leaf
    by leaf (the JAX gradient tree carried over by the same bridge)."""
    batch = _batch()
    key = jax.random.PRNGKey(11)
    j_total, j_terms = pair.j_loss(pair.params, batch, key)
    j_grads = from_jax_object_transformer(pair.j_grad(pair.params, batch, key))
    eps = forward_eps(key, 3, 5, pair.cfg.latent_dim)
    pair.model.zero_grad(set_to_none=True)
    total, terms = tot.hoi_forecast_loss(pair.model, pair.cfg, _tb(batch), eps=eps)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    assert set(terms) == set(j_terms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(j_terms[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    grads = {n: p.grad for n, p in pair.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for n, g in grads.items():
        g = torch.zeros_like(pair.model.get_parameter(n)) if g is None else g
        scale = float(np.abs(j_grads[n]).max()) + 1e-30
        np.testing.assert_allclose(g.numpy() / scale, j_grads[n] / scale, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    pair.model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("variant", ["default", "global_only"])
def test_inference_rollout_with_injected_z(pair, pair_global, variant):
    p = pair_global if variant == "global_only" else pair
    batch = _batch()
    key = jax.random.PRNGKey(5)
    want_hand, want_contact = p.j_infer(p.params, batch, key)
    with torch.no_grad():
        hand, contact = tot.object_transformer_inference(
            p.model, p.cfg, _t(batch["feat"]), _t(batch["bbox_feat"]), _t(batch["valid_mask"]),
            _t(batch["future_valid"]), z=inference_z(key, 3, p.cfg))
    assert hand.shape == (3, 2, 4, 2) and contact.shape == (3, 2)
    np.testing.assert_allclose(hand.numpy(), np.asarray(want_hand), **DEEP_TOL)
    np.testing.assert_allclose(contact.numpy(), np.asarray(want_contact), **DEEP_TOL)


def test_hoi_forecast_sample(pair):
    """Three samples: JAX vmaps over split(key, 3); the port rolls out the
    one encoding with each sample's latents."""
    batch = _batch()
    key = jax.random.PRNGKey(9)
    want_h, want_c = jax.jit(lambda p, bt, k: jot.hoi_forecast_sample(
        p, pair.jcfg, bt, k, num_samples=3))(pair.params, batch, key)
    zs = [inference_z(k, 3, pair.cfg) for k in jax.random.split(key, 3)]
    with torch.no_grad():
        hands, contacts = tot.hoi_forecast_sample(pair.model, pair.cfg, _tb(batch), 3, z=zs)
        gen_hands, _ = tot.hoi_forecast_sample(pair.model, pair.cfg, _tb(batch), 3,
                                               generator=torch.Generator().manual_seed(0))
    assert hands.shape == (3, 3, 2, 4, 2) and contacts.shape == (3, 3, 2)
    np.testing.assert_allclose(hands.numpy(), np.asarray(want_h), **DEEP_TOL)
    np.testing.assert_allclose(contacts.numpy(), np.asarray(want_c), **DEEP_TOL)
    assert not np.allclose(gen_hands[:, 0].numpy(), gen_hands[:, 1].numpy())


def test_traj_affordance_dist_against_jax():
    rng = np.random.default_rng(4)
    hand_traj = rng.uniform(size=(3 * 2 * 4, 2)).astype(np.float32)
    contact = rng.uniform(size=(3, 2)).astype(np.float32)
    fv = np.asarray([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], np.float32)
    want = jot.traj_affordance_dist(hand_traj, contact, fv)
    got = tot.traj_affordance_dist(_t(hand_traj), _t(contact), _t(fv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[2]) == 0.0


def test_reference_state_dict_load(pair):
    """A state dict under the reference's names (no q/k/v biases, two
    linears saved without bias, a stray q bias the model never reads) loads
    into the port and, through the JAX package's converter, into JAX: the
    two compute the same losses."""
    gen = torch.Generator().manual_seed(2)
    ref = {k: torch.randn(v.shape, generator=gen) * 0.05
           for k, v in pair.model.state_dict().items()}
    del ref["downproject.bias"], ref["oct_decoder.target_embedding.bias"]
    ref["oct_encoder.encoder_blocks.0.attn.proj_q.bias"] = torch.ones(32)
    sd = {"module." + k: v for k, v in ref.items()}
    model = tot.ObjectTransformer(pair.cfg)
    load_object_transformer(model, sd, prefix="module.")
    assert not model.downproject.bias.any()
    params = convert_object_transformer(sd, pair.jcfg, prefix="module.")
    batch = _batch(seed=5)
    key = jax.random.PRNGKey(3)
    want = pair.j_forward(params, batch, key)
    with torch.no_grad():
        got = tot.object_transformer_forward(model, pair.cfg, *(_t(batch[k]) for k in KEYS),
                                             eps=forward_eps(key, 3, 5, pair.cfg.latent_dim))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    del sd["module.oct_encoder.norm.weight"]
    with pytest.raises(KeyError, match="oct_encoder.norm.weight"):
        load_object_transformer(model, sd, prefix="module.")


def test_init_draws_the_reference_distributions():
    """The port's own init: trunc-normal x 0.02 weights within 2 std, zero
    biases, unit layer-norm scales, uniform CVAE weights."""
    cfg = tot.ObjectTransformerConfig(**DIMS)
    model = tot.ObjectTransformer(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.oct_encoder.encoder_blocks[0].mlp.fc1.weight
    assert float(w.abs().max()) <= 0.04 + 1e-7 and 0.01 < float(w.std()) < 0.03
    assert not model.oct_encoder.encoder_blocks[0].mlp.fc1.bias.any()
    assert bool((model.oct_decoder.norm.weight == 1).all())
    cv = model.hand_head.cvae.enc_MLP[0]
    assert float(cv.weight.abs().max()) <= 1 / cv.in_features ** 0.5
    assert cv.bias.any()
