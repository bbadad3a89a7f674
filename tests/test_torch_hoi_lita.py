"""The port's LITA-HOI (models/lita_hoi.py) against the JAX package's.

A tiny decoder (2 layers, width 64) encodes 2 clips x 10 frames of fused
hoi tokens with some streams missing at some frames; the JAX weights are
carried over by `from_jax_lita_hoi`, JAX's draws fed to the port (the
encode key's uniform noise for '-random', the CVAE noise, the rollout
latents). Covered: the loss terms in the 'hoi', 'hoi-hand', 'hoi-global',
'hoi-random' and 'hoi-reverse' modes on the plain route ('-reverse' leaves
query rows with no valid key, where the port's plain attention averages as
JAX's `attention_xla` does), jax.grad against torch autograd leaf by leaf,
the rollout with and without `gt_hand_valid`, and the flash route (its
plain version here) against the plain one: this batch leaves every query
row a valid key, so all rows compare. Tolerances: fp32, rtol 1e-5 / atol
1e-6 on the loss terms, rtol 1e-4 on the gradients (scaled by each leaf's
largest) and the rollout.
"""

import numpy as np
import pytest
import jax
import torch

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models import lita_hoi as jlh
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.object_transformer import from_jax_lita_hoi, load_named
from handsonvlm_torch.models import lita_hoi as tlh

MODES = ("hoi", "hoi-hand", "hoi-global", "hoi-random", "hoi-reverse")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
DEEP_TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 10


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, 5, T), np.float32)
    valid[0, 2, 1::2] = 0  # the left hand missing at odd frames
    valid[1, 4] = 0  # the left object missing throughout
    valid[1, 1, -1] = 0  # the right hand missing at the last frame
    gt_valid = np.ones((B, 2, 5), bool)
    gt_valid[1, 0] = False
    return {
        "feat": rng.normal(size=(B, 5, T, 1024)).astype(np.float32),
        "bbox_feat": rng.uniform(size=(B, 4, T, 4)).astype(np.float32),
        "valid_mask": valid,
        "future_hands": rng.uniform(size=(B, 2, 5, 2)).astype(np.float32),
        "contact_point": rng.uniform(size=(B, 2)).astype(np.float32),
        "future_valid": np.asarray([[1, 1], [0, 1]], np.float32),
        "gt_hand_valid": gt_valid,
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _n_tokens(mode):
    return {"hoi-hand": 3, "hoi-global": 1}.get(mode, 5)


def forward_draws(key, mode, cfg):
    """lita_hoi_forward's draws: split(key, 4) -> the encode key (the
    '-random' tokens), then the traj, obj_r and obj_l noise."""
    r_enc, r_tf, r_r, r_l = jax.random.split(key, 4)
    lat = cfg.traj.latent_dim
    eps = {"traj": _t(jax.random.normal(r_tf, (B * 2 * 4, lat))),
           "obj_r": _t(jax.random.normal(r_r, (B, lat))),
           "obj_l": _t(jax.random.normal(r_l, (B, lat)))}
    noise = None
    if mode.endswith("-random"):
        shape = (B, T, _n_tokens(mode), cfg.llama.hidden_size)
        noise = _t(jax.random.uniform(r_enc, shape, np.float32))
    return eps, noise


def inference_z(key, cfg, pred_len=4):
    """lita_hoi_inference's latents: split(key, 8)[1..6]."""
    rngs = jax.random.split(key, 8)[1:]
    lat, zs = cfg.traj.latent_dim, cfg.traj.z_scale

    def nz(k):
        return zs * np.asarray(jax.random.normal(k, (B, lat)))

    def roll(k):
        return np.stack([nz(jax.random.fold_in(k, i)) for i in range(pred_len)])

    z = {"first_r": nz(rngs[0]), "first_l": nz(rngs[1]), "roll_r": roll(rngs[2]),
         "roll_l": roll(rngs[3]), "contact_r": nz(rngs[4]), "contact_l": nz(rngs[5])}
    return {k: _t(v) for k, v in z.items()}


class Pair:
    def __init__(self, mode):
        over = dict(fuse_input_mode=mode, video_arch="none", mm_hidden_size=1024)
        self.jcfg, self.cfg = jax_tiny_config(**over), tiny_config(**over)
        self.params = jlh.init_lita_hoi(jax.random.PRNGKey(0), self.jcfg)
        self.model = tlh.LitaHoi(self.cfg)
        load_named(self.model, from_jax_lita_hoi(self.params))
        jcfg = self.jcfg
        self.j_forward = jax.jit(lambda p, bt, k: jlh.lita_hoi_forward(p, jcfg, bt, k,
                                                                        attn_impl="xla"))


_PAIRS = {}


def pair_for(mode):
    if mode not in _PAIRS:
        _PAIRS[mode] = Pair(mode)
    return _PAIRS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_lita_hoi_forward(mode):
    p = pair_for(mode)
    batch = _batch()
    key = jax.random.PRNGKey(1)
    j_loss, j_terms = p.j_forward(p.params, batch, key)
    eps, noise = forward_draws(key, mode, p.cfg)
    with torch.no_grad():
        loss, terms = tlh.lita_hoi_forward(p.model, p.cfg, _tb(batch), eps=eps, noise=noise)
    assert set(terms) == set(j_terms)
    np.testing.assert_allclose(float(loss), float(j_loss), **LOSS_TOL)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(j_terms[k]), **LOSS_TOL, err_msg=k)


def test_lita_hoi_gradients_leaf_by_leaf():
    """jax.grad of lita_hoi_forward's loss against torch autograd over every
    leaf, the decoder's included (its unread head and embedding: zero in
    JAX, no gradient in the port)."""
    p = pair_for("hoi")
    batch = _batch(1)
    key = jax.random.PRNGKey(2)
    grad_fn = jax.jit(jax.grad(lambda prm, bt, k: jlh.lita_hoi_forward(
        prm, p.jcfg, bt, k, attn_impl="xla")[0]))
    j_grads = from_jax_lita_hoi(grad_fn(p.params, batch, key))
    eps, _ = forward_draws(key, "hoi", p.cfg)
    p.model.zero_grad(set_to_none=True)
    loss, _ = tlh.lita_hoi_forward(p.model, p.cfg, _tb(batch), eps=eps)
    loss.backward()
    names = dict(p.model.named_parameters())
    assert set(names) == set(j_grads)
    for n, prm in names.items():
        g = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        scale = float(np.abs(j_grads[n]).max()) + 1e-30
        np.testing.assert_allclose(g.numpy() / scale, j_grads[n] / scale, **DEEP_TOL, err_msg=n)
    assert names["llama.lm_head.weight"].grad is None
    p.model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("gt_valid", [True, False], ids=["gt_hand_valid", "right_hand"])
@pytest.mark.parametrize("mode", ["hoi", "hoi-hand"])
def test_lita_hoi_inference(mode, gt_valid):
    p = pair_for(mode)
    batch = _batch(2)
    if not gt_valid:
        del batch["gt_hand_valid"]
    key = jax.random.PRNGKey(3)
    want_h, want_c = jax.jit(lambda prm, bt, k: jlh.lita_hoi_inference(
        prm, p.jcfg, bt, k, attn_impl="xla"))(p.params, batch, key)
    with torch.no_grad():
        hand, contact = tlh.lita_hoi_inference(p.model, p.cfg, _tb(batch),
                                               z=inference_z(key, p.cfg))
    assert hand.shape == (B, 2, 4, 2) and contact.shape == (B, 2)
    np.testing.assert_allclose(hand.numpy(), np.asarray(want_h), **DEEP_TOL)
    np.testing.assert_allclose(contact.numpy(), np.asarray(want_c), **DEEP_TOL)


def test_lita_hoi_flash_route_matches_the_plain_route():
    """attn_impl="flash" (kernel B3 on the card, its plain version on CPU
    tensors) against the plain route: the loss, its gradients into the
    heads and the HOI encoder, and the rollout. Every query row here has a
    valid key (the global stream is valid at every frame)."""
    p = pair_for("hoi")
    batch = _tb(_batch(3))
    eps, _ = forward_draws(jax.random.PRNGKey(4), "hoi", p.cfg)
    out = {}
    for impl in ("auto", "flash"):
        p.model.zero_grad(set_to_none=True)
        loss, _ = tlh.lita_hoi_forward(p.model, p.cfg, batch, eps=eps, attn_impl=impl)
        loss.backward()
        grads = torch.cat([q.grad.flatten() for n, q in p.model.named_parameters()
                           if q.grad is not None and not n.startswith("llama.")])
        with torch.no_grad():
            hand, contact = tlh.lita_hoi_inference(p.model, p.cfg, batch, attn_impl=impl,
                                                   z=inference_z(jax.random.PRNGKey(5), p.cfg))
        out[impl] = (loss.detach(), grads, hand, contact)
    p.model.zero_grad(set_to_none=True)
    for a, b in zip(out["auto"], out["flash"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_lita_hoi_refuses_pooled_video_arch():
    cfg = tiny_config(fuse_input_mode="hoi", video_arch="temporal", mm_hidden_size=1024)
    model = tlh.LitaHoi(cfg)
    with pytest.raises(ValueError, match="video_arch"):
        tlh.lita_hoi_forward(model, cfg, _tb(_batch()))


def test_lita_hoi_takes_a_loaded_decoder():
    """LitaHoi over another model's Llama shares its weights, and init
    with init_llama=False leaves them as they were."""
    cfg = tiny_config(fuse_input_mode="hoi", video_arch="none", mm_hidden_size=1024)
    base = tlh.LitaHoi(cfg)
    base.init_weights(torch.Generator().manual_seed(0))
    before = base.llama.norm.weight.clone()
    model = tlh.LitaHoi(cfg, llama=base.llama)
    model.init_weights(torch.Generator().manual_seed(1), init_llama=False)
    assert model.llama is base.llama and torch.equal(model.llama.norm.weight, before)
    assert float(model.projector.weight.detach().std()) < 0.03 and not model.projector.bias.any()
