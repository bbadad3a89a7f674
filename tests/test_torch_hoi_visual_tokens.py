"""The port's visual-token fusion (models/visual_tokens.py) against the JAX
package's: `fuse_hoi_features` in every mode and ablation, and
`visual_pipeline` in the 'origin' (CLIP on the frames), 'origin-random'
and hoi modes.

Inputs from a numpy seed (some streams missing at some frames), the JAX
weights carried over by the port's bridges (`from_jax_hoi_encoder`,
`from_jax_params`), the '-random' draws JAX's own uniform draws passed in
as `noise`. Tolerance: fp32, rtol 1e-5 / atol 1e-5 on the tokens (1024-wide
sums in another order); the masks exactly.
"""

import numpy as np
import pytest
import jax
import torch

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models import visual_tokens as jvt
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.convert.object_transformer import from_jax_hoi_encoder, load_named
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.models import visual_tokens as tvt
from handsonvlm_torch.models.visual_tokens import HoiEncoder

TOL = dict(rtol=1e-5, atol=1e-5)
BASES = ("hoi", "hoi-hand", "hoi-global", "clip")
ABLATIONS = ("", "-random", "-reverse", "-random-zero-embed-one-attention")
B, T, D = 2, 10, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, 5, T), np.float32)
    valid[0, 2, 1::2] = 0
    valid[1, 3:, :4] = 0
    return (rng.normal(size=(B, 5, T, 1024)).astype(np.float32),
            rng.uniform(size=(B, 4, T, 4)).astype(np.float32), valid)


def _t(x):
    return torch.from_numpy(np.array(x))


class Holder(torch.nn.Module):
    """What visual_pipeline reads in the hoi modes: hoi_encoder, projector."""

    def __init__(self, hoi_params, proj):
        super().__init__()
        self.hoi_encoder = HoiEncoder()
        load_named(self.hoi_encoder, from_jax_hoi_encoder(hoi_params))
        self.projector = torch.nn.Linear(1024, D)
        with torch.no_grad():
            self.projector.weight.copy_(_t(proj["kernel"]).T)
            self.projector.bias.copy_(_t(proj["bias"]))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(1)
    hoi_params = jvt.init_hoi_encoder(jax.random.PRNGKey(0))
    proj = {"kernel": (rng.normal(size=(1024, D)) * 0.02).astype(np.float32),
            "bias": rng.normal(size=(D,)).astype(np.float32) * 0.1}
    return hoi_params, proj, Holder(hoi_params, proj)


@pytest.mark.parametrize("ablation", ABLATIONS, ids=lambda a: a or "plain")
@pytest.mark.parametrize("base", BASES)
def test_fuse_hoi_features(weights, base, ablation):
    hoi_params, proj, holder = weights
    mode = base + ablation
    feat, bbox, valid = _inputs()
    key = jax.random.PRNGKey(3)
    want_tok, want_attn = jvt.fuse_hoi_features(hoi_params, proj, mode, feat, bbox, valid,
                                                rng=key)
    noise = None
    if ablation == "-random":
        noise = _t(jax.random.uniform(key, want_tok.shape, want_tok.dtype))
    with torch.no_grad():
        tok, attn = tvt.fuse_hoi_features(holder.hoi_encoder, holder.projector, mode, _t(feat),
                                          _t(bbox), _t(valid), noise=noise)
    assert tok.shape == want_tok.shape and attn.dtype == torch.bool
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), **TOL)


def test_random_ablation_draws_from_a_generator(weights):
    _, _, holder = weights
    feat, bbox, valid = _inputs()
    with torch.no_grad():
        a, _ = tvt.fuse_hoi_features(holder.hoi_encoder, holder.projector, "hoi-random",
                                     _t(feat), _t(bbox), _t(valid),
                                     generator=torch.Generator().manual_seed(0))
        plain, _ = tvt.fuse_hoi_features(holder.hoi_encoder, holder.projector, "hoi",
                                         _t(feat), _t(bbox), _t(valid))
    assert float(a.min()) >= 0 and float(a.max()) < 1 and not torch.allclose(a, plain)
    with pytest.raises(ValueError, match="noise"):
        tvt.fuse_hoi_features(holder.hoi_encoder, holder.projector, "hoi-random", _t(feat),
                              _t(bbox), _t(valid))


def test_hoi_hand_fusion_gets_no_gradient(weights):
    """'hoi-hand' computes the fusion and drops it: feat_fusion's gradient
    is zero in JAX and absent in the port, the downproject's is not."""
    hoi_params, proj, holder = weights
    feat, bbox, valid = _inputs()

    def jloss(p):
        tok, _ = jvt.fuse_hoi_features(p, proj, "hoi-hand", feat, bbox, valid)
        return (tok ** 2).sum()

    jgrad = jax.grad(jloss)(hoi_params)
    assert not np.asarray(jgrad["feat_fusion"]["kernel"]).any()
    holder.zero_grad(set_to_none=True)
    tok, _ = tvt.fuse_hoi_features(holder.hoi_encoder, holder.projector, "hoi-hand", _t(feat),
                                   _t(bbox), _t(valid))
    (tok ** 2).sum().backward()
    assert holder.hoi_encoder.feat_fusion[0].weight.grad is None
    np.testing.assert_allclose(holder.hoi_encoder.downproject.weight.grad.numpy(),
                               np.asarray(jgrad["downproject"]["kernel"]).T, rtol=1e-4, atol=1e-5)
    holder.zero_grad(set_to_none=True)


@pytest.mark.parametrize("video_arch", ["none", "temporal"])
@pytest.mark.parametrize("mode", ["hoi", "hoi-hand-reverse"])
def test_visual_pipeline_hoi_modes(weights, mode, video_arch):
    hoi_params, proj, holder = weights
    jcfg = jax_tiny_config(fuse_input_mode=mode, video_arch=video_arch, mm_hidden_size=1024)
    cfg = tiny_config(fuse_input_mode=mode, video_arch=video_arch, mm_hidden_size=1024)
    feat, bbox, valid = _inputs(2)
    params = {"hoi_encoder": hoi_params, "projector": proj}
    want_tok, want_attn = jvt.visual_pipeline(params, jcfg, feat=feat, bbox_feat=bbox,
                                              valid_mask=valid)
    with torch.no_grad():
        tok, attn = tvt.visual_pipeline(holder, cfg, feat=_t(feat), bbox_feat=_t(bbox),
                                        valid_mask=_t(valid))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), **TOL)


@pytest.fixture(scope="module")
def vlm():
    """A tiny HandsOnVLM (CLIP tower + projector) in both packages."""
    jcfg = jax_tiny_config()
    params = init_handsonvlm(jax.random.PRNGKey(4), jcfg)
    model = build_model(tiny_config(), "cpu")
    load_state_dict_into(model, from_jax_params(params))
    return params, model


@pytest.mark.parametrize("mode", ["origin", "origin-random"])
def test_visual_pipeline_origin(vlm, mode):
    """CLIP on 3 frames a clip -> projector -> pooling, against JAX's
    `visual_pipeline` (its CLIP through the plain attention route)."""
    params, model = vlm
    jcfg = jax_tiny_config(fuse_input_mode=mode)
    cfg = tiny_config(fuse_input_mode=mode)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 3, 3, 56, 56)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want_tok, want_attn = jvt.visual_pipeline(params, jcfg, images=images, rng=key,
                                              attn_impl="xla")
    noise = None
    if mode == "origin-random":
        shape = (2, 3, cfg.vision.num_patches, cfg.llama.hidden_size)
        noise = _t(jax.random.uniform(key, shape, np.float32))
    with torch.no_grad():
        tok, attn = tvt.visual_pipeline(model, cfg, images=_t(images), noise=noise)
    assert tok.shape == want_tok.shape == (2, 3 + cfg.vision.num_patches, 64)
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), **TOL)
