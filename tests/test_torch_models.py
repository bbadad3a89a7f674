"""The port's model modules against the JAX package's, at the tiny preset.

JAX parameters (init_handsonvlm at PRNGKey(0)) are carried over to the port
through `from_jax_params`, the same numpy inputs go through both, and the
outputs are compared in fp32 at atol 1e-5 / rtol 1e-4. Random draws (the
CVAE latent and noise) are made by JAX and passed to the port.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.constants import HAND_TOKEN_ID, IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.sampler import _warp_logits as jax_warp_logits
from handsonvlm_tpu.models import clip_vit as jclip
from handsonvlm_tpu.models import handsonvlm as jhv
from handsonvlm_tpu.models import llama as jllama
from handsonvlm_tpu.models import pooling as jpool
from handsonvlm_tpu.models import projector as jproj
from handsonvlm_tpu.models import traj_cvae as jcvae
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.infer.sampler import _warp_logits
from handsonvlm_torch.models import clip_vit as tclip
from handsonvlm_torch.models import handsonvlm as thv
from handsonvlm_torch.models import llama as tllama
from handsonvlm_torch.models import pooling as tpool
from handsonvlm_torch.models import projector as tproj
from handsonvlm_torch.models import traj_cvae as tcvae

TOL = dict(atol=1e-5, rtol=1e-4)
JCFG = jax_tiny_config()
CFG = tiny_config()


@pytest.fixture(scope="module")
def pair():
    params = jax.jit(lambda k: jhv.init_handsonvlm(k, JCFG))(jax.random.PRNGKey(0))
    model = build_model(CFG, "cpu")
    load_state_dict_into(model, from_jax_params(params))
    return params, model


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_projector(pair):
    params, model = pair
    x = rand((3, 5, CFG.mm_hidden_size), 1)
    close(tproj.apply_projector(model.projector, torch.from_numpy(x)),
          jproj.apply_projector(params["projector"], jnp.asarray(x)))


def test_clip_patch_features(pair):
    params, model = pair
    px = rand((2, 3, 56, 56), 2)
    want = jclip.apply_clip_vision(params["vision"], JCFG.vision, jnp.asarray(px),
                                   attn_impl="xla")
    got = tclip.apply_clip_vision(model.vision, CFG.vision, torch.from_numpy(px))
    assert got.shape == (2, CFG.vision.num_patches, CFG.vision.hidden_size)
    close(got, want)


@pytest.mark.parametrize("arch", ["all", "temporal", "spatial", "temporal_spatial",
                                  "temporal_spatial_pool", "spatial_pool"])
def test_pooling(arch):
    tokens = rand((2, 8, 16, 8), 3)
    close(tpool.pool_video_tokens(torch.from_numpy(tokens), arch),
          jpool.pool_video_tokens(jnp.asarray(tokens), arch))


@pytest.mark.parametrize("per_row", [False, True])
def test_encode_video_frame_map(pair, per_row):
    params, model = pair
    b = 2 if per_row else 1
    images = rand((b, 4, 3, 56, 56), 4)
    fmap = np.tile(np.arange(4), 2)
    if per_row:
        fmap = np.stack([fmap, fmap[::-1]])
    want = jhv.encode_video(params, JCFG, jnp.asarray(images), attn_impl="xla",
                            frame_map=jnp.asarray(fmap))
    got = thv.encode_video(model, CFG, torch.from_numpy(images), frame_map=fmap)
    assert got.shape == (b, CFG.num_visual_tokens, CFG.llama.hidden_size)
    close(got, want)


def test_cvae_inference_fixed_z(pair):
    params, model = pair
    cond = rand((6, CFG.llama.hidden_size // 2), 5)
    key = jax.random.PRNGKey(3)
    want = jcvae.cvae_inference(params["traj"], JCFG.traj, jnp.asarray(cond), key)
    z = JCFG.traj.z_scale * jax.random.normal(key, (6, JCFG.traj.latent_dim))
    got = tcvae.cvae_inference(model.traj, CFG.traj, torch.from_numpy(cond),
                               z=torch.tensor(np.asarray(z)))
    close(got, want)


def test_cvae_loss_fixed_eps(pair):
    params, model = pair
    emb = rand((2, 2, 4, CFG.llama.hidden_size // 2), 6)
    hands = np.random.default_rng(6).uniform(size=(2, 2, 4, 2)).astype(np.float32)
    valid = np.array([[1, 1], [1, 0]], np.float32)
    key = jax.random.PRNGKey(5)
    want = jcvae.traj_decoder_loss(params["traj"], JCFG.traj, jnp.asarray(emb),
                                   jnp.asarray(hands), jnp.asarray(valid), key, 1.0, 1e-3)
    eps = np.array(jax.random.normal(key, (16, JCFG.traj.latent_dim)))
    got = tcvae.traj_decoder_loss(model.traj, CFG.traj, torch.from_numpy(emb),
                                  torch.from_numpy(hands), torch.from_numpy(valid),
                                  1.0, 1e-3, eps=torch.from_numpy(eps))
    for k in ("traj_loss", "traj_kl_loss", "total_loss"):
        close(got[k], want[k])


def _prefill_inputs():
    embeds = rand((2, 10, CFG.llama.hidden_size), 7)
    mask = np.ones((2, 16), bool)
    mask[1, :2] = False  # left padding of row 1
    return embeds, mask


def test_llama_prefill_and_cached_decode(pair):
    """Prefill writes the cache; one t=1 step then runs JAX's stacked decode
    path (the Pallas kernel in interpret mode) against the port's."""
    params, model = pair
    embeds, mask = _prefill_inputs()
    jcache = jllama.KVCache.create(JCFG.llama, 2, 16, jnp.float32)
    jh, jcache = jllama.apply_llama(params["llama"], JCFG.llama,
                                    inputs_embeds=jnp.asarray(embeds),
                                    attn_mask=jnp.asarray(mask), kv_cache=jcache)
    tcache = tllama.KVCache.create(CFG.llama, 2, 16, torch.float32, "cpu")
    th, tcache = tllama.apply_llama(model.llama, CFG.llama,
                                    inputs_embeds=torch.from_numpy(embeds),
                                    attn_mask=torch.from_numpy(mask), kv_cache=tcache)
    close(th, jh)
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)
    assert tcache.index == int(jcache.index) == 10

    step = rand((2, 1, CFG.llama.hidden_size), 8)
    jh, jcache = jllama.apply_llama(params["llama"], JCFG.llama,
                                    inputs_embeds=jnp.asarray(step),
                                    attn_mask=jnp.asarray(mask), kv_cache=jcache)
    th, tcache = tllama.apply_llama(model.llama, CFG.llama,
                                    inputs_embeds=torch.from_numpy(step),
                                    attn_mask=torch.from_numpy(mask), kv_cache=tcache)
    close(th, jh)
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)
    close(tllama.lm_logits(model.llama, CFG.llama, th),
          jllama.lm_logits(params["llama"], JCFG.llama, jh))


def test_splice_visual_tokens():
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 100, size=(2, 7))
    ids[0, 2] = IMAGE_TOKEN_INDEX  # row 1 has no image sentinel
    labels = np.where(rng.uniform(size=(2, 7)) < 0.5, IGNORE_INDEX, HAND_TOKEN_ID)
    text = rand((2, 7, 8), 10)
    vis = rand((2, 3, 8), 11)
    attn = np.ones((2, 7), bool)
    attn[1, 0] = False
    want = jhv.splice_visual_tokens(jnp.asarray(text), jnp.asarray(ids), jnp.asarray(vis),
                                    attn_mask=jnp.asarray(attn), labels=jnp.asarray(labels))
    got = thv.splice_visual_tokens(torch.from_numpy(text), torch.from_numpy(ids),
                                   torch.from_numpy(vis), attn_mask=torch.from_numpy(attn),
                                   labels=torch.from_numpy(labels))
    close(got.embeds, want.embeds, atol=0, rtol=0)
    for name in ("attn_mask", "labels", "hand_mask"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)))


@pytest.mark.parametrize("scale_by_count", [True, False])
def test_add_hand_coord_embeddings(scale_by_count):
    ids = np.full((2, 12), 7)
    ids[0, [3, 6, 9]] = HAND_TOKEN_ID  # fewer hand tokens than waypoints
    ids[1, [1, 2, 4, 5, 8]] = HAND_TOKEN_ID  # more
    text = rand((2, 12, 64), 12)
    hands = np.random.default_rng(12).uniform(size=(2, 2, 4, 2)).astype(np.float32)
    want = jhv.add_hand_coord_embeddings(jnp.asarray(text), jnp.asarray(ids),
                                         jnp.asarray(hands), scale_by_count=scale_by_count)
    got = thv.add_hand_coord_embeddings(torch.from_numpy(text), torch.from_numpy(ids),
                                        torch.from_numpy(hands), scale_by_count=scale_by_count)
    close(got, want)


def test_extract_hand_embeddings():
    labels = np.full((3, 12), IGNORE_INDEX)
    labels[0, [4, 7]] = HAND_TOKEN_ID
    labels[2, [2, 3, 5, 8, 10]] = HAND_TOKEN_ID  # row 1 has none
    hidden = rand((3, 12, 64), 13)
    valid = np.ones((3, 2), np.float32)
    want = jhv.extract_hand_embeddings(jnp.asarray(hidden), jnp.asarray(labels),
                                       jnp.asarray(valid))
    got = thv.extract_hand_embeddings(torch.from_numpy(hidden), torch.from_numpy(labels),
                                      torch.from_numpy(valid))
    close(got[0], want[0], atol=0, rtol=0)
    close(got[1], want[1], atol=0, rtol=0)


def test_embed_next_token(pair):
    params, model = pair
    token = np.array([HAND_TOKEN_ID, 5])
    wp = np.random.default_rng(14).uniform(size=(2, 2, 2)).astype(np.float32)
    want = jhv.embed_next_token(params, JCFG, jnp.asarray(token), jnp.asarray(wp))
    got = thv.embed_next_token(model, CFG, torch.from_numpy(token), torch.from_numpy(wp))
    close(got, want)


@pytest.mark.parametrize("temperature,top_p", [(0.5, 0.9), (1.0, 0.5), (0.7, 1.0)])
def test_warp_logits(temperature, top_p):
    logits = 3.0 * rand((4, 300), 15)
    want = np.asarray(jax_warp_logits(jnp.asarray(logits), temperature, top_p))
    got = _warp_logits(torch.from_numpy(logits), temperature, top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], **TOL)


def test_forward_golden(pair):
    """tests/test_regression_golden.py's values from the port's forward,
    with the CVAE noise JAX draws from PRNGKey(7) passed in."""
    params, model = pair
    rng = np.random.default_rng(1234)
    b, t = 2, 16
    ids = rng.integers(3, 1000, size=(b, t))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[:, [8, 10, 12, 14]] = HAND_TOKEN_ID
    labels = np.full((b, t), IGNORE_INDEX)
    labels[:, 7:] = ids[:, 7:]
    images = rng.normal(size=(b, CFG.num_frames, 3, 56, 56)).astype(np.float32)
    future_hands = rng.uniform(size=(b, 2, 5, 2)).astype(np.float32)
    eps = np.array(jax.random.normal(jax.random.PRNGKey(7), (b * 2 * 4, CFG.traj.latent_dim)))
    out = thv.forward(
        model, CFG, input_ids=torch.from_numpy(ids),
        attn_mask=torch.ones((b, t), dtype=torch.bool), images=torch.from_numpy(images),
        labels=torch.from_numpy(labels), future_hands=torch.from_numpy(future_hands),
        future_valid=torch.ones((b, 2)), eps=torch.from_numpy(eps))
    got = {
        "loss": float(out["loss"]),
        "text_loss": float(out["text_loss"]),
        "traj_loss": float(out["traj_loss"]),
        "traj_kl_loss": float(out["traj_kl_loss"]),
        "logits_mean": float(out["logits"].mean()),
    }
    golden = {
        "loss": 27.1411933899,
        "text_loss": 10.3793773651,
        "traj_loss": 16.6971263885,
        "traj_kl_loss": 0.0646902546,
        "logits_mean": -0.0001010363,
    }
    for k, want in golden.items():
        assert abs(got[k] - want) < max(abs(want) * 1e-4, 1e-6), (k, got[k], want)
