"""The port's chat slice against the JAX package's, at the tiny preset.

JAX weights are carried over through `from_jax_params`. Greedy decode must
give the same first 8 tokens (later tokens may drift: reassociation
differences grow through the KV cache); with a forced <hand_traj> and the
CVAE latents JAX draws
injected step by step, the decoded waypoints must agree. The chat CLI runs
end to end on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from handsonvlm_tpu.constants import IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer.sampler import generate_host as jax_generate_host
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer import chat
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.infer.sampler import clip_pred_hands, generate_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jax_tiny_config()
CFG = tiny_config()


def _port(params):
    model = build_model(CFG, "cpu")
    load_state_dict_into(model, from_jax_params(params))
    return model


@pytest.fixture(scope="module")
def params():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(42))


def _prompt():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(1, 12))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    frames = rng.normal(size=(1, 4, 3, 56, 56)).astype(np.float32)  # unique frames
    frame_map = np.tile(np.arange(4, dtype=np.int32), CFG.num_frames // 4)
    return ids, frames, frame_map


def test_greedy_prefix_matches_jax(params):
    ids, frames, frame_map = _prompt()
    want = jax_generate_host(params, JCFG, ids, frames, jax.random.PRNGKey(7),
                             max_new_tokens=12, temperature=0.0,
                             frame_map=frame_map)
    got = generate_host(_port(params), CFG, ids, frames, None, max_new_tokens=12,
                        temperature=0.0, frame_map=frame_map)
    np.testing.assert_array_equal(got.sequences[0, :8], np.asarray(want.sequences)[0, :8])


def _jax_step_latents(key, steps, n):
    """The CVAE latents JAX's generate_host draws at each step."""
    zs = []
    key, sub = jax.random.split(key)
    for step in range(steps):
        if step:
            key, sub = jax.random.split(key)
        _, r_hand = jax.random.split(sub)
        zs.append(np.array(JCFG.traj.z_scale
                           * jax.random.normal(r_hand, (n, JCFG.traj.latent_dim))))
    return zs


def test_forced_hand_waypoints_match_jax(params):
    """Head rigged so <hand_traj> wins whenever u.h > 0 (token 0 otherwise):
    hand tokens enter the cache through embed_next_token and each decodes a
    waypoint from its injected latent."""
    rigged = dict(params)
    d, v = params["llama"]["lm_head"]["weight"].shape
    w = np.zeros((d, v), np.float32)
    w[:, JCFG.hand_token_id] = -2.0  # u; this seed gives u.h > 0 every other step
    rigged["llama"] = dict(params["llama"], lm_head={"weight": jnp.asarray(w)})
    ids, frames, frame_map = _prompt()
    key, steps = jax.random.PRNGKey(11), 8
    want = jax_generate_host(rigged, JCFG, ids, frames, key, max_new_tokens=steps,
                             temperature=0.0, frame_map=frame_map)
    got = generate_host(_port(rigged), CFG, ids, frames, None, max_new_tokens=steps,
                        temperature=0.0, frame_map=frame_map,
                        z_steps=_jax_step_latents(key, steps, n=2))
    assert int(np.asarray(want.num_hands)[0]) > 0
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_hands, np.asarray(want.num_hands))
    np.testing.assert_allclose(got.pred_hands, np.asarray(want.pred_hands), atol=1e-5)
    pred, valid = clip_pred_hands(got.pred_hands, got.num_hands)
    assert valid[0] and pred.shape == (1, 2, 4, 2)


def test_chat_cli_end_to_end(tmp_path):
    from PIL import Image

    img = tmp_path / "k.jpg"
    Image.fromarray((np.random.default_rng(0).uniform(size=(64, 96, 3)) * 255)
                    .astype("uint8")).save(img)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "handsonvlm_torch.infer.chat", "--model-path", "random:tiny",
         "--preset", "tiny", "--device", "cpu", "--path", str(img),
         "--max-new-tokens", "8", "--output-video", str(tmp_path / "traj.mp4")],
        input="reach for the cup\n\n", capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ASSISTANT:" in proc.stdout and "exit..." in proc.stdout


@pytest.mark.parametrize("flag", ["--int8", "--int4", "--kv-int8", "--spec=2"])
def test_chat_flags_not_ported_raise(monkeypatch, flag):
    monkeypatch.setattr(sys, "argv", ["chat", "--model-path", "random:tiny", "--preset",
                                      "tiny", "--device", "cpu", "--path", "x.jpg", flag])
    with pytest.raises(NotImplementedError, match="ROADMAP A[67]"):
        chat.main()
