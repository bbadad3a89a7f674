"""The port's chat slices against the JAX package's, at the tiny preset.

JAX weights are carried over through `from_jax_params`. Greedy decode must
give the same first 8 tokens (later tokens may drift: reassociation
differences grow through the KV cache); with a forced <hand_traj> and the
CVAE latents JAX draws
injected step by step, the decoded waypoints must agree. The chat CLI runs
end to end on the CPU.

The quantized slice (int4 weights, int8 head, int8 KV cache) runs the same
checks: the port's int4 model holds the bytes of JAX's `init_llama_int4`
tree, and JAX decodes over its int8 cache with those weights exactly
dequantized (the tiny prompts stay under 128 rows, so every projection of
the port takes the exact int4 GEMV).
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
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.infer.sampler import generate_host as jax_generate_host
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_torch.config import get_config, tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer import chat
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.infer.sampler import clip_pred_hands, generate_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jax_tiny_config()
CFG = tiny_config()


def _port(params, quantize=None):
    model = build_model(get_config("tiny") if quantize else CFG, "cpu", quantize=quantize)
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


@pytest.fixture(scope="module")
def int4_params():
    """JAX int4 params (`init_llama_int4` through the JAX builder) and the
    same tree with the projections exactly dequantized (int8 head kept)."""
    from test_torch_quant import dense_from_int4

    params, jcfg, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize="int4")
    dense = dict(params, llama=dense_from_int4(params["llama"], jcfg.llama))
    return params, dense, jcfg


def test_int4_kv8_greedy_prefix_matches_jax(int4_params):
    params, dense, jcfg = int4_params
    ids, frames, frame_map = _prompt()
    want = jax_generate_host(dense, jcfg, ids, frames, jax.random.PRNGKey(7),
                             max_new_tokens=12, temperature=0.0, frame_map=frame_map,
                             kv_quant="int8")
    got = generate_host(_port(params, "int4"), get_config("tiny"), ids, frames, None,
                        max_new_tokens=12, temperature=0.0, frame_map=frame_map,
                        kv_quant="int8")
    np.testing.assert_array_equal(got.sequences[0, :8], np.asarray(want.sequences)[0, :8])


def test_int4_kv8_forced_hand_waypoints_match_jax(int4_params):
    """As test_forced_hand_waypoints_match_jax, over the int8 cache with
    int4 weights: the int8 head is rigged so <hand_traj> wins whenever
    u.h > 0 (its column dequantizes to +2.0 on the first half of the
    features and -2.0 on the second, every other column to 0; this seed
    gives token 0 first, then hand tokens)."""
    params, dense, jcfg = int4_params
    d = jcfg.llama.hidden_size
    v = params["llama"]["lm_head"]["w8"].shape[1]
    w8 = np.zeros((d, v), np.int8)
    w8[:, jcfg.hand_token_id] = np.where(np.arange(d) < d // 2, 127, -127)
    scale = np.ones((v,), np.float32)
    scale[jcfg.hand_token_id] = 2.0 / 127.0
    head = {"w8": jnp.asarray(w8), "scale": jnp.asarray(scale)}
    rig = {name: dict(tree, llama=dict(tree["llama"], lm_head=head))
           for name, tree in (("int4", params), ("dense", dense))}
    ids, frames, frame_map = _prompt()
    key, steps = jax.random.PRNGKey(11), 8
    want = jax_generate_host(rig["dense"], jcfg, ids, frames, key, max_new_tokens=steps,
                             temperature=0.0, frame_map=frame_map, kv_quant="int8")
    got = generate_host(_port(rig["int4"], "int4"), get_config("tiny"), ids, frames, None,
                        max_new_tokens=steps, temperature=0.0, frame_map=frame_map,
                        z_steps=_jax_step_latents(key, steps, n=2), kv_quant="int8")
    assert int(np.asarray(want.num_hands)[0]) > 0
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_hands, np.asarray(want.num_hands))
    np.testing.assert_allclose(got.pred_hands, np.asarray(want.pred_hands), atol=1e-5)


def _run_chat_cli(tmp_path, *flags):
    from PIL import Image

    img = tmp_path / "k.jpg"
    Image.fromarray((np.random.default_rng(0).uniform(size=(64, 96, 3)) * 255)
                    .astype("uint8")).save(img)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "handsonvlm_torch.infer.chat", "--model-path", "random:tiny",
         "--preset", "tiny", "--device", "cpu", "--path", str(img),
         "--max-new-tokens", "8", "--output-video", str(tmp_path / "traj.mp4"), *flags],
        input="reach for the cup\n\n", capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ASSISTANT:" in proc.stdout and "exit..." in proc.stdout
    return proc.stdout


def test_chat_cli_end_to_end(tmp_path):
    _run_chat_cli(tmp_path)


def test_chat_cli_int4_kv8_end_to_end(tmp_path):
    _run_chat_cli(tmp_path, "--int4", "--kv-int8")


@pytest.mark.parametrize("flags", [("--spec", "2"), ("--spec", "3", "--int4", "--kv-int8")],
                         ids=["spec", "spec_int4_kv8"])
def test_chat_cli_spec_end_to_end(tmp_path, flags):
    out = _run_chat_cli(tmp_path, *flags)
    assert " tok / " in out and " fwd]" in out  # the speculative reply's yield


@pytest.mark.parametrize("flags", [("--int8",), ("--int8", "--kv-int8"),
                                   ("--int8", "--kv-int8", "--spec", "3")],
                         ids=["int8", "int8_kv8", "int8_kv8_spec"])
def test_chat_cli_int8_end_to_end(tmp_path, flags):
    out = _run_chat_cli(tmp_path, *flags)
    assert ("--spec" in flags) == (" fwd]" in out)


def test_chat_cli_int8_builds_the_int8_decoder(monkeypatch):
    """--int8 loads the int8 decoder (and wins over --int4, as in the JAX
    package's CLI)."""
    seen = {}

    def load(path, preset, device, quantize=None):
        seen["quantize"] = quantize
        raise SystemExit(0)

    monkeypatch.setattr(chat, "load_pretrained_model", load)
    monkeypatch.setattr(sys, "argv", ["chat", "--model-path", "random:tiny", "--preset",
                                      "tiny", "--device", "cpu", "--path", "x.jpg", "--int8",
                                      "--int4"])
    with pytest.raises(SystemExit):
        chat.main()
    assert seen["quantize"] == "int8"
