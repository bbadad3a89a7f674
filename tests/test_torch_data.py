"""The port's own copies of the JAX package's framework-free modules give
what the originals give: the same ids, prompt text, pixels and overlays
from the same inputs (the port may not import the JAX package)."""

import numpy as np
import pytest

from handsonvlm_tpu import constants as jconst
from handsonvlm_tpu.data import conversation as jconv
from handsonvlm_tpu.data import mock_tokenizer as jmock
from handsonvlm_tpu.data import tokenization as jtok
from handsonvlm_tpu.data import video_io as jvideo
from handsonvlm_tpu.infer import viz as jviz
from handsonvlm_torch import constants as tconst
from handsonvlm_torch.data import conversation as tconv
from handsonvlm_torch.data import mock_tokenizer as tmock
from handsonvlm_torch.data import tokenization as ttok
from handsonvlm_torch.data import video_io as tvideo
from handsonvlm_torch.infer import viz as tviz

TURNS = [
    ("What is the person doing in this video?", "Cutting a tomato <hand_traj>."),
    ("Where will the right hand move next? <hand_traj> <hand_traj>", None),
]


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for name in names:
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.mark.parametrize("template", ["v1", "v0", "plain", "llama_2"])
def test_conversation_prompts_match(template):
    prompts = []
    for mod in (jconv, tconv):
        conv = mod.conv_templates[template].copy()
        for i, (user, bot) in enumerate(TURNS):
            conv.append_message(conv.roles[0], ("<image>\n" if i == 0 else "") + user)
            conv.append_message(conv.roles[1], bot)
        prompts.append(conv.get_prompt())
    assert prompts[0] == prompts[1]
    assert "<image>" in prompts[1]


@pytest.mark.parametrize("text", [
    "USER: <image>\nreach for the cup ASSISTANT:",
    "<image> twice <image> and <hand_traj> tokens </s>",
    "no image token at all",
])
def test_mock_tokenizer_and_image_tokens_match(text):
    jt, tt = jmock.MockTokenizer(2048), tmock.MockTokenizer(2048)
    assert tt.encode(text) == jt.encode(text)
    ids = tt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    assert len(tt) == len(jt)
    got = ttok.tokenizer_image_token(text, tt)
    assert got == jtok.tokenizer_image_token(text, jt)
    assert got.count(tconst.IMAGE_TOKEN_INDEX) == text.count("<image>")


def test_v1_chat_prompt_ids_match():
    """The chat CLI's prompt: the v1 conversation through tokenizer_image_token."""
    jt, tt = jmock.MockTokenizer(2048), tmock.MockTokenizer(2048)
    prompts = []
    for mod in (jconv, tconv):
        conv = mod.conv_templates["v1"].copy()
        conv.append_message(conv.roles[0], "<image>\nWhat happens next?")
        conv.append_message(conv.roles[1], None)
        prompts.append(conv.get_prompt())
    assert prompts[0] == prompts[1]
    assert ttok.tokenizer_image_token(prompts[1], tt) == \
        jtok.tokenizer_image_token(prompts[0], jt)


def test_image_loading_matches(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    path = tmp_path / "frame.jpg"
    Image.fromarray((rng.uniform(size=(60, 90, 3)) * 255).astype("uint8")).save(path)
    for aspect in ("square", "pad"):
        got = tvideo.load_image(str(path), aspect, cache_dir=None, size=56)
        want = jvideo.load_image(str(path), aspect, cache_dir=None, size=56)
        assert got.shape == (3, 56, 56)
        np.testing.assert_array_equal(got, want)


def test_trajectory_overlay_matches():
    rng = np.random.default_rng(1)
    frame = (rng.uniform(size=(48, 64, 3)) * 255).astype("uint8")
    hands = rng.uniform(size=(2, 4, 2)).astype(np.float32)
    got = tviz.vis_traj(frame.copy(), hands)
    np.testing.assert_array_equal(got, jviz.vis_traj(frame.copy(), hands))
    assert not np.array_equal(got, frame)
