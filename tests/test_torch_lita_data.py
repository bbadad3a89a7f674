"""The port's LITA task datasets (handsonvlm_torch/data/lita_datasets.py) and
RTL evaluation (eval/rtl.py, eval/rtl_cli.py) on the CPU, held against the
JAX package's modules.

- Ports of tests/test_lita_datasets.py and test_rtl_and_preprocess.py, run
  against the port.
- Side by side: the same JSON fixtures and seeds (the JAX side's global
  `random` seeded as the port's `random.Random`) give the same sources,
  prompts, token ids and frames; the RTL parsers and scores equal the
  JAX ones on random inputs.
- The RTL CLI end to end at tiny224 on a frame directory.
"""

import functools
import json
import random

import numpy as np
import pytest
from PIL import Image

from handsonvlm_tpu.data import lita_datasets as jl
from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JMockTokenizer
from handsonvlm_tpu.eval import rtl as jrtl

from handsonvlm_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from handsonvlm_torch.data import lita_datasets as tl
from handsonvlm_torch.data.conversation import conv_templates
from handsonvlm_torch.data.lita_datasets import (
    DVCDataset_activitynet,
    EventLocDataset_activitynet,
    LlavaPretrainDataset,
    TemporalReasoningDataset_activitynet,
    VidQADataset_msvdqa,
    convert_timestamps_to_time_tokens,
    timestamp_to_time_token,
)
from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
from handsonvlm_torch.data.tokenization import preprocess, preprocess_llama_2, preprocess_plain
from handsonvlm_torch.eval import rtl_cli
from handsonvlm_torch.eval.rtl import (
    decode_time_tokens,
    iou,
    parse_start_end_timestamps,
    score_rtl,
    time_token_to_seconds,
)

# ---------------------------------------------------------------------------
# ports of tests/test_lita_datasets.py
# ---------------------------------------------------------------------------


def test_timestamp_quantization():
    assert timestamp_to_time_token(0.0, 100.0) == "<t0>"
    assert timestamp_to_time_token(100.0, 100.0) == "<t99>"
    assert timestamp_to_time_token(50.0, 100.0) == "<t50>"  # round(99*0.5)=50


def test_timestamp_regex_conversion():
    s = "It happens between <12.5> and <20> in the video <0.>"
    out = convert_timestamps_to_time_tokens(s, duration=100.0)
    assert out == "It happens between <t12> and <t20> in the video <t0>"


def _write_anet(root, n_videos=1):
    """ActivityNet captions with frame directories and the temporal
    reasoning QA file (tests/test_lita_datasets.py's fixture, `n_videos`
    videos)."""
    train, tr = {}, {}
    for v in range(n_videos):
        vid = f"v_{v + 1:03d}"
        frames_dir = root / "activitynet-captions" / "activitynet_frames" / vid
        frames_dir.mkdir(parents=True)
        for i in range(4):
            Image.new("RGB", (64, 48), (i * 10, v * 40, 0)).save(frames_dir / f"f{i:04d}.jpg")
        train[vid] = {"duration": 60.0 + v, "timestamps": [[0.0, 10.0], [30.0, 60.0]],
                      "sentences": ["A person opens a fridge.", "They cook a meal."]}
        tr[vid] = {"duration": 60.0 + v, "QA": [
            {"q": "When does cooking happen?", "a": "Between <30> and <60.> they cook."},
            {"q": "And the fridge?", "a": "From <0> to <10.5>."}]}
    (root / "activitynet-captions" / "train.json").write_text(json.dumps(train))
    (root / "temporal_reasoning").mkdir()
    (root / "temporal_reasoning" / "activitynet_train_gpt-4-0613_temp_6_f10009.json"
     ).write_text(json.dumps(tr))


@pytest.fixture
def anet_fixture(tmp_path):
    frames_dir = tmp_path / "activitynet-captions" / "activitynet_frames" / "v_001"
    frames_dir.mkdir(parents=True)
    for i in range(4):
        Image.new("RGB", (64, 48), (i * 10, 0, 0)).save(frames_dir / f"f{i:04d}.jpg")
    train = {
        "v_001": {
            "duration": 60.0,
            "timestamps": [[0.0, 10.0], [30.0, 60.0]],
            "sentences": ["A person opens a fridge.", "They cook a meal."],
        }
    }
    (tmp_path / "activitynet-captions" / "train.json").write_text(json.dumps(train))
    tr_dir = tmp_path / "temporal_reasoning"
    tr_dir.mkdir()
    tr = {
        "v_001": {
            "duration": 60.0,
            "QA": [{"q": "When does cooking happen?", "a": "Between <30> and <60.> they cook."}],
        }
    }
    (tr_dir / "activitynet_train_gpt-4-0613_temp_6_f10009.json").write_text(json.dumps(tr))
    return str(tmp_path)


def test_dvc_dataset(anet_fixture):
    ds = DVCDataset_activitynet(anet_fixture, MockTokenizer(), load_images=True)
    assert len(ds) == 1
    item = ds[0]
    ids = np.asarray(item["input_ids"])
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    # answer contains quantized time tokens: 0s->t0, 10s->round(99/6)=17 etc.
    assert 32000 in ids  # <t0>
    assert item["image"].shape[0] == ds.num_frames


def test_event_loc_dataset(anet_fixture):
    ds = EventLocDataset_activitynet(anet_fixture, MockTokenizer(), load_images=False)
    item = ds[0]
    labels = np.asarray(item["labels"])
    sup = labels[labels != -100]
    # answer is exactly two time tokens (+ eos)
    time_toks = [t for t in sup if 32000 <= t <= 32099]
    assert len(time_toks) == 2


def test_temporal_reasoning_dataset(anet_fixture):
    ds = TemporalReasoningDataset_activitynet(anet_fixture, MockTokenizer(), load_images=False)
    assert len(ds) == 1
    item = ds[0]
    ids = list(np.asarray(item["input_ids"]))
    # <30> of 60s -> t = round(99*0.5) = 50 -> token 32050
    assert 32050 in ids
    assert 32099 in ids  # <60.> -> t99


def _write_vidqa(root):
    d = root / "msvdqa"
    d.mkdir()
    (d / "train_qa.json").write_text(json.dumps([
        {"video": "vid1.avi", "QA": [{"q": "what is shown", "a": "a cat"}]},
        {"video": "vid2.avi", "QA": [{"q": "who is there?", "a": "a man"},
                                     {"q": "is it raining", "a": "no"}]}]))
    (d / "YouTubeClips").mkdir()


def test_vidqa_dataset(tmp_path):
    _write_vidqa(tmp_path)
    ds = VidQADataset_msvdqa(str(tmp_path), MockTokenizer(), load_images=False)
    item = ds[0]
    ids = np.asarray(item["input_ids"])
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    labels = np.asarray(item["labels"])
    assert (labels != -100).sum() > 0


def _write_pretrain(root, n=1, images=False):
    d = root / "LLaVA-Pretrain"
    (d / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(n):
        if images:
            Image.fromarray(rng.uniform(0, 255, size=(240, 320, 3)).astype(np.uint8)).save(
                d / "images" / f"img{i}.jpg")
        records.append({"image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"a kitchen with a fridge number {i}"}]})
    (d / "blip_laion_cc_sbu_558k.json").write_text(json.dumps(records))


def test_llava_pretrain_dataset(tmp_path):
    _write_pretrain(tmp_path)
    ds = LlavaPretrainDataset(str(tmp_path), MockTokenizer(), load_images=False)
    item = ds[0]
    ids = np.asarray(item["input_ids"])
    labels = np.asarray(item["labels"])
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    img_pos = int(np.where(ids == IMAGE_TOKEN_INDEX)[0][0])
    assert (labels[: img_pos + 1] == -100).all()
    assert (labels[img_pos + 1:] != -100).any()


# ---------------------------------------------------------------------------
# side by side with the JAX datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t, duration", [(0.0, 100.0), (33.3, 100.0), (59.99, 60.0),
                                         (7.0, 13.0), (120.0, 120.0)])
def test_time_tokens_equal_jax(t, duration):
    assert timestamp_to_time_token(t, duration) == jl.timestamp_to_time_token(t, duration)
    s = f"from <{t}> to <{duration:.0f}.> and <.5> but not <a>"
    assert (convert_timestamps_to_time_tokens(s, duration)
            == jl.convert_timestamps_to_time_tokens(s, duration))


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("name", ["dvc", "temporal_reasoning"])
@pytest.mark.parametrize("seed", [0, 5])
def test_video_task_sources_and_items_equal_jax(tmp_path, name, seed):
    """Every video's sources, and items (frames loaded) from datasets of one
    video, equal the JAX package's under the same prompt draws."""
    _write_anet(tmp_path, n_videos=3)
    jcls = {"dvc": jl.DVCDataset_activitynet,
            "temporal_reasoning": jl.TemporalReasoningDataset_activitynet}[name]
    tcls = {"dvc": DVCDataset_activitynet,
            "temporal_reasoning": TemporalReasoningDataset_activitynet}[name]
    random.seed(seed)
    jds = jcls(str(tmp_path), JMockTokenizer(), load_images=True)
    want = [jds.get_sources(i) for i in range(len(jds))]
    tds = tcls(str(tmp_path), MockTokenizer(), load_images=True, rng=random.Random(seed))
    got = [tds.get_sources(i) for i in range(len(tds))]
    assert got == want and len(got) == (3 if name == "dvc" else 6)
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.get_visual(got[i]), jds.get_visual(want[i]))
    # items: one entry each, so the index draw is 0 on both sides
    jds.list_data_dict = jds.list_data_dict[:1]
    tds.list_data_dict = tds.list_data_dict[:1]
    random.seed(seed + 1)
    want_item = jds[0]
    tds.rng = random.Random(seed + 1)
    _assert_items_equal(tds[0], want_item)


class _Pick:
    """Stands in for the JAX dataset's unseeded RandomState: picks segment k."""

    def __init__(self, k):
        self.k = k

    def choice(self, n):
        return self.k


def test_event_loc_prompts_equal_jax(tmp_path, monkeypatch):
    """The prompt draws and the segment's time tokens equal the JAX ones;
    the segment index comes from each side's numpy generator, so the
    port's sources are checked against the JAX sources for each segment."""
    _write_anet(tmp_path, n_videos=2)
    jds = jl.EventLocDataset_activitynet(str(tmp_path), JMockTokenizer(), load_images=False)
    for seed in range(4):
        tds = EventLocDataset_activitynet(str(tmp_path), MockTokenizer(), load_images=False,
                                          rng=random.Random(seed),
                                          np_rng=np.random.default_rng(seed))
        got = tds.get_sources(seed % 2)
        wants = []
        for k in range(2):
            random.seed(seed)
            monkeypatch.setattr(np.random, "RandomState", lambda k=k: _Pick(k))
            wants.append(jds.get_sources(seed % 2))
            monkeypatch.undo()
        assert got in wants


def test_vidqa_and_pretrain_items_equal_jax(tmp_path, monkeypatch):
    # the JAX loader caches decoded images in /dev/shm by default; not here
    monkeypatch.setattr(jl, "load_image", functools.partial(jl.load_image, cache_dir=None))
    _write_vidqa(tmp_path)
    _write_pretrain(tmp_path, n=1, images=True)
    for tcls, jcls, images in ((VidQADataset_msvdqa, jl.VidQADataset_msvdqa, False),
                               (LlavaPretrainDataset, jl.LlavaPretrainDataset, True)):
        tds = tcls(str(tmp_path), MockTokenizer(), load_images=images)
        jds = jcls(str(tmp_path), JMockTokenizer(), load_images=images)
        assert [tds.get_sources(i) for i in range(len(tds))] == [
            jds.get_sources(i) for i in range(len(jds))]
        tds.list_data_dict = tds.list_data_dict[:1]
        jds.list_data_dict = jds.list_data_dict[:1]
        _assert_items_equal(tds[0], jds[0])


def test_registry_matches_jax():
    assert {t: sorted(d) for t, d in tl.LITA_DATASET_REGISTRY.items()} == {
        t: sorted(d) for t, d in jl.LITA_DATASET_REGISTRY.items()}
    for task, group in tl.LITA_DATASET_REGISTRY.items():
        for name, cls in group.items():
            assert cls.__name__ == jl.LITA_DATASET_REGISTRY[task][name].__name__


# ---------------------------------------------------------------------------
# ports of tests/test_rtl_and_preprocess.py
# ---------------------------------------------------------------------------


def test_parse_timestamps():
    text, seg = parse_start_end_timestamps(
        "The event happens <12.5> to <30.0> in the clip.", duration=60.0
    )
    assert seg == [12.5, 30.0]
    assert "<12.5>" not in text
    # clamping + ordering
    _, seg2 = parse_start_end_timestamps("<999> then <5.>", duration=50.0)
    assert seg2 == [5.0, 50.0]
    # fewer than two -> whole video
    _, seg3 = parse_start_end_timestamps("no timestamps here", duration=42.0)
    assert seg3 == [0.0, 42.0]


def test_iou_and_scores():
    assert iou([0, 10], [5, 15]) == pytest.approx(5 / 15)
    assert iou([0, 1], [2, 3]) == 0.0
    scores = score_rtl([{"pred": [0, 10], "gt": [0, 10]}, {"pred": [0, 1], "gt": [5, 6]}])
    assert scores["iou"] == pytest.approx(0.5)
    assert scores["precision@0.5"] == pytest.approx(0.5)


def test_decode_time_tokens_roundtrip():
    time_ids = list(range(32000, 32100))
    # dataset quantization: t=50s of 100s -> index round(99*0.5)=50
    rest, secs = decode_time_tokens([5, 32050, 7], duration=100.0, time_token_ids=time_ids)
    assert rest == [5, 7]
    assert secs[0] == pytest.approx(time_token_to_seconds(50, 100.0))
    assert abs(secs[0] - 50.0) < 1.0


def test_preprocess_plain():
    tok = MockTokenizer()
    sources = [[
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": "a photo of a kitchen"},
    ]]
    out = preprocess_plain(sources, tok)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    img_pos = int(np.where(ids == IMAGE_TOKEN_INDEX)[0][0])
    assert (labels[: img_pos + 1] == IGNORE_INDEX).all()
    assert (labels[img_pos + 1:] != IGNORE_INDEX).any()


def test_preprocess_llama_2_masks():
    tok = MockTokenizer()
    sources = [[
        {"from": "human", "value": "<image>\nwhat is in the video?"},
        {"from": "gpt", "value": "a hand opening a fridge"},
    ]]
    out = preprocess_llama_2(sources, tok, has_image=True)
    ids, labels = out["input_ids"][0], out["labels"][0]
    assert (ids == IMAGE_TOKEN_INDEX).sum() == 1
    sup = labels != IGNORE_INDEX
    assert sup.any()
    np.testing.assert_array_equal(ids[sup], labels[sup])


def test_preprocess_dispatch():
    tok = MockTokenizer()
    sources = [[
        {"from": "human", "value": "<image>\nquestion?"},
        {"from": "gpt", "value": "answer."},
    ]]
    v1 = preprocess(sources, tok, has_image=True)
    l2 = preprocess(sources, tok, has_image=True, conv=conv_templates["llama_2"])
    assert v1["input_ids"].shape != l2["input_ids"].shape or not np.array_equal(
        v1["input_ids"], l2["input_ids"]
    )


# ---------------------------------------------------------------------------
# RTL side by side, and the CLI
# ---------------------------------------------------------------------------


def test_rtl_parsers_and_scores_equal_jax():
    rng = np.random.default_rng(0)
    time_ids = list(range(32000, 32100))
    preds = []
    for _ in range(50):
        duration = float(rng.uniform(5, 300))
        ids = [int(x) for x in rng.integers(31990, 32110, size=12)]
        assert decode_time_tokens(ids, duration, time_ids) == jrtl.decode_time_tokens(
            ids, duration, time_ids)
        stamps = " ".join(f"<{x:.{int(rng.integers(0, 3))}f}>"
                          for x in rng.uniform(-10, duration * 1.2, int(rng.integers(0, 4))))
        text = f"the action {stamps} ends."
        assert parse_start_end_timestamps(text, duration) == jrtl.parse_start_end_timestamps(
            text, duration)
        seg = sorted(rng.uniform(0, duration, 2).tolist())
        preds.append({"pred": parse_start_end_timestamps(text, duration)[1], "gt": seg,
                      "task": ["a", "b"][int(rng.integers(0, 2))]})
    assert score_rtl(preds) == jrtl.score_rtl(preds)


def test_rtl_cli_runs_at_tiny224(tmp_path):
    """The RTL CLI on a question file and a frame directory at tiny224 on
    the CPU: one prediction a question, scores in [0, 1]."""
    for vid in ("v_a", "v_b"):
        d = tmp_path / "frames" / vid
        d.mkdir(parents=True)
        for i in range(6):
            Image.new("RGB", (96, 72), (i * 30, 20, 200 - i * 20)).save(d / f"{i:05d}.jpg")
    questions = [{"id": "v_a", "question": "When is the cup taken?", "duration": 30.0,
                  "timestamps": [3.0, 9.0]},
                 {"video": "v_b", "question": "When does it end?", "duration": 12.0,
                  "timestamps": [1.0, 12.0]}]
    qfile = tmp_path / "q.json"
    qfile.write_text(json.dumps(questions))
    out = tmp_path / "rtl.json"
    res = rtl_cli.main(["--model-path", "random:tiny224", "--preset", "tiny224", "--device",
                        "cpu", "--question-file", str(qfile), "--video-frames-root",
                        str(tmp_path / "frames"), "--max-new-tokens", "6",
                        "--out", str(out)])
    assert [p["id"] for p in res["predictions"]] == ["v_a", "v_b"]
    for p, q in zip(res["predictions"], questions):
        assert 0.0 <= p["pred"][0] <= p["pred"][1] <= q["duration"]
    assert 0.0 <= res["scores"]["iou"] <= 1.0
    assert json.loads(out.read_text())["scores"] == res["scores"]
