"""The port's EK100 eval CLI (handsonvlm_torch/eval/evaluate.py) end to end on
the CPU, on the JAX package's own on-disk fixture (tests/test_e2e_eval_cli.py:
annotation CSVs, label pkls, the feature LMDB, frame JPEGs, the reasoning
questions under HANDSONVLM_DATA_ROOT).

The checkpoint is that test's rigged tiny224 model (lm_head puts +u on
<hand_traj> and -u on every other id, so decodes emit hand tokens), carried
across as an HF directory by the JAX package's `save_hf_checkpoint`, which
the port's builder loads. Checked:

- vanilla and `--use-reason --num-samples 3`: both fixture clips scored
  (n == 2), ADE / FDE / WDE finite in (0, 10);
- `--int4 --kv-int8 --batched 2` and `--spec 2` at tiny224 score both
  clips too;
- the items the port's CLI hands to the evaluator equal the JAX CLI's, item
  by item (prompt, image, future_hands, future_valid, token ids), and so do
  the prompt ids the engines build from them (sampled scores are not
  compared: the frameworks draw differently);
- chip_smoke's stdlib fixture writer (phase 16) writes that fixture file for
  file.
"""

import json
import math
import os
import random
import sys

import numpy as np
import pytest

import jax

from handsonvlm_tpu.convert.jax_to_hf import save_hf_checkpoint
from handsonvlm_tpu.core.config import get_config as jax_get_config
from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JMockTokenizer
from handsonvlm_tpu.eval import evaluate as jax_evaluate
from handsonvlm_tpu.eval import evaluator as jax_evaluator
from handsonvlm_tpu.infer import builder as jax_builder
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm

import chip_smoke
from handsonvlm_torch.eval import evaluate
from test_e2e_eval_cli import _write_fixture


@pytest.fixture(scope="module")
def fixture_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("ek_fixture")
    _write_fixture(root)
    cfg = jax_get_config("tiny224")
    params = init_handsonvlm(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    d, v = params["llama"]["lm_head"]["weight"].shape
    u = np.ones((d,), np.float32) * 2.0
    w = np.tile(-u[:, None], (1, v))
    w[:, cfg.hand_token_id] = u
    params["llama"]["lm_head"]["weight"] = w
    ckpt = tmp_path_factory.mktemp("model") / "hf"
    save_hf_checkpoint(params, str(ckpt))
    return root, str(ckpt)


def _use_root(monkeypatch, root):
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(root))
    monkeypatch.setenv("HANDSONVLM_ASSETS_DIR", str(root / "assets"))


def _run(monkeypatch, root, ckpt, out_path, extra=()):
    _use_root(monkeypatch, root)
    res = evaluate.main(["--model-path", ckpt, "--preset", "tiny224", "--device", "cpu",
                         "--max-new-tokens", "24", "--out", str(out_path), *extra])
    with open(out_path) as f:
        summary = json.load(f)
    assert summary == {k: res[k] for k in ("ade", "fde", "wde", "n")} or (
        summary["n"] == res["n"] == 0)
    assert len(res["val_info"]) == 2
    return summary, res


def _assert_scored(summary):
    assert summary["n"] == 2  # both fixture validation clips scored
    for k in ("ade", "fde", "wde"):
        assert math.isfinite(summary[k]), summary
        assert 0.0 < summary[k] < 10.0, summary


def test_eval_cli_vanilla(fixture_env, tmp_path, monkeypatch):
    root, ckpt = fixture_env
    summary, res = _run(monkeypatch, root, ckpt, tmp_path / "vanilla.json")
    _assert_scored(summary)
    assert [v["num_tokens"] for v in res["val_info"].values()] == [24, 24]


def test_eval_cli_reasoning_multisample(fixture_env, tmp_path, monkeypatch):
    root, ckpt = fixture_env
    summary, res = _run(monkeypatch, root, ckpt, tmp_path / "reason.json",
                        ["--use-reason", "--num-samples", "3"])
    _assert_scored(summary)
    assert [v["num_tokens"] for v in res["val_info"].values()] == [72, 72]
    assert all("hand move" in v["prompt"] or "continue" in v["prompt"]
               for v in res["val_info"].values())


@pytest.mark.parametrize("extra", [["--int4", "--kv-int8", "--batched", "2"], ["--spec", "2"]],
                         ids=["int4_kv8_batched", "spec"])
def test_eval_cli_serving_modes(fixture_env, tmp_path, monkeypatch, extra):
    root, ckpt = fixture_env
    summary, _ = _run(monkeypatch, root, ckpt, tmp_path / "mode.json", extra)
    _assert_scored(summary)


def _recorder(store):
    """Stands in for the evaluator: records the items it would score, in
    the order the serial evaluator reads them."""
    def record(engine, dataset, seed=0, limit=None, **_):
        n = len(dataset) if limit is None else min(limit, len(dataset))
        store.extend((dataset[i], engine) for i in range(n))
        return {"ade": float("nan"), "fde": float("nan"), "wde": float("nan"), "n": 0,
                "val_info": {}}
    return record


@pytest.mark.parametrize("extra", [[], ["--use-reason"]], ids=["vanilla", "reasoning"])
@pytest.mark.parametrize("seed", [0, 3])
def test_eval_cli_items_equal_jax(fixture_env, tmp_path, monkeypatch, extra, seed):
    """The JAX CLI (its global `random` seeded with --seed, its model load
    stubbed: items do not depend on weights) and the port's CLI hand the
    evaluator the same items and build the same prompt ids from them."""
    root, ckpt = fixture_env
    _use_root(monkeypatch, root)
    want, got = [], []
    monkeypatch.setattr(jax_builder, "load_pretrained_model",
                        lambda path, preset, **_: (None, jax_get_config(preset),
                                                   JMockTokenizer()))
    monkeypatch.setattr(jax_evaluator, "evaluate_epic_kitchen_traj", _recorder(want))
    monkeypatch.setattr(sys, "argv", ["evaluate", "--model-path", "stub", "--preset", "tiny224",
                                      "--seed", str(seed), *extra])
    random.seed(seed)
    jax_evaluate.main()
    monkeypatch.setattr(evaluate, "evaluate_epic_kitchen_traj", _recorder(got))
    evaluate.main(["--model-path", ckpt, "--preset", "tiny224", "--device", "cpu",
                   "--seed", str(seed), *extra])
    assert len(got) == len(want) == 2
    for (g, g_engine), (w, w_engine) in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["prompt"] == w["prompt"] and g["narration"] == w["narration"]
        for k in ("image", "future_hands", "future_valid", "input_ids", "labels", "feat",
                  "bbox_feat", "valid_mask", "gt_hands" if "gt_hands" in w else "uid"):
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_array_equal(g_engine.build_prompt_ids(g["prompt"]),
                                      w_engine.build_prompt_ids(w["prompt"]))
        assert g["image"].shape == (100, 3, 224, 224)
    assert g_engine.kv_quant is None and g_engine.max_new_tokens == w_engine.max_new_tokens
    assert (g_engine.temperature, g_engine.top_p) == (w_engine.temperature, w_engine.top_p)


def test_cli_takes_every_jax_flag():
    """Every flag of the JAX CLI, plus --device (default cuda)."""
    args = evaluate.parse_args([
        "--model-path", "m", "--preset", "tiny", "--ek-version", "ek55", "--split", "train",
        "--use-reason", "--temperature", "0.7", "--top-p", "0.8", "--max-new-tokens", "9",
        "--limit", "3", "--kv-int8", "--num-samples", "2", "--seed", "4", "--int8", "--int4",
        "--out", "o.json", "--spec", "2", "--batched", "5", "--batched-max-len", "512",
        "--batched-chunk", "8"])
    assert (args.ek_version, args.split, args.use_reason, args.temperature, args.top_p,
            args.max_new_tokens, args.limit, args.kv_int8, args.num_samples, args.seed,
            args.int8, args.int4, args.out, args.spec, args.batched, args.batched_max_len,
            args.batched_chunk) == ("ek55", "train", True, 0.7, 0.8, 9, 3, True, 2, 4, True,
                                    True, "o.json", 2, 5, 512, 8)
    assert evaluate.parse_args(["--model-path", "m"]).device == "cuda"


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_stdlib_fixture_writer_writes_the_jax_tests_fixture(tmp_path):
    """chip_smoke's writer (csv module, no pandas) at 2 validation clips
    writes the JAX test's tree, file for file and byte for byte."""
    _write_fixture(tmp_path / "jax")
    written = chip_smoke.write_ek_fixture(str(tmp_path / "port"), n_val=2)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    # 3 CSVs, video_info.json, 2 label pkls, the LMDB, the questions and 28
    # frames (30 written; the train clip's last two are the first clip's first)
    assert sorted(got) == sorted(want) and len(got) == 36
    for name in want:
        assert got[name] == want[name], name
    assert written["frames"] == 30
