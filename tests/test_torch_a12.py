"""The port's small tools against the JAX package's: weight deltas
(convert/delta.py), the HF export (convert/to_hf.py, the counterpart of
convert/jax_to_hf.py), the GPT review (eval/gpt_review.py, with an injected
judge), the profiler trace (utils/profiling.py), and the
meters and logger (utils/meters.py, utils/logging.py).

Tolerances: the HF export and its round trip exactly (a rename of f32
tensors); a delta applied back within 1e-6 of the target (f32 t - b + b),
and equal to JAX's `make_delta` on the same arrays to 0 ulp in f32.
"""

import json
import logging as pylogging

import numpy as np
import pytest
import jax
import torch

from handsonvlm_tpu.convert import delta as jdelta
from handsonvlm_tpu.convert.jax_to_hf import export_handsonvlm as jax_export_handsonvlm
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.eval import gpt_review as jreview
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.utils import meters as jmeters
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert import delta
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.convert.to_hf import export_handsonvlm, export_llama, save_hf_checkpoint
from handsonvlm_torch.core.checkpoint import restore_params, save_params
from handsonvlm_torch.eval import gpt_review
from handsonvlm_torch.infer.builder import build_model, load_pretrained_model
from handsonvlm_torch.utils import logging as tlogging
from handsonvlm_torch.utils import meters, profiling


def _trees(seed=0):
    """A base (vocab 32000) and a target (vocab 32101, a projector the base
    lacks), as flat state dicts."""
    rng = np.random.default_rng(seed)
    base = {"llama.embed_tokens.weight": rng.normal(size=(32000, 8)).astype(np.float32),
            "llama.norm.weight": rng.normal(size=(8,)).astype(np.float32),
            "llama.lm_head.weight": rng.normal(size=(32000, 8)).astype(np.float32)}
    target = {"llama.embed_tokens.weight": rng.normal(size=(32101, 8)).astype(np.float32),
              "llama.norm.weight": rng.normal(size=(8,)).astype(np.float32),
              "llama.lm_head.weight": rng.normal(size=(32101, 8)).astype(np.float32),
              "projector.weight": rng.normal(size=(8, 4)).astype(np.float32)}
    return base, target


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_delta_roundtrip_with_resized_vocab_and_passthrough():
    base, target = _trees()
    d = delta.make_delta(_torch(target), _torch(base))
    want = jdelta.make_delta(target, base)
    for k in target:
        np.testing.assert_array_equal(d[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the added vocab rows and the projector ride along at full value
    assert torch.equal(d["llama.embed_tokens.weight"][32000:],
                       torch.from_numpy(target["llama.embed_tokens.weight"][32000:]))
    assert torch.equal(d["projector.weight"], torch.from_numpy(target["projector.weight"]))
    back = delta.apply_delta(d, _torch(base))
    for k in target:
        np.testing.assert_allclose(back[k].numpy(), target[k], atol=1e-6, err_msg=k)


def test_delta_keeps_bf16_and_nested_trees():
    base = {"a": {"w": torch.ones(4, dtype=torch.bfloat16)}}
    target = {"a": {"w": torch.full((4,), 3.0, dtype=torch.bfloat16)}, "b": torch.zeros(2)}
    d = delta.make_delta(target, base)
    assert d["a"]["w"].dtype == torch.bfloat16 and bool((d["a"]["w"] == 2).all())
    assert d["b"] is target["b"]
    with pytest.raises(ValueError, match="rank"):
        delta.make_delta({"w": torch.ones(2, 2)}, {"w": torch.ones(2)})


def test_delta_cli_make_and_apply(tmp_path):
    base, target = _trees(1)
    save_params(str(tmp_path / "base"), _torch(base))
    save_params(str(tmp_path / "target"), _torch(target))
    delta.main(["make-delta", "--base", str(tmp_path / "base"), "--src",
                str(tmp_path / "target"), "--out", str(tmp_path / "delta")])
    delta.main(["apply-delta", "--base", str(tmp_path / "base"), "--src",
                str(tmp_path / "delta"), "--out", str(tmp_path / "back")])
    back = restore_params(str(tmp_path / "back"))
    for k in target:
        np.testing.assert_allclose(back[k].numpy(), target[k], atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def tiny_pair():
    params = init_handsonvlm(jax.random.PRNGKey(0), jax_tiny_config())
    model = build_model(tiny_config(), "cpu")
    load_state_dict_into(model, from_jax_params(params))
    return params, model


def test_export_handsonvlm_key_for_key_with_jax(tiny_pair):
    params, model = tiny_pair
    want = jax_export_handsonvlm(params)
    got = export_handsonvlm(model)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    cut = export_llama(model.llama, vocab_size=32000)
    assert cut["model.embed_tokens.weight"].shape[0] == 32000
    assert cut["lm_head.weight"].shape[0] == 32000


def test_export_refuses_a_quantized_decoder():
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu", quantize="int8")
    with pytest.raises(ValueError, match="dense"):
        export_llama(model.llama)


def test_hf_checkpoint_round_trip_and_consolidate(tiny_pair, tmp_path):
    """save_hf_checkpoint's directory loads back through the builder with
    every tensor equal; consolidate re-saves it as a params export."""
    _, model = tiny_pair
    path = save_hf_checkpoint(model, str(tmp_path / "hf"))
    assert path.endswith("model.safetensors")
    loaded, _, _ = load_pretrained_model(str(tmp_path / "hf"), "tiny", "cpu")
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    delta.consolidate(str(tmp_path / "hf"), str(tmp_path / "one"), preset="tiny")
    one = restore_params(str(tmp_path / "one"))
    assert set(one) == set(want) and all(torch.equal(one[k], want[k]) for k in want)


CAPTIONS = {"v_abcdefghijk": {"timestamps": [[0, 5], [5, 9]],
                              "sentences": [" a man walks ", "he sits down"]}}


def _answers(n=3):
    return [{"question_id": f"abcdefghijk_{i}", "answer_id": i, "prompt": f"q{i}",
             "text_gnd": f"gnd {i}", "text_out": f"out {i}"} for i in range(n)]


def test_gpt_review_prompt_and_scores_equal_jax():
    for review in ("8, 6\nbecause", "7 9", "nonsense", ""):
        assert gpt_review.parse_score(review) == jreview.parse_score(review)
    ctx = gpt_review.context_from_captions(CAPTIONS["v_abcdefghijk"])
    assert ctx == jreview.context_from_captions(CAPTIONS["v_abcdefghijk"])
    assert (gpt_review.build_review_prompt(ctx, "q", "a", "b", "rule")
            == jreview.build_review_prompt(ctx, "q", "a", "b", "rule"))


def test_gpt_review_with_an_injected_judge_resumes(tmp_path):
    """run_reviews with a fake judge writes jsonl and, run again over more
    answers, reviews only the new ones; the summary equals JAX's."""
    calls = []

    def judge(system, user, max_tokens):
        calls.append(user)
        return f"{len(calls) + 5}, {len(calls) + 3}\nreason"

    out = str(tmp_path / "reviews.jsonl")
    first = gpt_review.run_reviews(_answers(2), CAPTIONS, "rule", out, judge=judge)
    assert len(first) == 2 and len(calls) == 2
    allr = gpt_review.run_reviews(_answers(3), CAPTIONS, "rule", out, judge=judge)
    assert len(allr) == 3 and len(calls) == 3
    assert [json.loads(x)["id"] for x in open(out)] == [1, 2, 3]
    assert "[Context]\n<0> <5> a man walks" in calls[0]
    assert gpt_review.summarize_reviews(allr) == jreview.summarize_reviews(allr)
    assert gpt_review.summarize_reviews([{"tuple": [-1, -1]}]) == {"n": 0}


def test_gpt_review_imports_no_openai():
    """The judge's package loads only when the default judge is called."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, handsonvlm_torch.eval.gpt_review\n"
            "assert 'openai' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_profiler_trace_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_meters_and_logger_as_jax(tmp_path, capsys):
    mine, theirs = meters.AverageMeters(), jmeters.AverageMeters()
    for name, v, n in (("loss", 2.0, 1), ("loss", 4.0, 3), ("ade", 1.5, 2)):
        mine.add_loss_value(name, v, n)
        theirs.add_loss_value(name, v, n)
    assert mine.average() == theirs.average() and mine["loss"].val == 4.0
    log = tlogging.build_logger("hoi_test", str(tmp_path / "logs" / "run.log"),
                                level=pylogging.INFO)
    assert tlogging.build_logger("hoi_test", str(tmp_path / "logs" / "run.log")) is log
    log.info("hello")
    assert "hello" in capsys.readouterr().out
    assert "hello" in (tmp_path / "logs" / "run.log").read_text()
