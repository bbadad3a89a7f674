"""The port's training CLI (handsonvlm_torch/train/train.py) at the tiny
preset on the CPU: `main` trains 2 steps over `--synthetic` samples, saves
`checkpoints/2` and the adapter artifacts, then the same command with
`--max-steps 3` resumes from step 2 and runs one step. Checked: one JSON
metrics line per step (stdout and metrics.jsonl), the checkpoint restored
into a fresh template bit-equal to the state the first run ended with, the
artifacts, and the builder's load of the output directory. For
`--qlora int8_fused` (LoRA r=4 over the fused int8 base, B10a / B10b's plain
versions) and `--tune-mm-mlp-adapter` (the projector alone). The flags that
wait for a ROADMAP item, and the data paths whose files are missing, refuse
with SystemExit."""

import json
import os

import numpy as np
import pytest
import torch

from handsonvlm_torch.core.checkpoint import (
    has_artifact,
    latest_step,
    restore_artifact,
    restore_train_state,
)
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.models.lora import init_lora
from handsonvlm_torch.train import train
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer

MODES = {
    "int8_fused": ["--qlora", "int8_fused", "--lora-r", "4", "--lora-alpha", "8"],
    "mm_adapter": ["--tune-mm-mlp-adapter"],
}


def _argv(out, steps, extra, synthetic=True):
    return ["--model-path", "random:tiny", "--preset", "tiny", "--device", "cpu",
            "--output-dir", str(out), *(["--synthetic", "4"] if synthetic else []),
            "--samples-per-epoch", "4", "--batch-size", "2", "--max-steps", str(steps),
            "--log-every", "1", "--learning-rate", "1e-3", *extra]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _template(mode):
    """A fresh state laid out as the CLI lays it out (its freezing, its
    adapters), to restore into."""
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu",
                                          quantize="int8_fused" if mode == "int8_fused" else None)
    if mode == "int8_fused":
        model.lora = init_lora(torch.Generator().manual_seed(0), cfg.llama, r=4, alpha=8.0)
        freeze = ("vision", "llama")
    else:
        freeze = ("llama", "vision", "traj")
    return create_train_state(model, make_optimizer(model, 1e-3, freeze_top_keys=freeze))


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_trains_saves_resumes(tmp_path, capsys, mode):
    out = tmp_path / "run"
    first = train.main(_argv(out, 2, MODES[mode]))
    text = capsys.readouterr().out
    lines = _json_lines(text)
    assert [m["step"] for m in lines] == [1, 2]
    for m in lines:
        assert {"loss", "text_loss", "traj_loss", "traj_kl_loss", "grad_norm", "lr",
                "sec_per_step"} <= set(m)
    assert "saved checkpoint at step 2" in text
    assert latest_step(str(out / "checkpoints")) == 2

    # the saved state restores bit-equal into a fresh template
    restored = restore_train_state(str(out / "checkpoints"), _template(mode))
    assert restored.step == first.step == 2
    want = first.model.state_dict()
    got = restored.model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert restored.optimizer.count == first.optimizer.count == 2
    w_opt, g_opt = first.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert sorted(w_opt) == sorted(g_opt)
    assert all(torch.equal(g_opt[i][k], w_opt[i][k]) for i in w_opt for k in w_opt[i])

    # the artifacts
    if mode == "int8_fused":
        assert has_artifact(str(out), "lora") and has_artifact(str(out), "non_lora_trainables")
        meta = json.loads((out / "lora.json").read_text())
        assert meta == {"base": "random:tiny", "preset": "tiny", "r": 4, "alpha": 8.0,
                        "qlora": "int8_fused"}
        saved = restore_artifact(str(out), "lora")
        assert all(torch.equal(saved[k], v) for k, v in first.model.lora.state_dict().items())
        assert not has_artifact(str(out), "mm_projector")
    else:
        saved = restore_artifact(str(out), "mm_projector")
        assert all(torch.equal(saved[k], v) for k, v in first.model.projector.state_dict().items())
        assert not has_artifact(str(out), "lora")

    # resume to 3: one step from the restored state
    second = train.main(_argv(out, 3, MODES[mode]))
    text = capsys.readouterr().out
    assert "resumed from step 2" in text
    assert [m["step"] for m in _json_lines(text)] == [3]
    assert second.step == 3 and latest_step(str(out / "checkpoints")) == 3
    assert os.path.isdir(out / "checkpoints" / "2")
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]

    # the builder loads what the trainer wrote
    model, _, _ = load_pretrained_model(str(out), "tiny", "cpu")
    if mode == "int8_fused":  # merged into the dense base the meta names
        assert model.llama.proj is None and model.lora is None
        assert torch.equal(model.projector.weight, second.model.projector.weight.detach())
    else:
        assert torch.equal(model.projector.weight, second.model.projector.weight.detach())


@pytest.mark.parametrize("extra, item", [
    (["--model-axis", "2", "--seq-parallel", "2"], "seq and model axes are mutually exclusive"),
    (["--seq-parallel", "2"], "does not divide the 1 ranks"),
    (["--eval-every", "5"], "EK validation set"),
    (["--qlora", "int8"], "requires --lora-r"),
], ids=["model_axis", "seq_parallel", "eval_every", "qlora_without_lora"])
def test_cli_refuses_what_waits(tmp_path, extra, item):
    with pytest.raises(SystemExit, match=item):
        train.main(_argv(tmp_path, 1, extra))


def test_cli_refuses_the_task_data_paths(tmp_path, monkeypatch):
    """Without `--synthetic` the default task reads the EK layout: where it
    is missing the CLI refuses, naming it."""
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(tmp_path / "absent"))
    with pytest.raises(SystemExit, match="EK layout"):
        train.main(_argv(tmp_path, 1, [], synthetic=False))


def test_pretrain_cli_saves_projector_adapter(tmp_path, capsys):
    """Port of tests/test_train_cli_pretrain.py: `--tasks pretrain` trains
    on LLaVA-Pretrain caption pairs (the plain template) and saves the
    projector-only adapter artifact."""
    from PIL import Image

    d = tmp_path / "data" / "LLaVA-Pretrain"
    (d / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(4):
        Image.fromarray(rng.uniform(0, 255, size=(240, 320, 3)).astype(np.uint8)).save(
            d / "images" / f"img{i}.jpg")
        records.append({"image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"a synthetic caption number {i}"}]})
    (d / "blip_laion_cc_sbu_558k.json").write_text(json.dumps(records))
    out = tmp_path / "run"
    train.main(["--model-path", "random:tiny224", "--preset", "tiny224", "--device", "cpu",
                "--tasks", "pretrain", "--data-path", str(tmp_path / "data"),
                "--tune-mm-mlp-adapter", "--output-dir", str(out), "--num-frames", "4",
                "--batch-size", "8", "--samples-per-epoch", "8", "--epochs", "1",
                "--max-steps", "1", "--log-every", "1"])
    assert has_artifact(str(out), "mm_projector")
    proj = restore_artifact(str(out), "mm_projector")
    assert sorted(proj) == ["bias", "weight"]
    metrics = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(metrics) >= 1 and np.isfinite(metrics[-1]["loss"])
    assert _json_lines(capsys.readouterr().out)[-1]["step"] == 1


def test_cli_trains_on_epic_tasks_and_evaluates(tmp_path, monkeypatch, capsys):
    """`--tasks epic_kitchen --eval-every 1` at tiny224 over an on-disk EK100
    layout (chip_smoke's, its train clip labeled too): one step on the
    multiturn EPIC conversations, then the ADE/FDE evaluation of the
    validation clips through the engine and evaluator, its line printed and
    logged."""
    import pickle

    import chip_smoke

    root = tmp_path / "ek"
    chip_smoke.write_ek_fixture(str(root), n_val=2)
    with open(root / "ek100" / "labels" / "label_0.pkl", "wb") as f:
        pickle.dump(chip_smoke._ek_video_info(np.random.default_rng(1)), f)
    # the validation questions also cover the train clip's last frame
    (root / "assets" / "ek100_questions.json").write_text(
        (root / "assets" / "ek100_questions_val.json").read_text())
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(root))
    monkeypatch.setenv("HANDSONVLM_ASSETS_DIR", str(root / "assets"))
    out = tmp_path / "run"
    state = train.main(["--model-path", "random:tiny224", "--preset", "tiny224", "--device",
                        "cpu", "--tasks", "epic_kitchen||reasoning", "--eval-every", "1",
                        "--eval-samples", "2", "--output-dir", str(out), "--batch-size", "2",
                        "--samples-per-epoch", "2", "--max-steps", "1", "--log-every", "1",
                        "--task-sample-rates", "1.0"])
    assert state.step == 1
    lines = _json_lines(capsys.readouterr().out)
    evals = [m for m in lines if "eval/n" in m]
    assert len(evals) == 1 and evals[0]["step"] == 1
    assert 0 <= evals[0]["eval/n"] <= 2
    steps = [m for m in lines if "loss" in m]
    assert len(steps) == 1 and np.isfinite(steps[0]["loss"])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("eval/ade" in r for r in records)
    with pytest.raises(SystemExit, match="2 entries but --tasks resolves to 1"):
        train.main(["--model-path", "random:tiny224", "--preset", "tiny224", "--device",
                    "cpu", "--tasks", "epic_kitchen", "--output-dir", str(tmp_path / "r2"),
                    "--task-sample-rates", "1,1"])
