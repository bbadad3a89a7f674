"""The port's checkpoints and adapter artifacts (handsonvlm_torch/core/
checkpoint.py, infer/builder.py), on its own format (torch.save).

Ports of tests/test_checkpoint.py (3) and tests/test_adapter_checkpoints.py
(3): a params export round-trips bit-exact; a train state (step, the model
with its adapters, the optimizer's moments in their own dtypes and count)
restores bit-exact into a fresh template; a missing directory restores to
None; an artifact round-trips and a second save overwrites it; the builder
grafts a projector-only adapter onto its base and merges a LoRA adapter
into its base's decoder. Plus the builder's load of a trainer output
directory, in the decoder layout its state names, adapters attached.
"""

import json

import numpy as np
import pytest
import torch

from handsonvlm_torch.core.checkpoint import (
    has_artifact,
    is_params_export,
    is_trainer_output,
    latest_step,
    restore_artifact,
    restore_params,
    restore_train_state,
    save_artifact,
    save_params,
    save_train_state,
)
from handsonvlm_torch.infer.builder import load_pretrained_model
from handsonvlm_torch.models.llama import _PROJ
from handsonvlm_torch.models.lora import init_lora
from handsonvlm_torch.train.step import make_train_step
from handsonvlm_torch.train.train_state import create_train_state, make_optimizer
from test_torch_train import _batch


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k


def _lora_state(quantize=None, mu_dtype=None, steps=1):
    """A tiny model with LoRA adapters and an optimizer that has taken
    `steps` steps (so its moments exist)."""
    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu", quantize=quantize)
    model.lora = init_lora(torch.Generator().manual_seed(3), cfg.llama, r=2, alpha=4.0)
    opt = make_optimizer(model, 1e-3, freeze_top_keys=("vision", "llama"), mu_dtype=mu_dtype)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, opt, attn_impl="xla", remat=False)
    for _ in range(steps):
        step(state, _batch(t=20, seed=1), 0)
    return state, cfg


def test_params_roundtrip(tmp_path):
    model, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    params = model.state_dict()
    save_params(str(tmp_path / "ck"), params)
    assert is_params_export(str(tmp_path / "ck"))
    _equal(params, restore_params(str(tmp_path / "ck")))


@pytest.mark.parametrize("mu_bf16", [False, True], ids=["mu_f32", "mu_bf16"])
def test_train_state_roundtrip(tmp_path, mu_bf16):
    mu_dtype = torch.bfloat16 if mu_bf16 else None
    state, _ = _lora_state(mu_dtype=mu_dtype)
    state.step = 7
    save_train_state(str(tmp_path / "run"), state, step=7)
    assert latest_step(str(tmp_path / "run")) == 7
    template, _ = _lora_state(mu_dtype=mu_dtype, steps=0)
    restored = restore_train_state(str(tmp_path / "run"), template)
    assert restored is template and restored.step == 7
    _equal(state.model.state_dict(), restored.model.state_dict())
    assert restored.optimizer.count == state.optimizer.count == 1
    saved, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sorted(saved["state"]) == sorted(got["state"])
    for i in saved["state"]:
        _equal(saved["state"][i], got["state"][i])
    if mu_bf16:
        assert all(st["mu"].dtype == torch.bfloat16 for st in got["state"].values())


def test_restore_missing_returns_none(tmp_path):
    template, _ = _lora_state(steps=0)
    assert restore_train_state(str(tmp_path / "nope"), template) is None
    assert not is_trainer_output(str(tmp_path))


def test_artifact_roundtrip_and_overwrite(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    save_artifact(str(tmp_path), "mm_projector", tree, meta={"base": "x"})
    assert has_artifact(str(tmp_path), "mm_projector")
    assert json.loads((tmp_path / "mm_projector.json").read_text()) == {"base": "x"}
    _equal(tree, restore_artifact(str(tmp_path), "mm_projector"))
    # adapter saves repeat every save_every steps: a second save overwrites
    tree2 = {"w": torch.ones((2, 3))}
    save_artifact(str(tmp_path), "mm_projector", tree2, meta={"base": "x"})
    _equal(tree2, restore_artifact(str(tmp_path), "mm_projector"))


def test_mm_projector_adapter_load(tmp_path):
    trained, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    with torch.no_grad():
        for p in trained.projector.parameters():
            p.add_(0.5)
    save_artifact(str(tmp_path), "mm_projector", trained.projector.state_dict(),
                  meta={"base": "random:tiny", "preset": "tiny"})
    model, _, _ = load_pretrained_model(str(tmp_path), "tiny", "cpu")
    # the projector from the artifact, the rest from the base's init
    _equal(trained.projector.state_dict(), model.projector.state_dict())
    base, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    assert torch.equal(model.llama.embed_tokens.weight, base.llama.embed_tokens.weight)
    assert not torch.equal(model.projector.weight, base.projector.weight)


def test_lora_adapter_load_merges(tmp_path):
    base, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    lora = init_lora(torch.Generator().manual_seed(3), cfg.llama, r=4, alpha=8.0)
    with torch.no_grad():  # a nonzero B, so the merge changes the weights
        lora.adapters["wq"].b.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    trained, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    with torch.no_grad():
        trained.traj.linear_means.weight.add_(1.0)
        trained.projector.weight.add_(1.0)
    save_artifact(str(tmp_path), "lora", lora.state_dict(),
                  meta={"base": "random:tiny", "preset": "tiny", "r": 4, "alpha": 8.0})
    save_artifact(str(tmp_path), "non_lora_trainables",
                  {"projector": trained.projector.state_dict(), "traj": trained.traj.state_dict()})
    model, _, _ = load_pretrained_model(str(tmp_path), "tiny", "cpu")
    _equal(trained.projector.state_dict(), model.projector.state_dict())
    _equal(trained.traj.state_dict(), model.traj.state_dict())
    sub, lin = _PROJ["wq"]
    for i, (lp, bp) in enumerate(zip(model.llama.layers, base.llama.layers)):
        delta = (lora.adapters["wq"].a[i] @ lora.adapters["wq"].b[i] * lora.scale).t()
        want = (getattr(getattr(bp, sub), lin).weight + delta.to(cfg.pdtype)).detach()
        torch.testing.assert_close(getattr(getattr(lp, sub), lin).weight, want)
    assert model.lora is None  # merged, not kept as separate adapters


def test_trainer_output_loads_in_its_layout(tmp_path):
    """A trainer output directory without adapter artifacts (its checkpoint
    alone): the builder rebuilds the int8 decoder the state names, attaches
    its adapters, and routes it through the fused kernels on request."""
    state, _ = _lora_state(quantize="int8")
    save_train_state(str(tmp_path / "checkpoints"), state, step=1)
    model, _, _ = load_pretrained_model(str(tmp_path), "tiny", "cpu", quantize="int8_fused")
    assert model.llama.proj is not None and model.llama.quantize == "int8_fused"
    assert model.lora is not None
    _equal(state.model.state_dict(), model.state_dict())
    with pytest.raises(ValueError, match="int8 decoder, not int4"):
        load_pretrained_model(str(tmp_path), "tiny", "cpu", quantize="int4")
    np.testing.assert_array_equal(restore_params(str(tmp_path))["llama.proj.wq.w8"].numpy(),
                                  state.model.llama.proj["wq"].w8.numpy())


def test_attached_adapters_apply_when_decoding():
    """A model loaded with its adapters attached (a trainer checkpoint over
    a quantized base, which cannot be merged) decodes through them, as the
    JAX sampler applies params["lora"]: the prefill and a decode step of the
    dense tiny model with LoRA attached give the merged model's hidden
    states and tokens."""
    from handsonvlm_torch.infer import sampler
    from handsonvlm_torch.infer.profile import random_video
    from handsonvlm_torch.models.lora import merge_lora

    model, cfg, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    lora = init_lora(torch.Generator().manual_seed(3), cfg.llama, r=4, alpha=8.0)
    with torch.no_grad():
        for ad in lora.adapters.values():
            ad.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    merged, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    merge_lora(merged.llama, lora)
    model.lora = lora.requires_grad_(False)
    base, _, _ = load_pretrained_model("random:tiny", "tiny", "cpu")
    video, frame_map = random_video(cfg)
    ids = torch.as_tensor(_batch(b=1, t=16, seed=5)["input_ids"])
    max_len = ids.shape[1] + cfg.num_visual_tokens + 8
    out = []
    with torch.no_grad():
        for m in (model, merged, base):
            h, cache, mask = sampler.prefill(m, cfg, ids, torch.as_tensor(video), max_len,
                                             frame_map=frame_map, attn_impl="xla")
            tok, _, cache = sampler.decode_step(
                m, cfg, cache, mask, torch.tensor([7]), torch.zeros((1, 2, 2)),
                torch.Generator().manual_seed(0), temperature=0.0, top_p=1.0, attn_impl="xla")
            out.append((h, tok, cache.k[:, :, cache.index - 1]))
    for got, want in zip(out[0], out[1]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(out[2][0], out[1][0], atol=1e-3)  # the adapters change it
