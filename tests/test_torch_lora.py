"""The port's LoRA adapters (handsonvlm_torch/models/lora.py) against the JAX
package's, on a small decoder in fp32.

Ports of tests/test_lora.py's seven tests (a no-op init, the activation
path equal to merged weights, training moves only the adapters, the cached
decode, the grouped layouts equal the split one, `save_lora` remat equal
to `full`, bf16 adapter compute close to f32), and the adapted decoder's
hidden states and adapter gradients against JAX's `apply_llama(lora=...)`
from the same weights, MHA and GQA (atol 2e-5 / rtol 1e-4: f32 sums in
another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.core.config import LlamaConfig as JaxLlamaConfig
from handsonvlm_tpu.models import llama as jllama
from handsonvlm_tpu.models.lora import init_lora as jax_init_lora
from handsonvlm_torch.config import LlamaConfig
from handsonvlm_torch.convert.from_hf import _llama_names
from handsonvlm_torch.models import lora as lora_mod
from handsonvlm_torch.models.llama import KVCache, Llama, apply_llama, lm_logits
from handsonvlm_torch.models.lora import LoRA, init_lora, lora_delta, merge_lora
from handsonvlm_torch.train.train_state import AdamW

DIMS = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, max_position_embeddings=64)
CFG = LlamaConfig(**DIMS)
GQA = LlamaConfig(**DIMS, num_kv_heads=2)


def _llama(cfg, seed=0):
    model = Llama(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.requires_grad_(False)


def _lora(cfg, r=4, bump=0.0, seed=1):
    lora = init_lora(torch.Generator().manual_seed(seed), cfg, r=r)
    if bump:
        with torch.no_grad():
            for p in lora.parameters():
                p.add_(bump)
    return lora


def _ids(n):
    return torch.arange(n)[None] % 100


def _nll(model, cfg, lora, ids, labels, remat=False):
    hidden, _ = apply_llama(model, cfg, input_ids=ids, attn_impl="xla", lora=lora, remat=remat)
    logp = torch.log_softmax(lm_logits(model, cfg, hidden), -1)
    return -torch.gather(logp, -1, labels[..., None]).mean()


def test_lora_init_is_noop():
    model = _llama(CFG)
    base, _ = apply_llama(model, CFG, input_ids=_ids(10), attn_impl="xla")
    with_lora, _ = apply_llama(model, CFG, input_ids=_ids(10), attn_impl="xla",
                               lora=_lora(CFG))
    torch.testing.assert_close(with_lora, base, atol=1e-6, rtol=0)


def test_lora_activation_path_matches_merged_weights():
    model, lora = _llama(CFG), _lora(CFG, bump=0.01)
    adapted, _ = apply_llama(model, CFG, input_ids=_ids(10), attn_impl="xla", lora=lora)
    merge_lora(model, lora)
    merged, _ = apply_llama(model, CFG, input_ids=_ids(10), attn_impl="xla")
    torch.testing.assert_close(adapted, merged, atol=1e-4, rtol=0)


def test_lora_training_moves_only_adapters():
    model, lora = _llama(CFG), _lora(CFG)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    ids, labels = _ids(12), (_ids(12) + 1) % 100
    opt = AdamW([{"params": list(lora.parameters())}], learning_rate=1e-2,
                max_grad_norm=None)
    with torch.no_grad():
        l0 = float(_nll(model, CFG, lora, ids, labels))
    for _ in range(5):
        opt.zero_grad()
        _nll(model, CFG, lora, ids, labels).backward()
        opt.step()
    with torch.no_grad():
        assert float(_nll(model, CFG, lora, ids, labels)) < l0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, base[k], atol=0, rtol=0)


def test_lora_with_kv_cache_decode():
    model, lora = _llama(CFG), _lora(CFG, bump=0.01)
    ids = _ids(8)
    with torch.no_grad():
        full, _ = apply_llama(model, CFG, input_ids=ids, attn_impl="xla", lora=lora)
        cache = KVCache.create(CFG, 1, 16, torch.float32, "cpu")
        _, cache = apply_llama(model, CFG, input_ids=ids[:, :5], kv_cache=cache,
                               attn_impl="xla", lora=lora)
        step, _ = apply_llama(model, CFG, input_ids=ids[:, 5:6], kv_cache=cache,
                              attn_impl="xla", lora=lora)
    torch.testing.assert_close(step[:, 0], full[:, 5], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cfg", [CFG, GQA], ids=["mha", "gqa"])
def test_lora_grouped_matches_split(cfg, monkeypatch):
    """HANDSONVLM_LORA_GROUPED "1" / "first" give the split default's loss
    and adapter gradients: MHA (one concatenated delta) and GQA (the tuple
    fallback: q and kv widths differ)."""
    model, lora = _llama(cfg), _lora(cfg, bump=0.02)
    ids, labels = _ids(10), (_ids(10) + 1) % 100
    outs = {}
    for flag in ("1", "first", "0"):
        monkeypatch.setenv("HANDSONVLM_LORA_GROUPED", flag)
        lora.zero_grad()
        loss = _nll(model, cfg, lora, ids, labels)
        loss.backward()
        outs[flag] = (float(loss), [p.grad.clone() for p in lora.parameters()])
    for flag in ("1", "first"):
        np.testing.assert_allclose(outs[flag][0], outs["0"][0], rtol=1e-6)
        for a, b in zip(outs[flag][1], outs["0"][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_save_lora_remat_matches_full():
    """remat="save_lora" (recompute all but the adapters' x @ a) is a pure
    scheduling change: loss and adapter gradients equal remat="full"'s."""
    model, lora = _llama(CFG), _lora(CFG, bump=0.02)
    ids, labels = _ids(10), (_ids(10) + 1) % 100
    res = {}
    for remat in ("full", "save_lora"):
        lora.zero_grad()
        loss = _nll(model, CFG, lora, ids, labels, remat=remat)
        loss.backward()
        res[remat] = (float(loss), [p.grad.clone() for p in lora.parameters()])
    np.testing.assert_allclose(res["save_lora"][0], res["full"][0], rtol=1e-7)
    for a, b in zip(res["save_lora"][1], res["full"][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_lora_bf16_compute_close(monkeypatch):
    """bf16 adapter compute (HANDSONVLM_LORA_BF16) tracks the f32 path
    within bf16 rounding on a bf16 stream; f32 activations ignore it."""
    lora = init_lora(torch.Generator().manual_seed(0), CFG, r=8, alpha=16.0)
    with torch.no_grad():
        lora.adapters["wq"].b.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    layer0 = lora.layer(0)
    x32 = torch.randn((4, CFG.hidden_size), generator=torch.Generator().manual_seed(2))
    x16 = x32.to(torch.bfloat16)
    ref = lora_delta(layer0, "wq", x16, 2.0)
    monkeypatch.setattr(lora_mod, "LORA_COMPUTE_BF16", True)
    got16 = lora_delta(layer0, "wq", x16, 2.0)
    got32 = lora_delta(layer0, "wq", x32, 2.0)
    monkeypatch.setattr(lora_mod, "LORA_COMPUTE_BF16", False)
    assert got16.dtype == torch.bfloat16
    err = float((got16.float() - ref.float()).abs().max())
    assert err / (float(ref.float().abs().max()) + 1e-9) < 0.05
    torch.testing.assert_close(got32, lora_delta(layer0, "wq", x32, 2.0), atol=0, rtol=0)


@pytest.mark.parametrize("cfg", [CFG, GQA], ids=["mha", "gqa"])
def test_lora_matches_jax(cfg):
    """The adapted decoder's hidden states and the adapters' gradients of a
    shifted NLL against JAX's, the JAX weights and adapters carried over."""
    jcfg = JaxLlamaConfig(**DIMS, num_kv_heads=cfg.num_kv_heads)
    params = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    jlora = jax_init_lora(jax.random.PRNGKey(1), jcfg, r=4, alpha=8.0)
    jlora["adapters"] = jax.tree_util.tree_map(lambda x: x + 0.02, jlora["adapters"])
    ids = np.arange(10)[None] % 100
    labels = (ids + 1) % 100

    def jloss(lora):
        hidden, _ = jllama.apply_llama(params, jcfg, input_ids=jnp.asarray(ids),
                                       attn_impl="xla", lora=lora)
        logp = jax.nn.log_softmax(jllama.lm_logits(params, jcfg, hidden), -1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean(), hidden

    (jl, jhidden), jgrads = jax.value_and_grad(jloss, has_aux=True)(jlora)

    model = Llama(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           _llama_names(params, cfg.vocab_size, prefix="").items()})
    model.requires_grad_(False)
    lora = LoRA(cfg, r=4, alpha=8.0)
    with torch.no_grad():
        for t, ad in lora.adapters.items():
            ad.a.copy_(torch.from_numpy(np.array(jlora["adapters"][t]["a"])))
            ad.b.copy_(torch.from_numpy(np.array(jlora["adapters"][t]["b"])))
    hidden, _ = apply_llama(model, cfg, input_ids=torch.from_numpy(ids), attn_impl="xla",
                            lora=lora)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jhidden), atol=2e-5,
                               rtol=1e-4)
    loss = _nll(model, cfg, lora, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for t, ad in lora.adapters.items():
        for key in ("a", "b"):
            np.testing.assert_allclose(getattr(ad, key).grad.numpy(),
                                       np.asarray(jgrads["adapters"][t][key]), atol=2e-5,
                                       rtol=1e-4, err_msg=f"{t}.{key}")
