"""The port's speculative decode against the JAX package's, at the tiny
preset in fp32 on the CPU (every op runs its plain version).

- `ngram_draft` and greedy `spec_verify` give what the JAX functions give on
  the same arrays; sampled `spec_verify` takes the same accept decisions on
  the same uniforms (derived from the JAX key as the JAX function derives
  them; the resampled tokens come from other draws and are not compared).
- The JAX package's own checks (tests/test_speculative.py,
  tests/test_spec_acceptance.py), run on the port: the rejection sampler
  keeps the distribution (4-sigma binomial bound per bucket), greedy
  speculative decode is token-identical to the sequential loop
  (`generate_host`), a bank with the continuation yields more than one
  token per forward, the gate falls to k = 0 or keeps speculating, and a
  model that has memorized an answer template accepts at temperature 0.5.
- Greedy `generate_spec` equals JAX's: tokens, `iters`, `drafts_found` and
  `accept_hist` exactly, waypoints to 1e-5 with JAX's CVAE latents
  injected; dense, over the int8 cache, and with the int4 tree (JAX decodes
  with those weights exactly dequantized, as test_torch_slice.py does).
- The rewound cache: rows written past the accepted prefix are never read.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from handsonvlm_tpu.constants import IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.infer import speculative as jspec
from handsonvlm_tpu.infer.builder import load_pretrained_model as jax_load_pretrained_model
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_torch.config import get_config, tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.infer.sampler import EOS_TOKEN_ID, generate_host
from handsonvlm_torch.infer.speculative import (
    build_template_bank,
    generate_spec,
    ngram_draft,
    spec_verify,
)
from handsonvlm_torch.models.llama import (
    KVCache,
    apply_llama,
    quantize_kv_cache,
)

JCFG = jax_tiny_config()
CFG = tiny_config()


# -- the draft lookup ---------------------------------------------------------------------


def test_ngram_draft_lookup():
    buf = np.asarray([5, 6, 7, 8, 0, 5, 6, 9, 3, 0, 0, 0], np.int32)
    draft, found = ngram_draft(buf, 9, 5, 6, 3)  # the latest (5, 6) pair is at 5
    assert found
    np.testing.assert_array_equal(draft, [9, 3, 0])
    draft, found = ngram_draft(buf, 9, 6, 9, 3)  # PAD past buf_len
    assert found
    np.testing.assert_array_equal(draft, [3, 0, 0])
    draft, found = ngram_draft(buf, 9, 7, 7, 3)  # no match: every slot PAD
    assert not found and not draft.any()
    # the current context pair itself (at the buffer's end) is not a match
    assert not ngram_draft(buf, 9, 9, 3, 3)[1]
    assert ngram_draft(buf, 9, 5, 6, 0)[0].shape == (0,)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_matches_jax(seed):
    """Random buffers over a 4-token alphabet (many repeated bigrams), every
    context pair, k in {1, 4}: the same draft and the same `found`."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, size=(24,)).astype(np.int32)
    buf_len = int(rng.integers(2, 25))
    for k in (1, 4):
        for a in range(4):
            for b in range(4):
                want, want_found = jspec.ngram_draft(jnp.asarray(buf), jnp.asarray(buf_len),
                                                     a, b, k)
                got, found = ngram_draft(buf, buf_len, a, b, k)
                assert found == bool(want_found)
                np.testing.assert_array_equal(got, np.asarray(want))


# -- the verifier -------------------------------------------------------------------------


def test_spec_verify_greedy():
    """temperature 0: exactly the argmax-matching prefix is accepted."""
    v = 16
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(4, v)).astype(np.float32))
    target = logits.argmax(dim=-1).numpy()
    # the draft matches positions 0, 1 and then diverges
    draft = np.asarray([target[0], target[1], (target[2] + 1) % v], np.int32)
    emitted, n = spec_verify(logits, draft, 0.0, 0.9, 99, 98)
    assert n == 3
    np.testing.assert_array_equal(emitted[:3], target[:3])
    # full acceptance adds the bonus token
    emitted, n = spec_verify(logits, target[:3], 0.0, 0.9, 99, 98)
    assert n == 4
    np.testing.assert_array_equal(emitted, target)


def test_spec_verify_truncates_at_hand_and_eos():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    target = logits.argmax(dim=-1).numpy()
    draft = target[:3]
    # position 1's token taken as the hand token: emitted, then stop
    assert spec_verify(logits, draft, 0.0, 0.9, int(target[1]), 999)[1] == 2
    assert spec_verify(logits, draft, 0.0, 0.9, 999, int(target[0]))[1] == 1  # EOS first


def test_spec_verify_preserves_distribution():
    """The marginal of the first emitted token is softmax(warped logits),
    whether the draft is likely or not (the rejection-sampling identity)."""
    v = 6
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5, 1.5], [0.0] * v])  # k = 1: 2 rows
    temperature, top_p = 0.8, 1.0
    probs = torch.softmax(logits[0] / temperature, dim=-1).numpy()
    n_trials = 4000
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops: no thread pool to wait on
    try:
        for d in (0, 3):  # a high- and a low-probability draft
            gen = torch.Generator().manual_seed(d)
            toks = np.asarray([spec_verify(logits, [d], temperature, top_p, 99, 98,
                                           generator=gen)[0][0] for _ in range(n_trials)])
            emp = np.bincount(toks, minlength=v) / n_trials
            for t in range(v):
                sigma = np.sqrt(probs[t] * (1 - probs[t]) / n_trials)
                assert abs(emp[t] - probs[t]) < 4 * sigma + 1e-3, (d, t, emp[t], probs[t])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", range(5))
def test_spec_verify_greedy_matches_jax(seed):
    """Random logits, drafts that match the argmax on a random prefix, hand
    and EOS ids that sometimes hit: the same emission and count."""
    rng = np.random.default_rng(seed)
    k, v = 4, 12
    logits = rng.normal(size=(k + 1, v)).astype(np.float32)
    target = logits.argmax(axis=-1)
    for match in range(k + 1):
        draft = ((target[:k] + (np.arange(k) >= match)) % v).astype(np.int32)
        for hand, eos in ((99, 98), (int(target[1]), 98), (99, int(target[2]))):
            want, want_n = jspec.spec_verify(jax.random.PRNGKey(0), jnp.asarray(logits),
                                             jnp.asarray(draft), 0.0, 0.9, hand, eos)
            got, n = spec_verify(torch.from_numpy(logits), draft, 0.0, 0.9, hand, eos)
            assert n == int(want_n)
            np.testing.assert_array_equal(got[:n], np.asarray(want)[:n])


@pytest.mark.parametrize("seed", range(5))
def test_spec_verify_sampled_accepts_as_jax(seed):
    """The same acceptance uniforms (the first k of the 2k + 1 keys the JAX
    function splits its key into) give the same accepted prefix; hand and
    EOS ids outside the vocabulary, so the count is the prefix plus one."""
    rng = np.random.default_rng(seed)
    k, v = 4, 8
    logits = (2.0 * rng.normal(size=(k + 1, v))).astype(np.float32)
    draft = logits[:k].argmax(axis=-1).astype(np.int32)  # likely drafts: both outcomes occur
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.vmap(jax.random.uniform)(jax.random.split(key, 2 * k + 1)[:k]))
    want, want_n = jspec.spec_verify(key, jnp.asarray(logits), jnp.asarray(draft), 0.7, 0.9,
                                     999, 998)
    got, n = spec_verify(torch.from_numpy(logits), draft, 0.7, 0.9, 999, 998, u=u,
                         generator=torch.Generator().manual_seed(seed))
    assert n == int(want_n)
    np.testing.assert_array_equal(got[:n - 1], np.asarray(want)[:n - 1])
    if n <= k:  # the resampled token is never the rejected draft
        assert got[n - 1] != draft[n - 1]


def test_build_template_bank():
    """The EK answer templates joined with EOS, real token ids only, and the
    same bank as the JAX package's."""
    from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JaxMockTokenizer

    bank = build_template_bank(MockTokenizer(), CFG, ("reach for the cup",))
    assert bank.ndim == 1 and bank.size > 20 and bank.dtype == np.int32
    assert (bank >= 0).all()
    assert (bank == EOS_TOKEN_ID).sum() >= 7  # one per template joined
    want = jspec.build_template_bank(JaxMockTokenizer(), JCFG, ("reach for the cup",))
    np.testing.assert_array_equal(bank, np.asarray(want))


# -- the loop -----------------------------------------------------------------------------


def _port(params, quantize=None):
    model = build_model(get_config("tiny") if quantize else CFG, "cpu", quantize=quantize)
    load_state_dict_into(model, from_jax_params(params))
    return model


def _prompt():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(1, 12))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    frames = rng.normal(size=(1, 4, 3, 56, 56)).astype(np.float32)  # unique frames
    frame_map = np.tile(np.arange(4, dtype=np.int32), CFG.num_frames // 4)
    return ids, frames, frame_map


KW = dict(max_new_tokens=12, temperature=0.0)


@pytest.fixture(scope="module")
def params():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def int4_params():
    """JAX int4 params and the same tree exactly dequantized (int8 head kept)."""
    from test_torch_quant import dense_from_int4

    p, jcfg, _ = jax_load_pretrained_model("random:tiny", "tiny", quantize="int4")
    return p, dict(p, llama=dense_from_int4(p["llama"], jcfg.llama)), jcfg


@pytest.fixture(scope="module")
def setups(params, int4_params):
    """mode -> (JAX params, JAX cfg, port model, port cfg, kv_quant)."""
    p4, dense4, jcfg4 = int4_params
    return {
        "dense": (params, JCFG, _port(params), CFG, None),
        "kv8": (params, JCFG, _port(params), CFG, "int8"),
        "int4": (dense4, jcfg4, _port(p4, "int4"), get_config("tiny"), None),
        "int4_kv8": (dense4, jcfg4, _port(p4, "int4"), get_config("tiny"), "int8"),
    }


@pytest.fixture(scope="module")
def sequential(setups):
    """mode -> the port's sequential greedy decode (generate_host)."""
    ids, frames, frame_map = _prompt()
    return {mode: generate_host(model, cfg, ids, frames, None, frame_map=frame_map,
                                kv_quant=kvq, **KW)
            for mode, (_, _, model, cfg, kvq) in setups.items()}


def _bank(ids, ref):
    """[the last prompt token] + the true continuation: bigram-reachable."""
    n = int(ref.num_tokens[0])
    return np.concatenate([[ids[0, -1]], ref.sequences[0, :n]]).astype(np.int32)


MODES = ["dense", "kv8", "int4", "int4_kv8"]


@pytest.mark.parametrize("mode", MODES)
def test_spec_greedy_matches_sequential(setups, sequential, mode):
    """Greedy speculative decode is token-identical to the sequential loop,
    hand-token counts included, with an empty bank (every draft PAD or a
    prompt n-gram) and the gate on."""
    _, _, model, cfg, kvq = setups[mode]
    ids, frames, frame_map = _prompt()
    ref = sequential[mode]
    out, stats = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                               kv_quant=kvq, **KW)
    n = int(ref.num_tokens[0])
    assert int(out.num_tokens[0]) == n
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert int(out.num_hands[0]) == int(ref.num_hands[0])
    assert stats["iters"] >= 1 and sum(stats["accept_hist"]) == stats["iters"]
    # the cache index after every forward: the accepted prefix, never past it
    index = ids.shape[1] + cfg.num_visual_tokens - 1
    for before, n_emit, after in stats["trace"]:
        assert before == index and after == before + n_emit and 1 <= n_emit <= 4
        index = after


@pytest.mark.parametrize("mode", MODES)
def test_spec_bank_accelerates(setups, sequential, mode):
    """A bank that holds the model's own greedy continuation yields drafts
    that are accepted: fewer forwards than tokens, the same tokens."""
    _, _, model, cfg, kvq = setups[mode]
    ids, frames, frame_map = _prompt()
    ref = sequential[mode]
    out, stats = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                               bank_ids=_bank(ids, ref), kv_quant=kvq, **KW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    assert stats["iters"] < stats["tokens"], stats  # > 1 token per forward
    assert stats["gated"] is False


def test_gate_falls_back_to_sequential_cost(setups, sequential):
    """With random weights and no bank the probe flips the loop to k = 0,
    whose forward is a sequential step, and the greedy output stays that of
    the sequential loop."""
    _, _, model, cfg, _ = setups["dense"]
    ids, frames, frame_map = _prompt()
    ref = sequential["dense"]
    # a threshold above k + 1 forces the gate even if a draft lands by luck
    out, stats = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                               gate_tok_per_fwd=99.0, probe_iters=2, **KW)
    assert stats["gated"] is True
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    n = int(ref.num_tokens[0])
    # after the gate every forward emits exactly one token
    assert stats["iters"] >= n - 1 - 3 * 2
    assert all(n_emit == 1 for _, n_emit, _ in stats["trace"][2:])
    # the gate turned off never falls back
    out2, stats2 = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                                 gate_tok_per_fwd=0.0, **KW)
    assert stats2["gated"] is False
    np.testing.assert_array_equal(out2.sequences, ref.sequences)


def test_gate_keeps_speculation_when_accepting(setups, sequential):
    _, _, model, cfg, _ = setups["dense"]
    ids, frames, frame_map = _prompt()
    ref = sequential["dense"]
    out, stats = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                               bank_ids=_bank(ids, ref), gate_tok_per_fwd=1.2, probe_iters=2,
                               **KW)
    assert stats["gated"] is False and stats["iters"] < stats["tokens"]
    np.testing.assert_array_equal(out.sequences, ref.sequences)


def test_on_token_streams_bursts_and_max_len_is_checked(setups, sequential):
    _, _, model, cfg, _ = setups["dense"]
    ids, frames, frame_map = _prompt()
    ref = sequential["dense"]
    seen = []
    out, _ = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                           bank_ids=_bank(ids, ref), on_token=seen.append, **KW)
    n = int(out.num_tokens[0])
    want = [int(t) for t in out.sequences[0, :n] if t != EOS_TOKEN_ID]
    assert seen == want
    t_prompt = ids.shape[1] + cfg.num_visual_tokens - 1
    with pytest.raises(ValueError, match="max_len"):
        generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                      max_len=t_prompt + 12 + 3 + 1, **KW)
    with pytest.raises(ValueError, match="B = 1"):
        generate_spec(model, cfg, np.concatenate([ids, ids]), np.concatenate([frames, frames]),
                      None, k=3, **KW)


# -- against JAX's generate_spec --------------------------------------------------------


def _jax_spec_latents(key, iters, n_fwd):
    """The CVAE latents JAX's generate_spec draws with the gate off and no
    streaming: the first token's, then one per forward of its one chunk of
    `iters` iterations."""
    def z(r):
        return np.array(JCFG.traj.z_scale * jax.random.normal(r, (2, JCFG.traj.latent_dim)))

    key, r0 = jax.random.split(key)
    zs = [z(jax.random.split(r0)[1])]
    _, rng = jax.random.split(key)
    for _ in range(min(iters, n_fwd)):
        rng, _, r_w = jax.random.split(rng, 3)
        zs.append(z(r_w))
    return zs


@pytest.mark.parametrize("mode", MODES)
def test_generate_spec_matches_jax(setups, sequential, mode):
    """Greedy, k = 3, the gate off, the bank = the sequential continuation:
    the same tokens, forwards, drafts found and acceptance histogram as
    JAX's generate_spec."""
    jparams, jcfg, model, cfg, kvq = setups[mode]
    ids, frames, frame_map = _prompt()
    bank = _bank(ids, sequential[mode])
    want, wstats = jspec.generate_spec(
        jparams, jcfg, ids, frames, jax.random.PRNGKey(7), k=3, frame_map=frame_map,
        bank_ids=bank, kv_quant=kvq, gate_tok_per_fwd=0.0, attn_impl="xla", **KW)
    got, stats = generate_spec(model, cfg, ids, frames, None, k=3, frame_map=frame_map,
                               bank_ids=bank, kv_quant=kvq, gate_tok_per_fwd=0.0, **KW)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_tokens, np.asarray(want.num_tokens))
    for key in ("iters", "drafts_found", "tokens", "accept_hist", "gated"):
        assert stats[key] == wstats[key], (key, stats, wstats)
    assert stats["iters"] < stats["tokens"]


def test_generate_spec_hand_waypoints_match_jax(params):
    """The head rigged so that <hand_traj> wins whenever u.h > 0 (token 0
    otherwise), as in test_torch_slice.py: hand tokens cut every window and
    enter the cache through embed_next_token; with JAX's latents injected
    the waypoints agree to 1e-5."""
    rigged = dict(params)
    d, v = params["llama"]["lm_head"]["weight"].shape
    w = np.zeros((d, v), np.float32)
    w[:, JCFG.hand_token_id] = -2.0
    rigged["llama"] = dict(params["llama"], lm_head={"weight": jnp.asarray(w)})
    ids, frames, frame_map = _prompt()
    key, steps = jax.random.PRNGKey(11), 8
    bank = np.asarray([ids[0, -1], 0, JCFG.hand_token_id, 0, JCFG.hand_token_id], np.int32)
    kw = dict(k=3, max_new_tokens=steps, temperature=0.0, frame_map=frame_map, bank_ids=bank,
              gate_tok_per_fwd=0.0)
    want, wstats = jspec.generate_spec(rigged, JCFG, ids, frames, key, attn_impl="xla", **kw)
    got, stats = generate_spec(_port(rigged), CFG, ids, frames, None,
                               z_steps=_jax_spec_latents(key, steps, wstats["iters"]), **kw)
    assert int(np.asarray(want.num_hands)[0]) > 0
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_hands, np.asarray(want.num_hands))
    np.testing.assert_allclose(got.pred_hands, np.asarray(want.pred_hands), atol=1e-5)
    assert stats["accept_hist"] == wstats["accept_hist"] and stats["iters"] == wstats["iters"]


def test_spec_accepts_at_sampling_temperature():
    """tests/test_spec_acceptance.py on the port: a tiny model trained (by
    the JAX package's harness) to memorize one EK answer template, carried
    over to the port, accepts template drafts at the evaluation temperature
    0.5: well over one token per forward, and a consistent histogram."""
    from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JaxMockTokenizer
    from tools.spec_harness import memorize_template

    narr = "open the fridge"
    state, inst, cut, m = memorize_template(JCFG, JaxMockTokenizer(), narr, steps=130)
    assert float(m["text_loss"]) < 0.3, f"memorization failed, text_loss={m['text_loss']}"
    model = _port(state.params)
    ids = np.asarray(inst["input_ids"])[None][:, :cut]
    bank = build_template_bank(MockTokenizer(), CFG, (narr,))
    tot_tok = tot_fwd = 0
    hist = np.zeros(6, np.int64)
    for seed in range(3):
        out, stats = generate_spec(model, CFG, ids, inst["image"][None],
                                   torch.Generator().manual_seed(seed), max_new_tokens=20,
                                   k=4, temperature=0.5, top_p=0.9, bank_ids=bank)
        tot_tok += stats["tokens"]
        tot_fwd += stats["iters"]
        hist += np.asarray(stats["accept_hist"])
    rate = tot_tok / max(tot_fwd, 1)
    assert rate >= 1.3, (rate, hist.tolist())
    # the histogram counts emissions per forward; each run's first token comes
    # from the prefill, and `tokens` may be cut by EOS / max_new below the raw count
    assert hist.sum() == tot_fwd
    assert int(np.dot(np.arange(6), hist)) + 3 >= tot_tok
    assert hist[2:].sum() > 0, hist.tolist()


# -- row reductions that do not depend on the window ------------------------------------


@pytest.mark.parametrize("proj", ["wqkv", "wo", "wgu", "w_down"])
def test_int4_gemv_splits_do_not_depend_on_the_rows(proj):
    """The int4 GEMV cuts a row's contraction into splits from the weight's
    tiling and the card alone (no row count among its arguments), so row i
    of a k + 1 window sums in the order of the same position decoded alone.
    Every group is covered once, and one row's blocks fill 132 SMs about
    twice where the weight has the groups for it."""
    import inspect

    from handsonvlm_torch.models.llama import int4_projection_shapes
    from handsonvlm_torch.ops.int8_matmul import gemv_split, tiled_shapes

    assert list(inspect.signature(gemv_split).parameters) == ["nb", "groups", "n_sm"]
    din, dout = int4_projection_shapes(get_config("7b").llama)[proj]
    (_, nb, groups, _, _), _ = tiled_shapes(din, dout, 1)
    splits, per = gemv_split(nb, groups, 132)
    assert (splits - 1) * per < groups <= splits * per
    assert nb * splits >= min(2 * 132, nb * groups) // 2


# -- the rewound cache ---------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "xla", "decode"])
@pytest.mark.parametrize("quant", [False, True], ids=["kv", "kv8"])
def test_rows_past_the_accepted_prefix_are_never_read(params, quant, impl):
    """A T = 4 verify window at index 10 of which 2 tokens are accepted: the
    index goes back to 12 and rows 12, 13 are stale. With those rows (and
    their scales) overwritten by huge values, the next window and the next
    single step give bit-equal hidden states: the key mask and the block
    list are built from the rewound index, and the forward overwrites what
    it covers."""
    model = _port(params)
    d = CFG.llama.hidden_size
    emb = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 20, d)).astype(np.float32))
    mask = torch.ones((1, 24), dtype=torch.bool)
    mask[0, :2] = False  # a left pad

    def run(poison):
        cache = KVCache.create(CFG.llama, 1, 24, torch.float32, "cpu")
        with torch.no_grad():
            apply_llama(model.llama, CFG.llama, inputs_embeds=emb[:, :10], attn_mask=mask,
                        kv_cache=cache, attn_impl="xla")
            if quant:
                cache = quantize_kv_cache(cache)
            apply_llama(model.llama, CFG.llama, inputs_embeds=emb[:, 10:14], attn_mask=mask,
                        kv_cache=cache, attn_impl=impl)
            assert cache.index == 14
            cache.index = 12  # two of the four accepted
            if poison:
                for plane in (cache.k, cache.v):
                    plane[:, :, 12:] = 100 if quant else 1e4
                if quant:
                    cache.ks[..., 12:] = 1e4
                    cache.vs[..., 12:] = 1e4
            h1, _ = apply_llama(model.llama, CFG.llama, inputs_embeds=emb[:, 14:17],
                                attn_mask=mask, kv_cache=cache, attn_impl=impl)
            assert cache.index == 15
            cache.index = 13  # one accepted: row 13, 14 stale again
            h2, _ = apply_llama(model.llama, CFG.llama, inputs_embeds=emb[:, 17:18],
                                attn_mask=mask, kv_cache=cache, attn_impl=impl)
        return h1, h2

    (a1, a2), (b1, b2) = run(False), run(True)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert torch.isfinite(b1).all() and torch.isfinite(b2).all()
