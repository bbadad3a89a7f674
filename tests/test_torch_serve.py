"""The port's serving slice against the JAX package's, at the tiny preset.

- B8: `gather_cache_blocks_ref` equals the Pallas kernel (interpret mode)
  bit for bit on both kinds of plane, and the host planners equal JAX's.
- B1/B6's plain versions on fragmented masks (holes of whole blocks, rows
  with different block counts) against the Pallas kernels in interpret
  mode, fp32, max abs 1e-5.
- `ContinuousEngine` greedy against the JAX engine (weights through
  `from_jax_params`, the CVAE latents JAX draws injected through `z_fn`):
  a solo join, a staggered join and a group join give the same tokens, and
  every step's waypoint agrees to 1e-5, over the bf16/fp32 cache and the
  int8 cache.
- Compaction keeps a live stream bit-equal, an idle engine resets its
  cursor, and a staggered soak truncates nothing.
- `ContinuousScheduler`: solo parity with streaming, queueing and
  oversize refusal, cursor exhaustion, grouped admission, group-join
  failure, the SLO estimator and shedding, and the admission hold counted
  in the TTFT estimate.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handsonvlm_tpu.constants import IMAGE_TOKEN_INDEX
from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.models.handsonvlm import init_handsonvlm
from handsonvlm_tpu.ops import cache_ops as jcache
from handsonvlm_tpu.ops.decode_attention import (
    decode_attention_stacked as jax_decode_attention_stacked,
    decode_attention_stacked_q as jax_decode_attention_stacked_q,
)
from handsonvlm_tpu.serve.continuous import ContinuousEngine as JaxEngine
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.convert.from_hf import from_jax_params, load_state_dict_into
from handsonvlm_torch.infer.builder import build_model
from handsonvlm_torch.ops import cache_ops
from handsonvlm_torch.ops.decode_attention import (
    block_list,
    decode_attention_stacked,
    decode_attention_stacked_q,
    decode_attention_stacked_q_ref,
    decode_attention_stacked_ref,
)
from handsonvlm_torch.serve.continuous import ContinuousEngine
from handsonvlm_torch.serve.scheduler import ContinuousScheduler, SLORejected

from test_torch_kernels import fragmented_mask, left_moving_table, quantize_cache

JCFG = jax_tiny_config()
CFG = tiny_config()
ENGINE_KW = dict(max_len=512, chunk=4)


def _port(params):
    m = build_model(CFG, "cpu")
    load_state_dict_into(m, from_jax_params(params))
    return m


@pytest.fixture(scope="module")
def jraw():
    return jax.jit(lambda k: init_handsonvlm(k, JCFG))(jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def jparams(jraw):
    """JAX tiny weights with the head's <hand_traj> column set to -2.0, so
    hand tokens (and their waypoints fed back) come up about every other
    step among the random head's own tokens."""
    w = np.array(jraw["llama"]["lm_head"]["weight"])
    w[:, JCFG.hand_token_id] = -2.0
    return dict(jraw, llama=dict(jraw["llama"], lm_head={"weight": jnp.asarray(w)}))


@pytest.fixture(scope="module")
def model(jparams):
    """The rigged weights: the engine against the JAX engine, compaction."""
    return _port(jparams)


@pytest.fixture(scope="module")
def plain(jraw):
    """The weights as initialised, for runs compared across batch
    compositions (the scheduler against solo runs, as the JAX package's
    tests do): a row's keys sit at other cache offsets there, so its sums
    round differently, and waypoints fed back through hand tokens amplify
    that from step to step."""
    return _port(jraw)


def _prompt(seed, n=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(1, n))
    ids[0, 1] = IMAGE_TOKEN_INDEX
    images = rng.normal(size=(1, CFG.num_frames, 3, CFG.vision.image_size,
                              CFG.vision.image_size)).astype(np.float32)
    return ids, images


# -- B8 and the planners --------------------------------------------------------


@pytest.mark.parametrize("seq_axis", [2, 3])
def test_gather_blocks_ref_matches_pallas(seq_axis):
    ell, b, s, kh, d, bk = 3, 2, 64, 2, 8, 16
    rng = np.random.default_rng(seq_axis)
    shape = (ell, b, s, kh, d) if seq_axis == 2 else (ell, b, kh, s)
    c = rng.normal(size=shape).astype(np.float32)
    table = left_moving_table(rng, b, s // bk)
    want = np.asarray(jcache.gather_cache_blocks(jnp.asarray(c), jnp.asarray(table),
                                                 block_k=bk, seq_axis=seq_axis))
    got = cache_ops.gather_cache_blocks(torch.from_numpy(c.copy()), table, block_k=bk,
                                        seq_axis=seq_axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_gather_blocks_ref_in_place_any_dtype(dtype):
    """In place on the caller's plane, for the cache's other dtypes: every
    destination block holds its source block's old bytes."""
    ell, b, s, kh, d, bk = 2, 3, 128, 2, 4, 32
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.integers(-100, 100, size=(ell, b, s, kh, d))).to(dtype)
    old = c.clone()
    table = left_moving_table(rng, b, s // bk)
    out = cache_ops.gather_cache_blocks(c, table, block_k=bk)
    assert out is c
    for r in range(b):
        for j, src in enumerate(table[r]):
            assert torch.equal(c[:, r, j * bk:(j + 1) * bk], old[:, r, src * bk:(src + 1) * bk])


def test_gather_blocks_refuses_right_moving_table():
    c = torch.zeros((1, 1, 64, 1, 4))
    with pytest.raises(ValueError, match="left-moving"):
        cache_ops.gather_cache_blocks(c, np.array([[0, 0, 2, 3]]), block_k=16)


def test_planners_match_jax():
    bk, nk, s = 16, 8, 128
    rng = np.random.default_rng(1)
    for _ in range(20):
        pos = int(rng.integers(1, s + 1))
        mask = rng.random(s) < 0.4
        mask[pos:] = False
        h_max = jcache.count_removable_blocks(mask, pos, bk)
        assert cache_ops.count_removable_blocks(mask, pos, bk) == h_max
        for h in {0, h_max // 2, h_max}:
            table, new_mask = cache_ops.build_row_table(mask, pos, bk, nk, h)
            jtable, jmask = jcache.build_row_table(mask, pos, bk, nk, h)
            np.testing.assert_array_equal(table, jtable)
            np.testing.assert_array_equal(new_mask, jmask)
            assert (table >= np.arange(nk)).all()


# -- B1/B6 over fragmented masks --------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tw", [1, 4])
def test_decode_attention_ref_fragmented_matches_pallas(quant, tw):
    L, B, S, H, K, D, layer, length = 2, 3, 1024, 4, 2, 16, 1, 1000
    rng = np.random.default_rng(tw + 2 * quant)
    q = rng.normal(size=(B, tw, H, D)).astype(np.float32)
    ck = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    cv = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    mask = fragmented_mask(B, S, length)
    tq, tmask = torch.from_numpy(q), torch.from_numpy(mask)
    if quant:
        k8, v8, ks, vs = quantize_cache(torch.from_numpy(ck), torch.from_numpy(cv))
        got = decode_attention_stacked_q_ref(tq, k8, v8, ks, vs, layer, length, key_mask=tmask)
        want = jax_decode_attention_stacked_q(
            jnp.asarray(q), *(jnp.asarray(x.numpy()) for x in (k8, v8, ks, vs)), layer, length,
            key_mask=jnp.asarray(mask))
    else:
        got = decode_attention_stacked_ref(tq, torch.from_numpy(ck), torch.from_numpy(cv),
                                           layer, length, key_mask=tmask)
        want = jax_decode_attention_stacked(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                            layer, length, key_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_block_list_lists_valid_blocks_in_order():
    B, S, length = 3, 1024, 1000
    mask = fragmented_mask(B, S, length)
    bl = block_list(torch.from_numpy(mask), length, B, S, "cpu")
    assert bl.block_k == 256
    for r in range(B):
        want = [j for j in range(S // 256)
                if mask[r, j * 256:(j + 1) * 256].any() and j * 256 < length]
        n = int(bl.counts[r])
        assert bl.table[r, :n].tolist() == want
        assert bl.table[r, n:].tolist() == [want[-1] if want else 0] * (S // 256 - n)


def test_decode_attention_bit_equal_across_block_shift():
    """A row's output over the same listed blocks moved to lower block
    indices (what compaction does) is bit-equal, whatever the other rows
    hold."""
    L, B, S, H, K, D, bk = 1, 2, 1024, 4, 2, 16, 256
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    ck = torch.from_numpy(rng.normal(size=(L, B, S, K, D)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(L, B, S, K, D)).astype(np.float32))
    mask = np.zeros((B, S), bool)
    mask[0, 300:700] = True  # row 0: blocks 1 and 2
    mask[0, 900:990] = True  # ... and 3
    mask[1, :990] = True  # row 1: every block
    out = decode_attention_stacked(q, ck, cv, 0, 990, key_mask=torch.from_numpy(mask))
    table = np.array([[1, 2, 3, 3], [0, 1, 2, 3]])
    cache_ops.gather_cache_blocks(ck, table, block_k=bk)
    cache_ops.gather_cache_blocks(cv, table, block_k=bk)
    moved = np.zeros_like(mask)
    moved[0, 300 - bk:990 - bk] = mask[0, 300:990]
    moved[1] = False  # a finished row's plane is emptied
    got = decode_attention_stacked(q, ck, cv, 0, 990 - bk, key_mask=torch.from_numpy(moved))
    assert torch.equal(got[0], out[0])


@pytest.mark.parametrize("quant", [False, True], ids=["kv", "kv8"])
def test_decode_attention_plain_row_ignores_where_its_keys_sit(quant):
    """The plain stacked decode attention gives a row the same bits wherever
    its keys sit in the cache (a request joined at cursor 0 alone, or at
    another cursor beside others, straddling a 256-key block), with or
    without a hole between its prompt and its decoded keys: it reduces over
    the row's valid keys alone, in order. Before, the sums ran over whole
    gathered blocks and a shifted row rounded differently, so a sampled
    stream could depart from its solo run by one token."""
    S, H, K, D, n = 512, 4, 2, 16, 45
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(rng.normal(size=(n, K, D)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(n, K, D)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(2, 2, H, D)).astype(np.float32))
    outs = []
    for off, hole in ((0, 0), (3, 0), (200, 0), (250, 7), (100, 90)):
        ck, cv = torch.zeros((1, 2, S, K, D)), torch.zeros((1, 2, S, K, D))
        pos = off + np.arange(n) + np.where(np.arange(n) >= 30, hole, 0)
        mask = np.zeros((2, S), bool)
        mask[:, pos] = True
        ck[0, :, pos], cv[0, :, pos] = keys, vals
        length = int(pos[-1]) + 1
        tmask = torch.from_numpy(mask)
        if quant:
            k8, v8, ks, vs = quantize_cache(ck, cv)
            outs.append(decode_attention_stacked_q(q, k8, v8, ks, vs, 0, length, key_mask=tmask))
        else:
            outs.append(decode_attention_stacked(q, ck, cv, 0, length, key_mask=tmask))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


# -- the engine against the JAX engine ----------------------------------------


class _JaxLatents:
    """The CVAE latent the JAX engine draws for (request seed, step):
    z_scale * normal(split(fold_in(PRNGKey(seed), step))[1], (2, latent))."""

    def __init__(self):
        self.cache = {}

    def __call__(self, seed, step):
        if (seed, step) not in self.cache:
            key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))[1]
            self.cache[(seed, step)] = np.asarray(
                JCFG.traj.z_scale * jax.random.normal(key, (2, JCFG.traj.latent_dim)))
        return self.cache[(seed, step)]


def _capture(eng):
    """Record every finished slot's per-step waypoints, by seed."""
    wps = {}
    finalize = eng._finalize

    def wrapped(slot):
        wps[slot.seed] = np.stack(slot.wps)
        return finalize(slot)

    eng._finalize = wrapped
    return wps


def _drive(eng, reqs):
    """A solo join, one chunk, a staggered join, one chunk, a group join of
    the rest, then chunks until every request is done. Returns {seed:
    SampleOutput}."""
    slots, outs = {}, {}

    def collect(done):
        for r, out in done:
            outs[slots[r]] = out

    for (ids, im), seed, mn in reqs[:2]:
        slots[eng.join(ids, im, seed=seed, max_new=mn)] = seed
        collect(eng.step())
    rows = eng.join_many([dict(input_ids=ids, images=im, seed=seed, max_new=mn)
                          for (ids, im), seed, mn in reqs[2:]])
    for r, (_, seed, _) in zip(rows, reqs[2:]):
        slots[r] = seed
    while len(outs) < len(reqs):
        collect(eng.step())
    return outs


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_matches_jax_engine(jparams, model, kv_quant):
    """The port's engine driven through staggered and group joins against
    the JAX engine running each request alone (greedy, the JAX latents):
    the same tokens, waypoints within 1e-5. The JAX engine's own staggered
    run is not the reference: it moves a live row's rotary positions by the
    bucket at every later join (test_jax_engine_moves_live_positions_at_a_join),
    which a solo run never sees."""
    reqs = [(_prompt(1, 10), 11, 8), (_prompt(2, 8), 22, 8), (_prompt(3, 9), 33, 8),
            (_prompt(4, 12), 44, 8)]
    kw = dict(slots=4, temperature=0.0, kv_quant=kv_quant, **ENGINE_KW)
    jeng = JaxEngine(jparams, JCFG, attn_impl="xla", **kw)
    teng = ContinuousEngine(model, CFG, z_fn=_JaxLatents(), **kw)
    jwps, twps = _capture(jeng), _capture(teng)
    want = {}
    for (ids, im), seed, mn in reqs:  # each alone: the only finished row is seed's
        jeng.join(ids, im, seed=seed, max_new=mn)
        while seed not in want:
            want.update((seed, out) for _, out in jeng.step())
    got = _drive(teng, reqs)
    assert teng.join_group_sizes == [2]
    hands = 0
    for _, seed, _ in reqs:
        n = int(want[seed].num_tokens[0])
        assert int(got[seed].num_tokens[0]) == n == 8
        np.testing.assert_array_equal(got[seed].sequences[0, :n],
                                      np.asarray(want[seed].sequences)[0, :n])
        np.testing.assert_allclose(twps[seed], jwps[seed], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[seed].pred_hands, want[seed].pred_hands, atol=1e-5,
                                   rtol=0)
        hands += int(got[seed].num_hands[0])
    assert hands > 0  # the rigged head made the hand hook run


def test_jax_engine_moves_live_positions_at_a_join(jparams, model):
    """Why the JAX engine's staggered run is not the port's reference: its
    join jumps the shared cursor past the new bucket and leaves the live
    rows' starts, so a live row's rotary position (cursor - start) jumps by
    the bucket; the port moves the live rows' starts with the cursor, so
    their positions run on by one a token, as in a solo decode."""
    kw = dict(slots=2, temperature=0.0, **ENGINE_KW)
    jeng = JaxEngine(jparams, JCFG, attn_impl="xla", **kw)
    teng = ContinuousEngine(model, CFG, **kw)
    pos = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        row = eng.join(*_prompt(1, 10), seed=11, max_new=12)
        eng.step()
        before = int(np.asarray(eng.cache.index)) - int(np.asarray(eng.starts)[row])
        eng.join(*_prompt(2, 8), seed=22, max_new=12)
        after = int(np.asarray(eng.cache.index)) - int(np.asarray(eng.starts)[row])
        pos[name] = (before, after)
    bucket = teng._bucket(10)
    assert pos["port"][1] == pos["port"][0]
    assert pos["jax"] == (pos["port"][0], pos["port"][0] + bucket)


# -- compaction ---------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_compact_bit_equal_stream(model, kv_quant):
    """Finish one request (a dead bucket at the front), join another
    behind it, compact mid-generation in engine A only: the surviving
    request's tokens and every waypoint are bit-equal in A and B."""
    (ids0, im0), (ids1, im1) = _prompt(1, n=120), _prompt(2, n=110)

    def drive(do_compact):
        eng = ContinuousEngine(model, CFG, slots=2, max_len=1024, chunk=4, temperature=0.5,
                               kv_quant=kv_quant)
        wps = _capture(eng)
        eng.join(ids0, im0, seed=11, max_new=6)
        eng.step()
        eng.join(ids1, im1, seed=22, max_new=18)  # its bucket lands behind 0's
        while eng.slots[0].busy:
            eng.step()
        assert eng.slots[1].busy, "request 1 must still be mid-generation"
        pos_dead = eng.pos
        if do_compact:
            assert eng.compact() > 0
            assert eng.pos < pos_dead and eng.compactions == 1
        outs = []
        while not outs:
            outs += [o for _, o in eng.step()]
        return outs[0], wps[22]

    (a, wa), (b, wb) = drive(True), drive(False)
    np.testing.assert_array_equal(a.sequences, b.sequences)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(a.pred_hands, b.pred_hands)


def test_compact_idle_resets_cursor(model):
    eng = ContinuousEngine(model, CFG, slots=1, temperature=0.0, **ENGINE_KW)
    eng.join(*_prompt(3), seed=5, max_new=3)
    while not eng.idle():
        eng.step()
    pos = eng.pos
    assert pos > 0
    # an idle engine reclaims the whole cursor without a cache rewrite
    assert eng.compact() == pos
    assert eng.pos == 0 and eng.compactions == 0


def test_soak_staggered_no_truncation(model):
    """50 staggered requests through a small cache: every generation ends
    at EOS or max_new, and compaction ran at least once. max_new cycles
    4 / 8 / 12, so long rows outlive the short rows joined beside them and
    leave dead buckets in front of live ones."""
    n_req = 50
    sched = ContinuousScheduler(model, CFG, slots=2, max_len=1024, chunk=4, temperature=0.7)
    outs, errs = {}, {}

    def one(i):
        try:
            outs[i] = sched.submit(*_prompt(100 + i, n=106 + (i % 5)), seed=i,
                                   max_new=4 * (1 + i % 3), timeout=600)
        except Exception as e:  # noqa: BLE001
            errs[i] = repr(e)

    threads = []
    for i in range(n_req):
        threads.append(threading.Thread(target=one, args=(i,)))
        threads[-1].start()
        time.sleep(0.01)
    for t in threads:
        t.join()
    sched.stop()
    assert not errs, errs
    for i, out in outs.items():
        n = int(out.num_tokens[0])
        assert n == 4 * (1 + i % 3) or int(out.sequences[0, n - 1]) == sched.engine.eos, i
    assert sched.engine.compactions >= 1


# -- the scheduler ----------------------------------------------------------------


def _solo(plain, ids, images, seed, max_new, temperature, top_p=0.9):
    eng = ContinuousEngine(plain, CFG, slots=1, **ENGINE_KW)
    eng.join(ids, images, seed=seed, max_new=max_new, temperature=temperature, top_p=top_p)
    while True:
        done = eng.step()
        if done:
            return done[0][1]


def _gate(monkeypatch):
    """Hold the loop thread's admission until the returned event is set."""
    gate = threading.Event()
    orig = ContinuousScheduler._admit

    def gated(self):
        gate.wait(timeout=120)
        orig(self)

    monkeypatch.setattr(ContinuousScheduler, "_admit", gated)
    return gate


def test_concurrent_heterogeneous_parity_and_streaming(plain):
    sched = ContinuousScheduler(plain, CFG, slots=2, **ENGINE_KW)
    reqs = [(3, 0.0), (4, 0.7), (5, 0.5)]  # greedy shares the batch with sampled
    streamed, outs, errs = {}, {}, {}

    def run(i, seed, temp):
        chunks = []
        try:
            outs[i] = sched.submit(*_prompt(seed), seed=seed, max_new=10, temperature=temp,
                                   on_tokens=chunks.append, timeout=600)
            streamed[i] = [t for c in chunks for t in c]
        except Exception as e:  # noqa: BLE001
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i, s, t)) for i, (s, t) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sched.stop()
    assert not errs, errs
    for i, (seed, temp) in enumerate(reqs):
        ref = _solo(plain, *_prompt(seed), seed, 10, temp)
        n = int(ref.num_tokens[0])
        assert int(outs[i].num_tokens[0]) == n
        np.testing.assert_array_equal(outs[i].sequences[0, :n], ref.sequences[0, :n])
        np.testing.assert_allclose(outs[i].pred_hands, ref.pred_hands, atol=1e-6)
        assert streamed[i] == [int(x) for x in ref.sequences[0, :n]]


def test_queueing_beyond_slots_and_oversize_rejection(plain):
    sched = ContinuousScheduler(plain, CFG, slots=1, **ENGINE_KW)
    try:
        outs = {}

        def run(i):
            outs[i] = sched.submit(*_prompt(10 + i), seed=10 + i, max_new=6, temperature=0.0,
                                   timeout=600)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert sorted(outs) == [0, 1, 2]
        for i in range(3):
            ref = _solo(plain, *_prompt(10 + i), 10 + i, 6, 0.0)
            n = int(ref.num_tokens[0])
            np.testing.assert_array_equal(outs[i].sequences[0, :n], ref.sequences[0, :n])
        big = np.random.default_rng(0).integers(3, 1000, size=(1, 600))
        big[0, 1] = IMAGE_TOKEN_INDEX
        with pytest.raises(RuntimeError, match="exceeds engine capacity"):
            sched.submit(big, _prompt(0)[1], seed=1, max_new=4, timeout=600)
    finally:
        sched.stop()


def test_cursor_exhaustion_truncates_not_deadlocks(plain):
    # bucket(10-token prompt) = 128; max_len 144 leaves two 8-token chunks
    sched = ContinuousScheduler(plain, CFG, slots=1, max_len=144, chunk=8)
    try:
        out = sched.submit(*_prompt(0), seed=9, max_new=32, temperature=0.0, timeout=600)
        assert 1 <= int(out.num_tokens[0]) <= 17  # truncated by drain, not max_new
    finally:
        sched.stop()


def test_grouped_admission_parity(plain, monkeypatch):
    """Four same-shape submits against an idle engine are admitted as ONE
    group join, and each matches its solo run."""
    gate = _gate(monkeypatch)
    sched = ContinuousScheduler(plain, CFG, slots=4, **ENGINE_KW)
    reqs = [(31, 0.5), (32, 0.0), (33, 0.7), (34, 0.5)]
    prompts = {seed: _prompt(seed, n=8 + i) for i, (seed, _) in enumerate(reqs)}
    outs, errs = {}, {}

    def run(seed, temp):
        try:
            outs[seed] = sched.submit(*prompts[seed], seed=seed, max_new=8, temperature=temp,
                                      timeout=120)
        except Exception as e:  # noqa: BLE001
            errs[seed] = repr(e)

    threads = [threading.Thread(target=run, args=r) for r in reqs]
    for t in threads:
        t.start()
    with sched._cv:
        assert sched._cv.wait_for(lambda: len(sched._pending) == 4, timeout=60)
    gate.set()
    for t in threads:
        t.join(timeout=120)
    sched.stop()
    assert not errs, errs
    assert 4 in sched.engine.join_group_sizes, sched.engine.join_group_sizes
    for seed, temp in reqs:
        ref = _solo(plain, *prompts[seed], seed=seed, max_new=8, temperature=temp)
        n = int(ref.num_tokens[0])
        assert int(outs[seed].num_tokens[0]) == n
        np.testing.assert_array_equal(outs[seed].sequences[0, :n], ref.sequences[0, :n])
        np.testing.assert_allclose(outs[seed].pred_hands, ref.pred_hands, atol=1e-6)


def test_group_join_failure_degrades_to_solo(plain, monkeypatch):
    gate = _gate(monkeypatch)
    sched = ContinuousScheduler(plain, CFG, slots=4, **ENGINE_KW)
    eng = sched.engine
    orig = eng.join_many
    fails = {"n": 0}

    def flaky(requests):
        if len(requests) > 1:
            fails["n"] += 1
            raise RuntimeError("synthetic group-join failure")
        return orig(requests)

    monkeypatch.setattr(eng, "join_many", flaky)
    outs, errs = {}, {}

    def run(seed):
        try:
            outs[seed] = sched.submit(*_prompt(seed), seed=seed, max_new=6, temperature=0.0,
                                      timeout=120)
        except Exception as e:  # noqa: BLE001
            errs[seed] = repr(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in (51, 52, 53, 54)]
    for t in threads:
        t.start()
    with sched._cv:
        assert sched._cv.wait_for(lambda: len(sched._pending) == 4, timeout=60)
    gate.set()
    for t in threads:
        t.join(timeout=120)
    sched.stop()
    assert not errs, errs
    assert len(outs) == 4 and fails["n"] >= 1
    assert sched.max_join_group == 1  # 4 -> 2 -> 1


def test_slo_estimator_steps():
    est = ContinuousScheduler._estimate_steps
    assert est(2, [], []) == 0
    assert est(0, [5], []) == 5
    assert est(0, [5, 2], []) == 2
    assert est(1, [5], [3]) == 3
    assert est(1, [], [3, 4]) == 7
    assert est(1, [2], [3, 3]) == 3
    assert est(0, [], []) is None


def test_slo_probe_admission_recovers_poisoned_estimate(plain):
    sched = ContinuousScheduler(plain, CFG, slots=1, **ENGINE_KW)
    try:
        ids, images = _prompt(0)
        sched._step_s = sched._join_s = 500.0  # an estimate far above any SLO
        for _ in range(8):
            with pytest.raises(SLORejected, match="exceeds SLO"):
                sched.submit(ids, images, seed=2, max_new=4, temperature=0.0, timeout=600,
                             ttft_slo=0.5)
        assert sched.slo_rejections == 8
        out = sched.submit(ids, images, seed=3, max_new=4, temperature=0.0, timeout=600,
                           ttft_slo=0.5)  # the probe
        assert int(out.num_tokens[0]) >= 1
    finally:
        sched.stop()


def test_slo_rejects_when_saturated_and_admits_when_loose(plain):
    sched = ContinuousScheduler(plain, CFG, slots=1, **ENGINE_KW)
    try:
        ids, images = _prompt(0)
        done = {}
        # warm the estimator: the first join and step are not measured
        sched.submit(ids, images, seed=1, max_new=4, temperature=0.0, timeout=600)

        def run_long():
            done["out"] = sched.submit(ids, images, seed=7, max_new=60, temperature=0.0,
                                       timeout=600)

        th = threading.Thread(target=run_long)
        th.start()
        deadline = time.time() + 300
        while time.time() < deadline and (sched._step_s is None or sched._join_s is None
                                          or not sched._live):
            time.sleep(0.01)
        assert sched._step_s is not None and sched._live
        with pytest.raises(SLORejected, match="exceeds SLO"):
            sched.submit(ids, images, seed=8, max_new=4, temperature=0.0, timeout=600,
                         ttft_slo=1e-9)
        assert sched.slo_rejections == 1
        out2 = sched.submit(ids, images, seed=8, max_new=4, temperature=0.0, timeout=600,
                            ttft_slo=1e6)
        assert int(out2.num_tokens[0]) >= 1
        th.join(timeout=600)
        assert "out" in done
    finally:
        sched.stop()


def test_estimate_ttft_counts_admission_hold_when_idle(plain):
    """An idle engine holds admission for admit_hold_s before it joins a
    request, so the estimate includes the hold; with rows decoding there is
    no hold."""
    sched = ContinuousScheduler(plain, CFG, slots=2, admit_hold_s=0.25, **ENGINE_KW)
    try:
        sched._step_s, sched._join_s = 0.01, 0.02
        with sched._cv:
            assert sched.estimate_ttft() == pytest.approx(0.25 + 0.02)
        sched.admit_hold_s = 0.0
        with sched._cv:
            assert sched.estimate_ttft() == pytest.approx(0.02)
        sched.admit_hold_s = 0.25
        sched.engine.slots[0].busy = True  # a live row: no hold
        sched.engine.slots[0].tokens, sched.engine.slots[0].max_new = [1], 9
        with sched._cv:
            assert sched.estimate_ttft() == pytest.approx(0.02)
        sched.engine.slots[0].busy = False
    finally:
        sched.stop()


def test_loop_error_fails_waiters_and_reports_dead(plain, monkeypatch):
    """An engine error on the loop thread fails the waiting request, and
    the scheduler then reports itself dead and refuses new requests (the
    evaluator rebuilds such a scheduler)."""
    sched = ContinuousScheduler(plain, CFG, slots=1, **ENGINE_KW)

    def boom(self):
        raise KeyError("synthetic engine fault")

    monkeypatch.setattr(ContinuousScheduler, "_step_once", boom)
    with pytest.raises(RuntimeError, match="scheduler loop error"):
        sched.submit(*_prompt(0), seed=1, max_new=4, timeout=60)
    sched._thread.join(timeout=30)
    assert not sched.alive()
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(*_prompt(0), seed=1, max_new=4, timeout=60)
