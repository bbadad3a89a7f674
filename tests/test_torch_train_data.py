"""The port's training data (handsonvlm_torch/data/synthetic.py,
data/hybrid_dataset.py) against the JAX package's on the same numpy seed:
the synthetic samples' arrays and token ids are equal, the collator gives
equal batches (padding buckets, the sequence-parallel rounding with its
truncation, a single image repeated into the video), and the mixture's
sampling rates are normalised alike."""

import numpy as np
import pytest

from handsonvlm_tpu.core.config import tiny_config as jax_tiny_config
from handsonvlm_tpu.data import hybrid_dataset as jhd
from handsonvlm_tpu.data.mock_tokenizer import MockTokenizer as JaxMockTokenizer
from handsonvlm_tpu.data.synthetic import SyntheticConversationDataset as JaxSynthetic
from handsonvlm_torch.config import tiny_config
from handsonvlm_torch.data import hybrid_dataset as thd
from handsonvlm_torch.data.mock_tokenizer import MockTokenizer
from handsonvlm_torch.data.synthetic import SyntheticConversationDataset


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], (list, str)):
            assert list(np.atleast_1d(a[k])) == list(np.atleast_1d(b[k])), k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _samples(seed, n=3):
    np.random.seed(seed)
    want = [JaxSynthetic(JaxMockTokenizer(), jax_tiny_config(), n=4)[0] for _ in range(n)]
    np.random.seed(seed)
    got = [SyntheticConversationDataset(MockTokenizer(), tiny_config(), n=4)[0]
           for _ in range(n)]
    return got, want


def test_synthetic_samples_match_jax():
    got, want = _samples(123)
    for g, w in zip(got, want):
        _equal(g, w)
    size = tiny_config().vision.image_size
    assert got[0]["image"].shape == (tiny_config().num_frames, 3, size, size)


@pytest.mark.parametrize("kw", [
    {},
    {"pad_multiple": 16, "model_max_length": 96},
    {"seq_multiple": 4, "splice_extra": 5},
    {"seq_multiple": 8, "splice_extra": 3, "model_max_length": 60, "pad_multiple": 16},
], ids=["default", "bucket16", "seq_parallel", "seq_parallel_truncates"])
def test_collator_matches_jax(kw):
    got, want = _samples(7, n=2)
    frames = tiny_config().num_frames
    # non-EK samples: a single 224 px image each, no hoi keys
    single = [{"input_ids": got[i]["input_ids"][:9 + i], "labels": got[i]["labels"][:9 + i],
               "image": np.full((3, 224, 224), i, np.float32)} for i in range(2)]
    for port_batch, jax_batch in ((got, want), (single, single)):
        tb = thd.Collator(pad_token_id=0, num_frames=frames, **kw)([dict(s) for s in port_batch])
        jb = jhd.Collator(pad_token_id=0, num_frames=frames, **kw)([dict(s) for s in jax_batch])
        _equal(tb, jb)
        assert tb["image"].shape[1] == frames


def test_hybrid_dataset_rates_match_jax():
    groups = [[list(range(3)), list(range(5))], [list(range(2))]]
    t = thd.HybridDataset(task_datasets=groups, task_sample_rate=[3.0, 1.0],
                          samples_per_epoch=11)
    j = jhd.HybridDataset(task_datasets=groups, task_sample_rate=[3.0, 1.0],
                          samples_per_epoch=11)
    assert len(t) == len(j) == 11
    assert t.task_sample_rate == j.task_sample_rate == [0.75, 0.25]
    assert t.dataset_sample_rates == j.dataset_sample_rates
    assert t[0] in (0,)  # every group's datasets give their sample 0


# ---------------------------------------------------------------------------
# the --tasks mixture's draws: seeded per dataset, per item and per start step
# ---------------------------------------------------------------------------


def _ek_train_fixture(tmp_path, monkeypatch):
    """chip_smoke's EK100 layout with its train clip labeled (as
    tests/test_torch_train_cli.py's --tasks test writes it)."""
    import pickle

    import chip_smoke

    root = tmp_path / "ek"
    chip_smoke.write_ek_fixture(str(root), n_val=2)
    with open(root / "ek100" / "labels" / "label_0.pkl", "wb") as f:
        pickle.dump(chip_smoke._ek_video_info(np.random.default_rng(1)), f)
    (root / "assets" / "ek100_questions.json").write_text(
        (root / "assets" / "ek100_questions_val.json").read_text())
    monkeypatch.setenv("HANDSONVLM_DATA_ROOT", str(root))
    monkeypatch.setenv("HANDSONVLM_ASSETS_DIR", str(root / "assets"))


def test_task_mixture_draws_are_seeded_and_move_on_at_resume(tmp_path, monkeypatch):
    """The train CLI over `--tasks epic_kitchen||reasoning` (two datasets
    sharing one EPIC HOI dataset), batches of 4 on the loader's 8 threads:
    two fresh runs with one seed draw the same items (as multisets: the
    threads may hand them to a batch in another order), and a run resumed
    at step 2 draws items other than the fresh run's first ones (before the
    repair every run, and every resume, started the same stream from seed
    0)."""
    from handsonvlm_torch.train import train

    _ek_train_fixture(tmp_path, monkeypatch)
    batches = []
    collate = thd.Collator.__call__

    def recording(self, instances):
        batches.append(sorted(tuple(np.asarray(i["input_ids"]).tolist()) for i in instances))
        return collate(self, instances)

    monkeypatch.setattr(thd.Collator, "__call__", recording)

    def run(out, steps, seed=0):
        del batches[:]
        train.main(["--model-path", "random:tiny224", "--preset", "tiny224", "--device", "cpu",
                    "--tasks", "epic_kitchen||reasoning", "--output-dir", str(tmp_path / out),
                    "--batch-size", "4", "--samples-per-epoch", "8", "--max-steps",
                    str(steps), "--log-every", "1", "--seed",
                    str(seed)])
        return list(batches)

    fresh = run("a", 2)
    again = run("b", 2)
    resumed = run("a", 4)
    other_seed = run("c", 1, seed=1)
    assert len(fresh) == len(again) == len(resumed) == 2
    assert fresh == again
    assert resumed[0] != fresh[0]
    assert sorted(sum(resumed, [])) != sorted(sum(fresh, []))
    assert other_seed[0] != fresh[0]


def test_task_group_datasets_draw_their_own_indices(tmp_path):
    """Two LITA datasets of one group, seeded by `seed_mixture`, draw
    different item-index sequences (before the repair both fell back to
    `default_rng(0)` and drew one sequence), each the same again under the
    same seed, and another one from another start step."""
    import json

    from PIL import Image

    from handsonvlm_torch.data.draws import seed_mixture
    from handsonvlm_torch.data.lita_datasets import (
        DVCDataset_activitynet,
        EventLocDataset_activitynet,
    )

    train = {}
    for v in range(8):
        vid = f"v_{v + 1:03d}"
        frames = tmp_path / "activitynet-captions" / "activitynet_frames" / vid
        frames.mkdir(parents=True)
        for i in range(2):
            Image.new("RGB", (32, 24), (i * 10, v * 20, 0)).save(frames / f"f{i:04d}.jpg")
        train[vid] = {"duration": 60.0 + v, "timestamps": [[0.0, 10.0], [30.0, 60.0]],
                      "sentences": ["A person opens a fridge.", "They cook a meal."]}
    (tmp_path / "activitynet-captions" / "train.json").write_text(json.dumps(train))

    def indices(seed, step, n=12):
        group = [cls(str(tmp_path), MockTokenizer(), load_images=False)
                 for cls in (DVCDataset_activitynet, EventLocDataset_activitynet)]
        drawn = []
        for ds in group:
            seen = []
            sources = ds.get_sources

            def record(i, seen=seen, sources=sources):
                seen.append(i)
                return sources(i)

            ds.get_sources = record
            drawn.append(seen)
        (seeded,), _ = seed_mixture([group], seed, step)
        for ds in seeded:
            for _ in range(n):
                ds[0]
        return drawn

    first = indices(0, 0)
    assert first[0] != first[1]
    assert indices(0, 0) == first
    assert indices(0, 5)[0] != first[0]
