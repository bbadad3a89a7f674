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
