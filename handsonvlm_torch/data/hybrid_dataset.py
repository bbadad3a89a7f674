"""Task-sampled hybrid training mixture + fixed-shape collator.

Port of `handsonvlm_tpu/data/hybrid_dataset.py` (numpy: the same draws and
the same arrays). Behavioral spec from
`handsonvlm/dataset/hybrid_dataset.py:20-169`:
- epoch = `samples_per_epoch` draws; each draw picks a task by
  task_sample_rate, then a dataset within the task, then a random sample;
- the collator zero-fills the hoi keys for non-EK samples and pads
  input_ids with pad / labels with IGNORE_INDEX.

Kept from the JAX package: input_ids/labels pad to bucketed lengths
(multiples of `pad_multiple`), so a step's shapes come from a few sizes;
`seq_multiple` / `splice_extra` pad the spliced length to a multiple of the
sequence-parallel degree (1 until parallelism is ported).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from handsonvlm_torch.constants import IGNORE_INDEX
from handsonvlm_torch.data.draws import ItemSeeds


@dataclasses.dataclass
class HybridDataset:
    """Mixture over task groups. Each entry of `task_datasets` is a list of
    datasets for one task; `task_sample_rate` weights the tasks and
    `dataset_sample_rates[i]` weights datasets inside task i (defaults to
    dataset sizes, like the reference)."""

    task_datasets: List[List]
    task_sample_rate: List[float]
    samples_per_epoch: int = 48296  # reference epoch size (BASELINE.md)
    dataset_sample_rates: Optional[List[List[float]]] = None
    # the task draws' seed (data/draws.seed_mixture); None takes fresh
    # entropy, so runs differ as the reference's do
    seed: Optional[np.random.SeedSequence] = None

    def __post_init__(self):
        self._seeds = ItemSeeds(self.seed if self.seed is not None
                                else np.random.SeedSequence())
        s = sum(self.task_sample_rate)
        self.task_sample_rate = [x / s for x in self.task_sample_rate]
        assert len(self.task_sample_rate) == len(self.task_datasets)
        if self.dataset_sample_rates is None:
            self.dataset_sample_rates = [
                [len(d) for d in group] for group in self.task_datasets
            ]
        self.dataset_sample_rates = [
            [x / sum(group) for x in group] for group in self.dataset_sample_rates
        ]

    def __len__(self) -> int:
        return self.samples_per_epoch

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng(self._seeds.next_sequence())
        task = rng.choice(len(self.task_datasets), p=self.task_sample_rate)
        ds = rng.choice(len(self.task_datasets[task]), p=self.dataset_sample_rates[task])
        # datasets draw their own random index internally (idx 0 by contract)
        return self.task_datasets[task][ds][0]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class Collator:
    """numpy collator producing the fixed-shape training batch."""

    pad_token_id: int = 0
    model_max_length: int = 2048
    pad_multiple: int = 64
    num_frames: int = 100
    # sequence-parallel support: pad so the SPLICED length (text +
    # splice_extra visual tokens) divides seq_multiple — ring attention
    # (train --seq-parallel) falls back to unsharded attention otherwise
    seq_multiple: int = 1
    splice_extra: int = 0
    _warned_truncation: bool = dataclasses.field(
        default=False, repr=False, compare=False)

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        b = len(instances)
        for inst in instances:
            inst.setdefault("feat", np.zeros((5, 10, 1024), np.float32))
            inst.setdefault("bbox_feat", np.zeros((4, 10, 4), np.float32))
            inst.setdefault("valid_mask", np.zeros((5, 10), np.float32))
            inst.setdefault("future_hands", np.zeros((2, 5, 2), np.float32))
            inst.setdefault("contact_point", np.zeros((2,), np.float32))
            inst.setdefault("future_valid", np.zeros((2,), np.float32))
            inst.setdefault("gt_label_valid", np.asarray(False))
            inst.setdefault("prompt", "")
            img = inst["image"]
            if img.shape == (3, 224, 224):  # single image -> repeat to video
                img = np.tile(img[None], (self.num_frames, 1, 1, 1))
                inst["image"] = img
            assert inst["image"].shape[0] == self.num_frames, inst["image"].shape

        longest = max(len(i["input_ids"]) for i in instances)
        max_len = min(_round_up(longest, self.pad_multiple), self.model_max_length)
        if self.seq_multiple > 1:
            pad = (-(max_len + self.splice_extra)) % self.seq_multiple
            if max_len + pad <= self.model_max_length:
                max_len += pad
            else:  # round down instead of exceeding the length budget
                max_len -= self.seq_multiple - pad
                if longest > max_len and not self._warned_truncation:
                    self._warned_truncation = True
                    logging.getLogger(__name__).warning(
                        "seq-parallel collator truncating %d-token sequence "
                        "to %d (model_max_length=%d is not a multiple of "
                        "seq_multiple=%d after splice_extra=%d); trailing "
                        "tokens/labels are dropped for max-length rows",
                        longest, max_len, self.model_max_length,
                        self.seq_multiple, self.splice_extra,
                    )

        input_ids = np.full((b, max_len), self.pad_token_id, np.int64)
        labels = np.full((b, max_len), IGNORE_INDEX, np.int64)
        for i, inst in enumerate(instances):
            ids = np.asarray(inst["input_ids"])[: max_len]
            lab = np.asarray(inst["labels"])[: max_len]
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lab)] = lab

        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attn_mask": input_ids != self.pad_token_id,
            "prompt": [i["prompt"] for i in instances],
        }
        for key in (
            "feat", "bbox_feat", "valid_mask", "future_hands",
            "contact_point", "future_valid", "gt_label_valid", "image",
        ):
            batch[key] = np.stack([np.asarray(i[key], np.float32) for i in instances])
        return batch
