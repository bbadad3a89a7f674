"""Synthetic EK-shaped conversation samples (smoke training without data).

Port of `handsonvlm_tpu/data/synthetic.py`: the exact sample schema of the
EK conversation datasets (input_ids, labels, an image of the config's
(num_frames, 3, H, W), hoi features, future hands) with random content, so
the whole training CLI (loader, collator, train step, checkpoints,
artifacts) runs anywhere. The draws are the JAX package's: each sample
seeds a numpy generator from numpy's global state, so the same global seed
gives the same arrays in both packages; an item the loader makes under a
key (`data/draws.keyed`: its step and place in the global batch) seeds it
from (`seed`, key) instead, so every rank and every run draws the same
batches.
"""

from __future__ import annotations

import copy

import numpy as np

from handsonvlm_torch.config import HandsOnVLMConfig
from handsonvlm_torch.constants import (
    ACTION_QUESTION_TEMPLATES,
    DEFAULT_IMAGE_TOKEN,
    GENERAL_TRAJECTORY_ANSWER_TEMPLATES,
    HAND_TOKEN_TEMPLATE,
)
from handsonvlm_torch.data.draws import item_key
from handsonvlm_torch.data.tokenization import preprocess_multimodal, preprocess_v1

_NOUNS = ["fridge", "pan", "cupboard", "kettle", "tap", "plate", "knife", "onion"]
_VERBS = ["open", "close", "wash", "cut", "take", "put down", "turn on", "stir"]


class SyntheticConversationDataset:
    def __init__(self, tokenizer, cfg: HandsOnVLMConfig, n: int = 256, seed: int = 0):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.n = n
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, _: int):
        key = item_key()
        rng = np.random.default_rng(np.random.randint(0, 2**31) if key is None
                                    else np.random.SeedSequence(self.seed, spawn_key=key))
        narration = f"{rng.choice(_VERBS)} the {rng.choice(_NOUNS)}"
        question = str(rng.choice(ACTION_QUESTION_TEMPLATES)).format(narration)
        answer = str(rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES)).format(
            HAND_TOKEN_TEMPLATE * 4
        )
        source = [
            {"from": "human", "value": DEFAULT_IMAGE_TOKEN + "\n" + question},
            {"from": "gpt", "value": answer},
        ]
        tok = preprocess_v1(
            preprocess_multimodal(copy.deepcopy([source])), self.tokenizer, has_image=True
        )
        size = self.cfg.vision.image_size
        return {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "image": rng.normal(size=(self.cfg.num_frames, 3, size, size)).astype(np.float32),
            "feat": rng.normal(size=(5, 10, 1024)).astype(np.float32),
            "bbox_feat": rng.uniform(size=(4, 10, 4)).astype(np.float32),
            "valid_mask": np.ones((5, 10), np.float32),
            "future_hands": rng.uniform(size=(2, 5, 2)).astype(np.float32),
            "contact_point": rng.uniform(size=(2,)).astype(np.float32),
            "future_valid": np.ones((2,), np.float32),
            "prompt": question,
        }
