"""EPIC conversation SFT datasets.

Port of `handsonvlm_tpu/data/epic_dataset.py` (behavioral spec from
`handsonvlm/dataset/epic_dataset.py:19-224`): wrap EpicHOIDataset items
into chat samples — templated question (narration or GPT-rephrased
reasoning instruction), answer containing 4 <hand_traj> tokens, 10 frames
repeated 10x to fill the 100-slot video interface. Every draw comes from
the wrapped dataset's generators: its `rng` (a `random.Random`: templates
and narrations) and, outside deterministic mode, its `np_rng` (indices).
"""

from __future__ import annotations

import copy
import json
import re
from typing import Dict, List

import numpy as np

from handsonvlm_torch.constants import (
    ACTION_ANSWER_TEMPLATES,
    ACTION_PREDICTION_TEMPLATES,
    ACTION_QUESTION_TEMPLATES,
    DEFAULT_IMAGE_TOKEN,
    GENERAL_QUESTION_TEMPLATES,
    GENERAL_SPECIFIC_QUESTION_TEMPLATES,
    GENERAL_TRAJECTORY_ANSWER_TEMPLATES,
    HAND_TOKEN_TEMPLATE,
)
from handsonvlm_torch.data import epic_constants as C
from handsonvlm_torch.data.epic_structures import EpicHOIDataset
from handsonvlm_torch.data.tokenization import (
    preprocess_multimodal,
    preprocess_v1,
)

HAND_TRAJ_STR = HAND_TOKEN_TEMPLATE * C.ANTICIPATION_FRAMES_NUM


def extract_questions(value: str) -> List[str]:
    return re.findall(r'"([^"]*)"', value)


def tile_frames_to_100(image: np.ndarray) -> np.ndarray:
    """(10,3,224,224) -> (100,3,224,224) by 10x repetition
    (epic_dataset.py:89-95)."""
    t = image.shape[0]
    reps = 100 // t
    out = np.tile(image[None], (reps, 1, 1, 1, 1)).reshape((t * reps,) + image.shape[1:])
    return out


class EpicConversationDataset:
    """Vanilla narration-conditioned trajectory SFT/eval samples."""

    def __init__(self, tokenizer, epic_hoi_dataset: EpicHOIDataset, deterministic: bool = False):
        assert not epic_hoi_dataset.use_wrong_narration
        self.epic = epic_hoi_dataset
        self.rng = epic_hoi_dataset.rng
        self.tokenizer = tokenizer
        self.deterministic = deterministic

    def __len__(self) -> int:
        return len(self.epic)

    def route_draws(self, rng, np_rng) -> None:
        """Draw from `rng` / `np_rng` from now on, here and in the EPIC HOI
        dataset this one wraps (data/draws.seed_mixture)."""
        self.rng = self.epic.rng = rng
        self.epic.np_rng = np_rng

    def get_sources(self, i: int) -> Dict:
        d, _ = self.epic[i]
        question = self.rng.choice(ACTION_QUESTION_TEMPLATES).format(d["narration"])
        answer = self.rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES).format(HAND_TRAJ_STR)
        d["conversations"] = [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ]
        d["prompt"] = question
        return d

    def __getitem__(self, i: int) -> Dict:
        if not self.deterministic:
            i = int(self.epic.np_rng.integers(0, len(self)))
        d = self.get_sources(i)
        d["conversations"][0]["value"] = (
            DEFAULT_IMAGE_TOKEN + "\n" + d["conversations"][0]["value"]
        )
        sources = preprocess_multimodal(copy.deepcopy([d["conversations"]]))
        tok = preprocess_v1(sources, self.tokenizer, has_image=True)
        out = {
            "input_ids": tok["input_ids"][0],
            "labels": tok["labels"][0],
            "feat": d["feat"],
            "bbox_feat": d["bbox_feat"],
            "valid_mask": d["valid_mask"],
            "future_hands": d["future_hands"].astype(np.float32),
            "contact_point": d["contact_point"].astype(np.float32),
            "future_valid": d["future_valid"].astype(np.float32),
            "prompt": d["prompt"],
            "image_abs_paths": d["image_abs_paths"],
            "image": tile_frames_to_100(d["image"]),
            "uid": d["uid"],
            "narration": d["narration"],
        }
        if "gt_hands" in d:
            out["gt_hands"] = d["gt_hands"]
            out["gt_hand_valid"] = d["gt_hand_valid"]
        return out


class EpicReasoningConversationDataset(EpicConversationDataset):
    """Implicit-instruction variant: questions from the GPT-rephrase files
    keyed by the last observed frame path (epic_dataset.py:114-170)."""

    def __init__(self, tokenizer, epic_hoi_dataset, deterministic: bool = False):
        assert not epic_hoi_dataset.use_wrong_narration
        assert epic_hoi_dataset.split in ("train", "validation", "eval")
        self.epic = epic_hoi_dataset
        self.rng = epic_hoi_dataset.rng
        self.tokenizer = tokenizer
        self.deterministic = deterministic

        split = "train" if epic_hoi_dataset.split == "train" else "validation"
        with open(C.reasoning_questions_path(split)) as f:
            rephrase_file = json.load(f)
        self.reasoning_templates = {
            k: extract_questions(v) for k, v in rephrase_file.items()
        }
        self.valid_index = []
        for index, action in enumerate(self.epic.actions):
            last = self.epic.load_image_paths(action)[-1]
            if self.reasoning_templates.get(last):
                self.valid_index.append(index)

    def __len__(self) -> int:
        return len(self.valid_index)

    def get_sources(self, i: int) -> Dict:
        i = i % len(self.valid_index)
        d, _ = self.epic[self.valid_index[i]]
        answer = self.rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES).format(HAND_TRAJ_STR)
        last_image_path = d["name"][-1]
        question = self.rng.choice(self.reasoning_templates[last_image_path])
        d["conversations"] = [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ]
        d["prompt"] = question
        return d


class EpicMultiturnConversationDataset(EpicConversationDataset):
    """Four dialogue modes mixing trajectory + action prediction turns
    (epic_dataset.py:173-224)."""

    def __init__(self, tokenizer, epic_hoi_dataset):
        assert not epic_hoi_dataset.use_wrong_narration
        self.epic = epic_hoi_dataset
        self.rng = epic_hoi_dataset.rng
        self.tokenizer = tokenizer
        self.deterministic = False

    def get_sources(self, i: int) -> Dict:
        d, action = self.epic[i]
        narration = d["narration"]
        action_prediction_answers = [
            f"The predicted action in this video is {narration}.",
            f"The expected action in this video is {narration}.",
            f"The action that is going to happen in this video is {narration}. "
            f"Because there are {action.noun} in the video.",
        ]
        convo = []
        mode = self.rng.randint(0, 3)
        if mode == 0:
            convo.append({"from": "human", "value": self.rng.choice(ACTION_QUESTION_TEMPLATES).format(narration)})
            convo.append({"from": "gpt", "value": self.rng.choice(ACTION_ANSWER_TEMPLATES).format(narration, HAND_TRAJ_STR)})
        elif mode == 1:
            convo.append({"from": "human", "value": self.rng.choice(GENERAL_QUESTION_TEMPLATES)})
            convo.append({"from": "gpt", "value": self.rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES).format(HAND_TRAJ_STR)})
        elif mode == 2:
            convo.append({"from": "human", "value": self.rng.choice(ACTION_PREDICTION_TEMPLATES)})
            convo.append({"from": "gpt", "value": self.rng.choice(action_prediction_answers)})
            convo.append({"from": "human", "value": self.rng.choice(GENERAL_SPECIFIC_QUESTION_TEMPLATES)})
            convo.append({"from": "gpt", "value": self.rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES).format(HAND_TRAJ_STR)})
        else:
            convo.append({"from": "human", "value": self.rng.choice(GENERAL_QUESTION_TEMPLATES)})
            convo.append({"from": "gpt", "value": self.rng.choice(GENERAL_TRAJECTORY_ANSWER_TEMPLATES).format(HAND_TRAJ_STR)})
            convo.append({"from": "human", "value": self.rng.choice(ACTION_PREDICTION_TEMPLATES)})
            convo.append({"from": "gpt", "value": self.rng.choice(action_prediction_answers)})
        d["conversations"] = convo
        d["prompt"] = ""
        return d
