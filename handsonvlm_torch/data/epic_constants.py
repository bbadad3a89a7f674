"""EPIC-KITCHENS dataset constants and path resolution.

Port of `handsonvlm_tpu/data/epic_constants.py` (behavioral spec from
`hoi_forecast/utils/const.py`). Paths are rooted at $HANDSONVLM_DATA_ROOT
(defaults to ./data) and $HANDSONVLM_ASSETS_DIR (defaults to
<root>/assets); the directory structure below the root matches the
reference, so its prepared data drops in unchanged.
"""

from __future__ import annotations

import json
import os
import random
from functools import lru_cache

# timing (const.py:74-88)
OBSERVATION_SECONDS = 2.5
FPS = 4.0
ORIGIN_FPS = 60.0
ANTICIPATION_SECONDS = 1.0
OBSERVATION_FRAMES_NUM = int(OBSERVATION_SECONDS * FPS)  # 10
ANTICIPATION_FRAMES_NUM = int(ANTICIPATION_SECONDS * FPS)  # 4
FUTURE_HAND_NUM = ANTICIPATION_FRAMES_NUM + 1  # 5
FRAME_TEMPLATE = "frame_{:010d}.jpg"
NUM_ACTIONS_PREV = 1
EPIC_IMG_SHAPE = (456, 256)  # (width, height)
EPIC_IMG_WIDTH, EPIC_IMG_HEIGHT = EPIC_IMG_SHAPE
USE_RULSTM_SPLITS = True
VALIDATION_RATIO = 0.2
IMAGE_ASPECT_RATIO = "square"

# absent-hand default trajectories (epic_utils.py:42,47)
ABSENT_RIGHT_HAND = (0.75, 1.5)
ABSENT_LEFT_HAND = (0.25, 1.5)


def data_root() -> str:
    return os.environ.get("HANDSONVLM_DATA_ROOT", os.path.join(os.getcwd(), "data"))


def assets_dir() -> str:
    return os.environ.get(
        "HANDSONVLM_ASSETS_DIR", os.path.join(data_root(), "assets")
    )


def epic_kitchen_dataset_dir() -> str:
    return os.path.join(data_root(), "EPIC-KITCHENS")


def annotation_dir(ek_version: str) -> str:
    return os.path.join(
        data_root(),
        "common",
        {
            "ek55": "epic-kitchens-55-annotations",
            "ek100": "epic-kitchens-100-annotations",
        }[ek_version],
    )


def rulstm_annotation_dir(ek_version: str) -> str:
    return os.path.join(data_root(), "common", "rulstm", "RULSTM", "data", ek_version)


def label_dir(ek_version: str) -> str:
    return os.path.join(data_root(), ek_version, "labels")


def label_cache_dir(ek_version: str) -> str:
    return os.path.join(data_root(), ek_version)


def eval_label_path(ek_version: str) -> str:
    return os.path.join(data_root(), ek_version, f"{ek_version}_eval_labels.pkl")


def lmdb_path(ek_version: str) -> str:
    return os.path.join(
        data_root(), ek_version, "feats", "full_data_chenbao_processed.lmdb"
    )


def video_info_path(ek_version: str) -> str:
    return os.path.join(data_root(), ek_version, "video_info.json")


@lru_cache(maxsize=None)
def _rephrase_dict(path: str) -> dict:
    """Narration rephrase templates (handsonvlm/constants.py:68-73), read
    once per file."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def rephrase_narration(narration: str, rng: random.Random) -> str:
    """handsonvlm/constants.py:76-84 (incl. the str-value indirection);
    draws come from `rng`."""
    d = _rephrase_dict(os.path.join(assets_dir(), "rephrase_ek100.json"))
    if narration in d:
        v = d[narration]
        if isinstance(v, str):
            return rng.choice([d[v]])
        if isinstance(v, list):
            return rng.choice(v)
        raise ValueError("rephrase entries must be str or list")
    return narration


def reasoning_questions_path(split: str) -> str:
    name = "ek100_questions.json" if split == "train" else "ek100_questions_val.json"
    return os.path.join(assets_dir(), name)
