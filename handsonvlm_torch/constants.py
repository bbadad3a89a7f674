"""Model- and dataset-level constants.

Behavioral spec mirrored from the reference implementation
(`handsonvlm/constants.py`, `lita/constants.py`, `llava/constants.py` in
Kami-code/HandsOnVLM-release): the sentinel ids, special-token layout and the
EPIC-KITCHENS conversation templates are part of the model's public contract
(checkpoints depend on them), so they must match exactly.
"""

# Label id ignored by the cross-entropy loss (reference: llava/constants.py:7).
IGNORE_INDEX = -100

# Sentinel inserted into input_ids where the video's visual tokens get spliced
# (reference: llava/constants.py:8).
IMAGE_TOKEN_INDEX = -200

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Time tokens <t0>..<t99> appended after the base vocab
# (reference: lita/constants.py:14, lita/model/lita_arch.py:88-94).
TIME_TOKEN_TEMPLATE = "<t{t}>"
NUM_TIME_TOKENS = 100

# The hand-trajectory special token (reference: handsonvlm/constants.py:20).
HAND_TOKEN_TEMPLATE = "<hand_traj>"

# Vocab layout with Vicuna v1.3: 32000 base ids, time tokens occupy
# 32000..32099, <hand_traj> is 32100 (hard-coded in the reference at
# handsonvlm/model/language_model/handsonvlm.py:146,349,609).
VICUNA_BASE_VOCAB = 32000
HAND_TOKEN_ID = 32100
PADDED_VOCAB_SIZE = 32101

# Trajectory spec (reference: hoi_forecast/utils/const.py:74-88): observation
# window of 10 frames at 4 fps (2.5 s) ending 1 s before the action; 4 future
# waypoints at 4 fps (1 s anticipation); plus the last observed position the
# label pipeline keeps 5 future points per hand.
NUM_OBS_FRAMES = 10
NUM_FUTURE_STEPS = 4
FUTURE_HANDS_WITH_LAST_OBS = 5
EPIC_IMG_WIDTH = 456
EPIC_IMG_HEIGHT = 256

# Video interface: 10 unique frames repeated 10x fill the 100-slot interface
# (reference: handsonvlm/dataset/epic_dataset.py:89-95).
NUM_FRAMES = 100
FRAME_SIZE = 224

# Visual token budget for video_arch='temporal_spatial_pool': 100 temporal
# means + 4 keyframes spatially pooled to 8x8 = 356 tokens
# (reference: hoi_forecast/model/visual_to_tokens.py:252-271).
NUM_VISUAL_TOKENS_TSP = 356
MODEL_MAX_LENGTH = 2048

# ---------------------------------------------------------------------------
# EPIC conversation templates (reference: handsonvlm/constants.py:28-66).
# These strings define the SFT prompt distribution and the eval protocol; they
# must match the reference byte-for-byte.
# ---------------------------------------------------------------------------

GENERAL_QUESTION_TEMPLATES = [
    "Can you provide the hand trajectory?",
    "What is the recommended hand movement?",
    "What is the future hand trajectory in this video?",
    "What is the predicted hand trajectory given current observations?",
]

ACTION_QUESTION_TEMPLATES = [
    "Where should my hand move to if I want to {}?",
    "Can you provide the hand trajectory for {}?",
    "What is the recommended hand movement for {}?",
]

GENERAL_SPECIFIC_QUESTION_TEMPLATES = [
    "What is the recommended hand trajectory for doing this?",
    "What is the predicted hand trajectory to do it?",
    "What is the future hand trajectory for doing it?",
    "Can you provide the hand trajectory for doing this action?",
]

ACTION_PREDICTION_TEMPLATES = [
    "What kind of action do you think are going to happen in this video?",
    "What is the predicted action in this video?",
    "What is the expected action in this video?",
]

ACTION_ANSWER_TEMPLATES = [
    "Certainly! The hand trajectory for {} is as follows: {}.",
    "To {}, the recommended hand trajectory is: {}.",
]

GENERAL_TRAJECTORY_ANSWER_TEMPLATES = [
    "The hand trajectory for this action is as follows: {}.",
    "The possible following hand trajectory may be: {}.",
]

GENERAL_ANSWER_TEMPLATES = [
    "Sure! Here is the hand trajectory {}.",
    "Based on the video, the hand trajectory is as follows: {}.",
    "The predicted hand trajectory is as follows: {}.",
]
