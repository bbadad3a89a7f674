"""Observation-window frame sampler.

Port of `handsonvlm_tpu/data/action_sampler.py` (behavioral spec from
`hoi_forecast/dataset/action_sampler.py:6-38`): the observation window is
`observation_seconds` at `fps` ending `anticipation_seconds` before the
action start, converted to 1-based 60 fps frame indices (clamped at video
start).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from handsonvlm_torch.data.epic_constants import (
    ANTICIPATION_SECONDS,
    FPS,
    OBSERVATION_SECONDS,
    ORIGIN_FPS,
)


def sample_history_frames(
    action_start_frame_idx: int,
    observation_seconds: float = OBSERVATION_SECONDS,
    anticipation_seconds: float = ANTICIPATION_SECONDS,
    fps: float = FPS,
    origin_fps: float = ORIGIN_FPS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frame_aligned_times, frame_indices), both length
    observation_seconds*fps."""
    action_start_time = (action_start_frame_idx - 1) / origin_fps
    num_frames = int(np.floor(observation_seconds * fps))
    anticipation_time = action_start_time - anticipation_seconds
    observation_times = (
        np.arange(1, num_frames + 1) - num_frames
    ) / fps + anticipation_time
    observation_times = np.clip(observation_times, 0, np.inf).astype(np.float32)
    observation_frame_idxs = np.floor(observation_times * origin_fps).astype(np.int32) + 1
    frame_aligned_times = (observation_frame_idxs - 1) / origin_fps
    return frame_aligned_times, observation_frame_idxs
