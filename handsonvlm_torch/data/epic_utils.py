"""Hand-trajectory label processing.

Port of `handsonvlm_tpu/data/epic_utils.py` (behavioral spec from
`hoi_forecast/dataset/epic_utils.py:6-76`): 21-point 20 fps trajectories
are subsampled to 5 points at 4 fps and normalised by the 456x256 EPIC
frame; absent hands get fixed off-screen defaults.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from handsonvlm_torch.data.epic_constants import (
    ABSENT_LEFT_HAND,
    ABSENT_RIGHT_HAND,
    ANTICIPATION_SECONDS,
    EPIC_IMG_HEIGHT,
    EPIC_IMG_WIDTH,
    FPS,
    FUTURE_HAND_NUM,
)


def sample_hand_trajectory(trajectory: np.ndarray) -> Tuple[np.ndarray, list]:
    """(21, 2) pixel trajectory at 20 fps -> (5, 2) normalised at 4 fps."""
    assert trajectory.shape == (21, 2), trajectory.shape
    origin_fps = int((len(trajectory) - 1) / ANTICIPATION_SECONDS)
    gap = int(origin_fps // FPS)
    indices = [0] + list(range(gap, len(trajectory), gap))
    pts = trajectory[np.asarray(indices)].astype(np.float32)
    pts = pts / np.asarray([EPIC_IMG_WIDTH, EPIC_IMG_HEIGHT], np.float32)
    assert pts.shape == (FUTURE_HAND_NUM, 2), pts.shape
    return pts, indices


def _absent(default_xy) -> np.ndarray:
    return np.repeat(np.asarray([default_xy], np.float32), FUTURE_HAND_NUM, axis=0)


def process_video_info(video_info: Dict, rng: np.random.Generator):
    """Training label pkl -> (future_hands (2,5,2), contact_point (2,),
    future_valid (2,), last_frame_index); the contact point is drawn from
    `rng`."""
    hand_trajs = video_info["hand_trajs"]

    pts = video_info["affordance"]["select_points_homo"]
    sel = rng.choice(pts.shape[0], 1, replace=False)
    contact = pts[sel][0].astype(np.float32)
    contact_point = np.asarray(
        [contact[0] / EPIC_IMG_WIDTH, contact[1] / EPIC_IMG_HEIGHT], np.float32
    )

    valid = np.zeros(2)
    if "RIGHT" in hand_trajs:
        right, _ = sample_hand_trajectory(hand_trajs["RIGHT"]["traj"])
        valid[0] = True
    else:
        right = _absent(ABSENT_RIGHT_HAND)
    if "LEFT" in hand_trajs:
        left, _ = sample_hand_trajectory(hand_trajs["LEFT"]["traj"])
        valid[1] = True
    else:
        left = _absent(ABSENT_LEFT_HAND)

    future_hands = np.stack((right, left), axis=0)
    future_valid = np.asarray(valid, np.int64)
    last_frame_index = video_info["frame_indices"][0]
    return future_hands, contact_point, future_valid, last_frame_index


def process_eval_video_info(video_info: Dict):
    """Eval label pkl entry -> (gt_hands (2,5,2), gt_hand_valid (2,5))."""
    right = video_info.get("RIGHT", _absent(ABSENT_RIGHT_HAND))
    left = video_info.get("LEFT", _absent(ABSENT_LEFT_HAND))
    gt_hands = np.stack((right, left), axis=0)
    gt_hand_valid = np.all((gt_hands >= 0.0) & (gt_hands <= 1.0), axis=-1)
    assert gt_hands.shape == (2, FUTURE_HAND_NUM, 2), gt_hands.shape
    return gt_hands, gt_hand_valid
