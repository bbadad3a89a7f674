"""Trajectory visualization: overlay predicted waypoints on frames.

Behavioral spec from `handsonvlm/evaluation/utils.py:1-159` (gradient /
arrow overlay styles, mp4 writer). cv2 is optional; gated import.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _require_cv2():
    try:
        import cv2

        return cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("trajectory visualization requires opencv (cv2)") from e


def vis_hand_traj(frame: np.ndarray, traj: np.ndarray, color=(0, 0, 255), style: str = "gradient") -> np.ndarray:
    """Overlay one hand's (T,2) normalised trajectory on an HxWx3 frame."""
    cv2 = _require_cv2()
    h, w = frame.shape[:2]
    pts = (traj * np.asarray([w, h])).astype(int)
    out = frame.copy()
    n = len(pts)
    for i in range(n - 1):
        if style == "gradient":
            alpha = (i + 1) / max(n - 1, 1)
            c = tuple(int(ch * alpha) for ch in color)
            cv2.line(out, tuple(pts[i]), tuple(pts[i + 1]), c, 3)
        else:
            cv2.arrowedLine(out, tuple(pts[i]), tuple(pts[i + 1]), color, 3, tipLength=0.3)
    for i, p in enumerate(pts):
        cv2.circle(out, tuple(p), 5, color, -1)
    return out


def vis_traj(frame: np.ndarray, pred_hands: np.ndarray) -> np.ndarray:
    """(2, T, 2) right/left trajectories -> overlay (right red, left blue)."""
    out = vis_hand_traj(frame, pred_hands[0], color=(0, 0, 255))
    out = vis_hand_traj(out, pred_hands[1], color=(255, 0, 0))
    return out


def create_trajectory_video(
    frame_paths: Sequence[str],
    pred_hands: np.ndarray,  # (1,1,2,T,2) or (2,T,2)
    output_path: str,
    fps: int = 4,
) -> str:
    """Render the observed frames plus a final trajectory overlay to mp4."""
    cv2 = _require_cv2()
    pred = np.asarray(pred_hands)
    while pred.ndim > 3:
        pred = pred[0]
    frames: List[np.ndarray] = []
    for p in frame_paths:
        img = cv2.imread(p)
        if img is None:
            raise FileNotFoundError(p)
        frames.append(img)
    overlay = vis_traj(frames[-1], pred)
    frames.extend([overlay] * fps)  # hold the overlay for 1s
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(cv2.resize(f, (w, h)))
    writer.release()
    return output_path
