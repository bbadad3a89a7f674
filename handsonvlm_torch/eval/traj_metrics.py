"""Trajectory metrics: stochastic ADE/FDE/WDE.

Port of `handsonvlm_tpu/eval/traj_metrics.py`, a numpy copy. Behavioral
spec from `hoi_forecast/evaluation/traj_eval.py`. Two quirks are preserved
deliberately for score parity (BASELINE.md "metric quirk"):

1. **Name swap**: the call sites compute `ade, _ = compute_fde(...)` and
   `fde, _ = compute_ade(...)` (traj_eval.py:81-82,187-190) — the reported
   "ADE" is final-step error math and "FDE" is the per-step mean. We keep
   the swap at the reporting layer so numbers line up with the paper.
2. **WDE sample handling**: `evaluate_traj_stochastic` averages WDE over
   *all* entries (valid or not) rather than filtering like ADE/FDE
   (traj_eval.py:240-243).

Host-side numpy: metrics run on gathered predictions, not on device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def displacement_per_step(pred_traj, gt_traj, valid_traj=None, reduction=True):
    """Mean per-step L2 error with in-bounds masking.

    This is the reference's `compute_ade` math (traj_eval.py:6-36).
    pred/gt: (B, num_obj, T, 2) normalized coords; valid: (B, num_obj).
    """
    pred_traj = np.asarray(pred_traj, np.float64)
    gt_traj = np.asarray(gt_traj, np.float64)
    valid_loc = (
        (gt_traj[..., 0] >= 0)
        & (gt_traj[..., 1] >= 0)
        & (gt_traj[..., 0] < 1)
        & (gt_traj[..., 1] < 1)
    )  # (B, N, T)
    if valid_traj is None:
        valid_traj = np.ones(pred_traj.shape[:2], dtype=int)
    error = (gt_traj - pred_traj) * valid_loc[..., None]
    err = np.linalg.norm(error, axis=3).mean(axis=2) * valid_traj
    if reduction:
        return err.sum() / valid_traj.sum(), valid_traj.sum()
    return err, valid_traj


def final_displacement(pred_traj, gt_traj, valid_traj=None, reduction=True):
    """Final-step L2 error (`compute_fde` math, traj_eval.py:39-71)."""
    pred_last = np.asarray(pred_traj, np.float64)[:, :, -1, :]
    gt_last = np.asarray(gt_traj, np.float64)[:, :, -1, :]
    valid_loc = (
        (gt_last[..., 0] >= 0)
        & (gt_last[..., 1] >= 0)
        & (gt_last[..., 0] < 1)
        & (gt_last[..., 1] < 1)
    )
    if valid_traj is None:
        valid_traj = np.ones(pred_last.shape[:2], dtype=int)
    error = (gt_last - pred_last) * valid_loc[..., None]
    err = np.linalg.norm(error, axis=2) * valid_traj
    if reduction:
        return err.sum() / valid_traj.sum(), valid_traj.sum()
    return err, valid_traj


def weighted_displacement(pred_traj, gt_traj, valid_traj=None, reduction=True):
    """Time-weighted ([0.25,0.5,0.75,1.0]) error (`compute_wde`,
    traj_eval.py:97-169)."""
    pred_traj = np.asarray(pred_traj, np.float64)
    gt_traj = np.asarray(gt_traj, np.float64)
    valid_loc = (
        (gt_traj[..., 0] >= 0)
        & (gt_traj[..., 0] < 1)
        & (gt_traj[..., 1] >= 0)
        & (gt_traj[..., 1] < 1)
    )
    t = pred_traj.shape[2]
    weights = np.arange(1, t + 1) / t
    if valid_traj is None:
        valid_traj = np.ones(pred_traj.shape[:2])
    error = (gt_traj - pred_traj) * valid_loc[..., None]
    distances = np.sqrt((error**2).sum(axis=-1))
    weighted = (distances * weights) * valid_loc
    denom = np.maximum(valid_loc.sum(axis=-1), 1)
    traj_err = weighted.sum(axis=-1) / denom
    wde = traj_err * valid_traj
    if reduction:
        return wde.sum() / (valid_traj.sum() + 1e-6), valid_traj.sum()
    return wde, valid_traj


def evaluate_traj(preds, gts, valids) -> Tuple[float, float]:
    """Deterministic scorer with the reference's name swap
    (traj_eval.py:74-93): returned "ADE" is final-step math, "FDE" is the
    per-step mean."""
    ade, _ = final_displacement(preds, gts, valids)
    fde, _ = displacement_per_step(preds, gts, valids)
    return float(ade), float(fde)


def evaluate_traj_stochastic(preds, gts, valids) -> Tuple[float, float, float]:
    """Stochastic scorer (traj_eval.py:172-254).

    preds: (len_ds, num_samples, num_obj, T, 2); gts: (len_ds, num_obj, T, 2);
    valids: (len_ds, num_obj). Returns (ade_mean, fde_mean, wde_mean) over
    valid trajectories (name swap preserved; WDE unfiltered as in reference).
    """
    preds = np.asarray(preds)
    gts = np.asarray(gts)
    valids = np.asarray(valids)
    len_ds, num_samples, num_obj = preds.shape[:3]

    ade_list, fde_list, wde_list = [], [], []
    for idx in range(num_samples):
        ade, _ = final_displacement(preds[:, idx], gts, valids, reduction=False)
        fde, _ = displacement_per_step(preds[:, idx], gts, valids, reduction=False)
        wde, _ = weighted_displacement(preds[:, idx], gts, valids, reduction=False)
        ade_list.append(ade)
        fde_list.append(fde)
        wde_list.append(wde)
    ade_arr = np.asarray(ade_list, np.float32)  # (S, len_ds, N)
    fde_arr = np.asarray(fde_list, np.float32)
    wde_arr = np.asarray(wde_list, np.float32)

    sel = valids > 0
    valid_ade = ade_arr[:, sel]  # (S, n_valid) column-per-valid-traj
    valid_fde = fde_arr[:, sel]
    ade_mean = float(valid_ade.mean()) if valid_ade.size else float("nan")
    fde_mean = float(valid_fde.mean()) if valid_fde.size else float("nan")
    # reference quirk: WDE mean over all entries, unfiltered
    wde_mean = float(wde_arr.mean()) if wde_arr.size else float("nan")

    # cross-check vs masked-sum formulation (traj_eval.py:250-253)
    chk_ade = (ade_arr.mean(axis=0) * valids).sum() / valids.sum()
    chk_fde = (fde_arr.mean(axis=0) * valids).sum() / valids.sum()
    assert np.isclose(ade_mean, chk_ade, atol=1e-3), (ade_mean, chk_ade)
    assert np.isclose(fde_mean, chk_fde, atol=1e-3), (fde_mean, chk_fde)
    return ade_mean, fde_mean, wde_mean
