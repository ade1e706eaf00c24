"""TUM RGB-D trajectory metrics: RPE and ATE (host-side numpy, eval-only).

Counterpart of the reference's adapted TUM tooling
(utils/metrics.py:159-460). Our trajectories are frame-indexed (integer
timestamps, fixed delta = 1 frame), which collapses the TUM timestamp
association to identity — the math is the same.

The port's own copy of startrax/eval/trajectory.py (numpy, scipy and the
standard library), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def _pose7_to_mat(poses: np.ndarray) -> np.ndarray:
    poses = np.asarray(poses)
    if poses.shape[-2:] == (4, 4):
        return poses.astype(np.float32)
    out = np.tile(np.eye(4, dtype=np.float32), poses.shape[:-1] + (1, 1))
    out[..., :3, :3] = Rotation.from_quat(poses[..., 3:7].reshape(-1, 4)).as_matrix().reshape(
        poses.shape[:-1] + (3, 3)
    )
    out[..., :3, 3] = poses[..., :3]
    return out


def _ominus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.inv(a) @ b


def _trans_dist(T: np.ndarray) -> float:
    return float(np.linalg.norm(T[:3, 3]))


def _rot_angle(T: np.ndarray) -> float:
    return float(np.arccos(min(1.0, max(-1.0, (np.trace(T[:3, :3]) - 1.0) / 2.0))))


def evaluate_rpe(est_poses, gt_poses, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame pairs (i, i+delta).

    est_poses/gt_poses: [F, 7] or [F, 4, 4]. Returns (trans RMSE in scene
    units, rot RMSE in degrees) — reference evaluate_rpe
    (utils/metrics.py:387-436) with param_fixed_delta=True, delta=1.
    """
    est = _pose7_to_mat(est_poses)
    gt = _pose7_to_mat(gt_poses)
    assert est.shape == gt.shape and est.ndim == 3

    trans_err, rot_err = [], []
    for i in range(est.shape[0] - delta):
        j = i + delta
        err = _ominus(_ominus(est[j], est[i]), _ominus(gt[j], gt[i]))
        trans_err.append(_trans_dist(err))
        rot_err.append(_rot_angle(err))
    trans_err = np.asarray(trans_err)
    rot_err = np.asarray(rot_err)
    trans_rmse = float(np.sqrt(np.dot(trans_err, trans_err) / len(trans_err)))
    rot_rmse = float(np.sqrt(np.dot(rot_err, rot_err) / len(rot_err)) * 180.0 / np.pi)
    return trans_rmse, rot_rmse


def evaluate_ate(est_poses, gt_poses) -> float:
    """Absolute trajectory error: RMSE of per-frame translation distance
    (reference evaluate_ate, utils/metrics.py:439-460)."""
    est = np.asarray(est_poses)[..., :3] if np.asarray(est_poses).shape[-1] == 7 else _pose7_to_mat(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[..., :3] if np.asarray(gt_poses).shape[-1] == 7 else _pose7_to_mat(gt_poses)[:, :3, 3]
    err = np.sqrt(np.sum((est - gt) ** 2, axis=-1))
    return float(np.sqrt(np.dot(err, err) / len(err)))
