"""Pose-accuracy metrics (host-side numpy; eval-only).

Counterpart of the reference get_pose_metrics / get_pose_metrics_multi
(utils/metrics.py:30-155) and the rotation/Euler metrics in utils/dataset.py.
Poses come in as SE(3) 7-vecs [t, q(xyzw)] or 4x4 matrices.

The port's own copy of startrax/eval/pose.py (numpy, scipy and the
standard library), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def _to_Rt(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    poses = np.asarray(poses)
    if poses.shape[-1] == 7:
        R = Rotation.from_quat(poses[..., 3:7].reshape(-1, 4)).as_matrix()
        R = R.reshape(poses.shape[:-1] + (3, 3)).astype(np.float32)
        t = poses[..., :3].astype(np.float32)
        return R, t
    if poses.shape[-2:] == (4, 4) or poses.shape[-2:] == (3, 4):
        return poses[..., :3, :3].astype(np.float32), poses[..., :3, 3].astype(np.float32)
    raise ValueError(f"unsupported pose shape {poses.shape}")


def rotation_metric_np(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """||I - R1 R2^T||_F (reference utils/dataset.py:138-142)."""
    d = np.eye(3, dtype=R1.dtype) - R1 @ np.swapaxes(R2, -1, -2)
    return np.linalg.norm(d, axis=(-2, -1))


def euler_metric_np(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """L2 distance of xyz Euler angles (reference utils/metrics.py:23-26)."""
    e1 = Rotation.from_matrix(R1.reshape(-1, 3, 3)).as_euler("xyz")
    e2 = Rotation.from_matrix(R2.reshape(-1, 3, 3)).as_euler("xyz")
    return np.sqrt(np.sum((e1 - e2) ** 2, axis=-1)).reshape(R1.shape[:-2])


def get_pose_metrics(poses, gt_poses, reduce: bool = True):
    """Per-frame translation L2 + rotation metrics for one vehicle.

    poses/gt_poses: [F, 7] or [F, 4, 4]. Returns (trans_error, rot_error,
    last_trans_error, last_rot_error, rot_error_euler, last_rot_error_euler)
    — the reference's 6-tuple (utils/metrics.py:106-113)."""
    R, t = _to_Rt(poses)
    Rg, tg = _to_Rt(gt_poses)

    trans = np.sqrt(np.sum((t - tg) ** 2, axis=-1))
    rot = rotation_metric_np(R, Rg)
    rot_euler = euler_metric_np(R, Rg)

    last = (trans[-1], rot[-1], rot_euler[-1])
    if reduce:
        trans, rot, rot_euler = trans.mean(), rot.mean(), rot_euler.mean()
    return trans, rot, last[0], last[1], rot_euler, last[2]


def get_pose_metrics_multi(poses, gt_poses, reduce: bool = True):
    """Vectorized over vehicles: poses [F, K, ...] -> per-vehicle lists
    (reference utils/metrics.py:117-155)."""
    K = np.asarray(poses).shape[1]
    outs = [get_pose_metrics(np.asarray(poses)[:, i], np.asarray(gt_poses)[:, i], reduce) for i in range(K)]
    return tuple(list(x) for x in zip(*outs))
