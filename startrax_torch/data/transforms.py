"""Coordinate-frame conversions for CARLA/UE4 captures (host-side numpy).

Counterpart of the reference utils/dataset.py:36-66 (UE4 <-> NeRF axis
change, rigid-transform inversion) and the spherical/rotational debug poses.

The port's own copy of startrax/data/transforms.py (numpy and the
standard library), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# UE4 (x fwd, y right, z up) -> NeRF (x right, y up, -z fwd)
_UE4_TO_NERF = np.array([[0, 1, 0], [0, 0, 1], [-1, 0, 0]], dtype=np.float32)
_NERF_TO_UE4 = _UE4_TO_NERF.T


def from_ue4_to_nerf_pts(pts: np.ndarray) -> np.ndarray:
    return np.einsum("ij,...j->...i", _UE4_TO_NERF, pts)


def from_ue4_to_nerf(pose: np.ndarray) -> np.ndarray:
    """Conjugate a UE4 4x4 (or 3x4) pose into the NeRF frame
    (reference utils/dataset.py:40-53)."""
    new_pose = np.eye(pose.shape[0], pose.shape[1], dtype=np.float64)
    new_pose[:3, :3] = _UE4_TO_NERF @ pose[:3, :3] @ _NERF_TO_UE4
    new_pose[:3, -1] = _UE4_TO_NERF @ pose[:3, -1]
    return new_pose.astype(np.float32)


def invert_transformation(t: np.ndarray) -> np.ndarray:
    """Closed-form rigid inverse, single or batched
    (reference utils/dataset.py:56-66)."""
    if t.ndim == 2:
        t_inv = np.eye(4, dtype=np.float32)
        t_inv[:3, :3] = t[:3, :3].T
        t_inv[:3, -1] = -t[:3, :3].T @ t[:3, -1]
        return t_inv
    t_inv = np.tile(np.eye(4, dtype=np.float32), (t.shape[0], 1, 1))
    t_inv[:, :3, :3] = t[:, :3, :3].transpose(0, 2, 1)
    t_inv[:, :3, 3] = -np.einsum("ijk,ik->ij", t_inv[:, :3, :3], t[:, :3, 3])
    return t_inv


def pose_translational(t: float) -> np.ndarray:
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _trans(axis: int, v: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[axis, 3] = v
    return m


def _rot_z_ue4(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_y_ue4(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta_deg: float, radius: float) -> np.ndarray:
    """Debug spherical camera path (reference utils/dataset.py:185-193)."""
    c2w = _trans(2, 6.0)
    c2w = _rot_y_ue4(-25.0 / 180.0 * np.pi) @ c2w
    c2w = _rot_z_ue4(-np.pi) @ c2w
    c2w = _trans(0, radius) @ c2w
    c2w = _rot_z_ue4(theta_deg / 180.0 * np.pi) @ c2w
    return from_ue4_to_nerf(c2w)


def pose_rotational(deg: float) -> np.ndarray:
    """Debug rotating object pose (reference utils/dataset.py:195-201)."""
    pose = _trans(0, -25.0)
    pose = _rot_z_ue4(deg / 180.0 * np.pi) @ pose
    return from_ue4_to_nerf(pose)
