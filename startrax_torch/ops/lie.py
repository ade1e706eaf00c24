"""Differentiable SE(3)/SO(3) operations on quaternion 7-vectors (PyTorch).

Counterpart of startrax/ops/lie.py, with the same conventions:
  pose7 = [tx, ty, tz, qx, qy, qz, qw]  (translation, then xyzw quaternion)
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)


def quat_multiply(a, b):
    """Hamilton product a*b for xyzw quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v by unit quaternions q (broadcasting)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    """Unit quaternion (xyzw) -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def so3_act(q, v):
    """Rotate v by quaternion q."""
    return quat_rotate(q, v)


def se3_identity(*batch_shape, dtype=torch.float32, device=None):
    pose = torch.zeros(batch_shape + (7,), dtype=dtype, device=device)
    pose[..., 6] = 1.0
    return pose


def se3_act(pose7, pts):
    """Apply SE(3) to points: R(q) @ p + t."""
    assert pose7.shape[-1] == 7, f"pose7 last dim must be 7, got {tuple(pose7.shape)}"
    assert pts.shape[-1] == 3, f"pts last dim must be 3, got {tuple(pts.shape)}"
    return quat_rotate(pose7[..., 3:7], pts) + pose7[..., :3]


def se3_multiply(a, b):
    """Composition a∘b: (a*b).act(p) == a.act(b.act(p))."""
    q = quat_multiply(a[..., 3:7], b[..., 3:7])
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    return torch.cat([t, quat_normalize(q)], dim=-1)
