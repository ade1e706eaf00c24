"""Differentiable SE(3)/SO(3) operations on quaternion 7-vectors (PyTorch).

Counterpart of startrax/ops/lie.py, with the same conventions:
  pose7    = [tx, ty, tz, qx, qy, qz, qw]  (translation, then xyzw quaternion)
  tangent6 = [rho_x, rho_y, rho_z, phi_x, phi_y, phi_z]  (translation part
             first, then the so(3) rotation vector)
All functions broadcast over leading batch dimensions, and make the tensors
they need on their inputs' device. Below a squared angle of _SMALL they take
Taylor expansions, and their gradients stay finite at the zero tangent and
the identity rotation.
"""

from __future__ import annotations

import torch

# Below this squared-angle threshold, use Taylor expansions (f32-safe).
_SMALL = 1e-8


def _safe_norm(v, dim=-1, keepdim=False):
    """sqrt(sum(v^2)) with a gradient-safe zero (d/dv at 0 is 0, not NaN)."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    small = sq < _SMALL
    safe = torch.where(small, torch.ones_like(sq), sq)
    return torch.where(small, torch.sqrt(sq + 1e-30), torch.sqrt(safe))


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)


def quat_conjugate(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


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


def matrix_to_quat(m):
    """3x3 rotation matrix -> unit quaternion (xyzw), branchless: all four
    Shepperd candidates are formed and the best-conditioned one is kept;
    the sign is canonical (qw >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    # four candidate 4*|component|^2 values
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def s(t):
        return torch.sqrt(torch.clamp(t, min=1e-12)) * 2.0

    sw, sx, sy, sz = s(tw), s(tx), s(ty), s(tz)
    qw = torch.stack([(m21 - m12) / sx, (m02 - m20) / sy, (m10 - m01) / sz, sw / 4.0], -1)
    qx = torch.stack([sx / 4.0, (m01 + m10) / sy, (m02 + m20) / sz, (m21 - m12) / sw], -1)
    qy = torch.stack([(m01 + m10) / sx, sy / 4.0, (m12 + m21) / sz, (m02 - m20) / sw], -1)
    qz = torch.stack([(m02 + m20) / sx, (m12 + m21) / sy, sz / 4.0, (m10 - m01) / sw], -1)
    cand = torch.stack([qx, qy, qz, qw], dim=-1)  # [..., 4 candidates, 4]
    best = torch.argmax(torch.stack([tx, ty, tz, tw], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return quat_normalize(q)


def so3_exp(phi):
    """so(3) rotation vector -> unit quaternion (xyzw)."""
    angle = _safe_norm(phi, keepdim=True)
    half = 0.5 * angle
    sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    # sin(a/2)/a with a Taylor fallback: 1/2 - a^2/48
    small = sq < _SMALL
    k = torch.where(small, 0.5 - sq / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([phi * k, torch.cos(half)], dim=-1)


def so3_log(q):
    """Unit quaternion (xyzw) -> so(3) rotation vector."""
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)  # shortest arc
    qv = q[..., :3]
    qw = q[..., 3:4].clamp(-1.0, 1.0)
    sin_half = _safe_norm(qv, keepdim=True)
    half = torch.atan2(sin_half, qw)
    sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = sq < _SMALL
    # 2*half/sin_half; for small angles sin_half ~ half, so k -> 2/qw
    k = torch.where(small, 2.0 / qw.clamp(min=1e-6),
                    2.0 * half / torch.where(small, torch.ones_like(sin_half), sin_half))
    return qv * k


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


def se3_inverse(pose7):
    qinv = quat_conjugate(pose7[..., 3:7])
    t = -quat_rotate(qinv, pose7[..., :3])
    return torch.cat([t, qinv], dim=-1)


def se3_multiply(a, b):
    """Composition a∘b: (a*b).act(p) == a.act(b.act(p))."""
    q = quat_multiply(a[..., 3:7], b[..., 3:7])
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    return torch.cat([t, quat_normalize(q)], dim=-1)


def _so3_left_jacobian(phi):
    """V(phi) such that t = V @ rho in the se(3) exponential."""
    sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = sq < _SMALL
    one = torch.ones_like(sq)
    angle = torch.sqrt(torch.where(small, one, sq))
    px, py, pz = phi.unbind(-1)
    zeros = torch.zeros_like(px)
    K = torch.stack([zeros, -pz, py, pz, zeros, -px, -py, px, zeros],
                    dim=-1).reshape(phi.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    a = torch.where(small, 0.5 - sq / 24.0,
                    (1.0 - torch.cos(angle)) / torch.where(small, one, sq))
    b = torch.where(small, 1.0 / 6.0 - sq / 120.0,
                    (angle - torch.sin(angle)) / torch.where(small, one, sq * angle))
    return eye + a * K + b * (K @ K)


def se3_exp(tangent6):
    """se(3) tangent [rho, phi] -> pose 7-vec [t, q]."""
    rho, phi = tangent6[..., :3], tangent6[..., 3:6]
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return torch.cat([t, so3_exp(phi)], dim=-1)


def se3_log(pose7):
    """pose 7-vec -> se(3) tangent [rho, phi]."""
    phi = so3_log(pose7[..., 3:7])
    rho = torch.linalg.solve(_so3_left_jacobian(phi), pose7[..., :3][..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_to_matrix(pose7):
    """pose 7-vec -> 4x4 homogeneous transform."""
    top = torch.cat([quat_to_matrix(pose7[..., 3:7]), pose7[..., :3, None]], dim=-1)
    bottom = pose7.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(pose7.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_se3(T):
    """4x4 (or 3x4) homogeneous transform -> pose 7-vec."""
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], dim=-1)


def rotation_metric(R1, R2):
    """Deviation-from-identity rotation distance ||I - R1 R2^T||_F."""
    d = torch.eye(3, dtype=R1.dtype, device=R1.device) - R1 @ R2.transpose(-1, -2)
    return torch.sqrt(torch.sum(d * d, dim=(-2, -1)))
