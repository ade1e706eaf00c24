"""Pinhole-camera ray generation (NeRF convention: x right, y up, -z forward).

Counterpart of startrax/ops/rays.py: ``get_rays`` on tensors, and the numpy
twins ``get_rays_np``, ``focal_from_fov`` and ``intrinsics_matrix`` for host
data pipelines, so the port needs nothing of the JAX package for rays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve


def get_rays(H: int, W: int, K, c2w, device=None):
    """Per-pixel ray origins and directions for an HxW image, each [H, W, 3]
    float32 on ``device`` (None: the card, device.resolve). K: [3, 3]
    intrinsics; c2w: [3, 4] or [4, 4] camera-to-world (tensors or arrays)."""
    device = resolve(device)
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
                       -1)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w):
    """Numpy twin of get_rays for host data pipelines."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
                       indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1)
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def focal_from_fov(W: int, fov_deg: float) -> float:
    """Focal length from the horizontal field of view in degrees."""
    return W / (2.0 * np.tan(fov_deg * np.pi / 360.0))


def intrinsics_matrix(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32)
