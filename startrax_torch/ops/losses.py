"""Training losses: photometric MSE, DS-NeRF depth and sigma losses (PyTorch).

Counterparts of startrax/ops/losses.py.
"""

from __future__ import annotations

import math

import torch

from ..constants import EPS


def img2mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def _masked_mean(values, mask):
    count = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(values * mask) / count


def depth_loss(depth, gt_depth, near: float, far: float):
    """Relative squared depth error on rays whose GT depth lies inside
    [near, far]."""
    mask = torch.logical_and(gt_depth < far, gt_depth > near).to(depth.dtype)
    err = ((depth - gt_depth) / torch.where(gt_depth == 0, torch.ones_like(gt_depth), gt_depth)) ** 2
    return _masked_mean(err, mask)


def sigma_loss(weights, z_vals, dists, gt_depth, near: float, far: float,
               err: float = 1.0, max_dist: float = 0.0):
    """DS-NeRF ray-distribution loss, summed over samples and averaged over
    in-volume rays. max_dist > 0 zeroes distances above it: the far_dist
    sentinel appended to each ray's last sample."""
    w = torch.where(weights <= 0, torch.full_like(weights, EPS), weights)
    mask = torch.logical_and(gt_depth < far, gt_depth > near).to(weights.dtype)
    if max_dist > 0:
        dists = torch.where(dists > max_dist, torch.zeros_like(dists), dists)
    per_sample = (
        -torch.log(w)
        * torch.exp(-((z_vals - gt_depth[:, None]) ** 2) / (2.0 * err))
        * dists
    )
    return _masked_mean(torch.sum(per_sample, dim=1), mask)
