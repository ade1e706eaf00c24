"""Training losses: photometric MSE, DS-NeRF depth and sigma losses (PyTorch).

Counterparts of startrax/ops/losses.py. The masked means take an optional
ray group (parallel.mesh.RayGroup): on a shard of the batch they divide by
the mask count of the whole batch, so that the ranks' values sum to the
one-process loss.
"""

from __future__ import annotations

import math

import torch

from ..constants import EPS


def img2mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)


def _masked_mean(values, mask, group=None):
    """sum(values * mask) / max(sum(mask), 1); with a group, the count is
    the mask's over every rank's shard (all-reduced, no grad), so this is
    this rank's share of the mean over the whole batch."""
    count = torch.sum(mask).detach()
    if group is not None:
        count = group.all_reduce(count.clone())
    return torch.sum(values * mask) / torch.clamp(count, min=1.0)


def depth_loss(depth, gt_depth, near: float, far: float, group=None):
    """Relative squared depth error on rays whose GT depth lies inside
    [near, far]; group as _masked_mean."""
    mask = torch.logical_and(gt_depth < far, gt_depth > near).to(depth.dtype)
    err = ((depth - gt_depth) / torch.where(gt_depth == 0, torch.ones_like(gt_depth), gt_depth)) ** 2
    return _masked_mean(err, mask, group)


def sigma_loss(weights, z_vals, dists, gt_depth, near: float, far: float,
               err: float = 1.0, max_dist: float = 0.0, group=None):
    """DS-NeRF ray-distribution loss, summed over samples and averaged over
    in-volume rays. max_dist > 0 zeroes distances above it: the far_dist
    sentinel appended to each ray's last sample. group as _masked_mean."""
    w = torch.where(weights <= 0, torch.full_like(weights, EPS), weights)
    mask = torch.logical_and(gt_depth < far, gt_depth > near).to(weights.dtype)
    if max_dist > 0:
        dists = torch.where(dists > max_dist, torch.zeros_like(dists), dists)
    per_sample = (
        -torch.log(w)
        * torch.exp(-((z_vals - gt_depth[:, None]) ** 2) / (2.0 * err))
        * dists
    )
    return _masked_mean(torch.sum(per_sample, dim=1), mask, group)
