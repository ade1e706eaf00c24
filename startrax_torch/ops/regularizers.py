"""STaR / D2NeRF regularizers on per-sample alphas and densities (PyTorch).

Counterparts of startrax/ops/regularizers.py. All take [R, S] static and
[R, K, S] dynamic tensors and return scalars.
"""

from __future__ import annotations

import torch

from ..constants import EPS


def alpha_entropy(alpha_s, alpha_d):
    """H(alpha_s) + H(alpha_d): binary entropy pushed to 0/1 occupancy."""
    num_vehicles = alpha_d.shape[1]
    a_s = torch.clamp(alpha_s, EPS, 1.0 - EPS)
    a_d = torch.clamp(alpha_d, EPS, 1.0 - EPS)
    ent = -torch.mean(
        alpha_s * torch.log(a_s) + (1.0 - alpha_s) * torch.log1p(-a_s)
    ) / (num_vehicles + 1)
    ent = ent + torch.sum(
        -torch.mean(alpha_d * torch.log(a_d) + (1.0 - alpha_d) * torch.log1p(-a_d), dim=(0, 2))
    ) / (num_vehicles + 1)
    return ent


def dynamic_vs_static_reg(alpha_s, alpha_d):
    """Entropy of the normalised static/dynamic alpha split, weighted by the
    total alpha."""
    total_alpha = alpha_s + torch.sum(alpha_d, dim=1)
    denom = torch.clamp(total_alpha, min=EPS)
    static_normed = torch.clamp(alpha_s / denom, min=EPS)
    dynamic_normed = torch.clamp(alpha_d / denom[:, None, :], min=EPS)
    return -torch.mean(
        total_alpha
        * (static_normed * torch.log(static_normed)
           + torch.sum(dynamic_normed * torch.log(dynamic_normed), dim=1))
    )


def ray_reg(sigma_d, total_sigma):
    """Mean over rays of max_s(sigma_d / sigma_total)^2, averaged over vehicles."""
    num_vehicles = sigma_d.shape[1]
    normed = sigma_d / torch.clamp(total_sigma, min=EPS)[:, None, :]
    return torch.sum(torch.mean(torch.amax(normed, dim=-1) ** 2.0, dim=0)) / num_vehicles


def static_reg(sigma_s, alpha_s, mask_threshold: float = 0.1):
    """Entropy of the per-ray normalised static alpha, on rays with enough
    static density."""
    a_s = torch.clamp(alpha_s, EPS, 1.0 - EPS)
    sigma_sum = torch.sum(sigma_s, dim=-1, keepdim=True)
    mask = torch.where(sigma_sum < mask_threshold, 0.0, 1.0)
    p = a_s / torch.sum(a_s, dim=-1, keepdim=True)
    return torch.mean(mask * -torch.mean(p * torch.log(p), dim=-1, keepdim=True))


def dynamic_reg(sigma_d):
    """Mean dynamic density."""
    return torch.mean(sigma_d)
