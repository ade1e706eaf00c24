"""Volume rendering: single-field alpha compositing and the STaR composition
of one static and K rigid dynamic fields under a joint transmittance.

Counterpart of startrax/ops/compositing.py. Transmittance is an exclusive
cumprod of (1 - alpha + 1e-10).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..constants import DISP_EPS, EPS, TRANS_EPS
from .regularizers import (
    alpha_entropy,
    dynamic_reg,
    dynamic_vs_static_reg,
    ray_reg,
    static_reg,
)


def raw2alpha(raw, dists):
    """alpha = 1 - exp(-softplus(raw) * dist)."""
    return 1.0 - torch.exp(-F.softplus(raw) * dists)


def _dists_from_z(z_vals, rays_d, far_dist):
    """Inter-sample distances with a far cap appended, scaled by |rays_d|."""
    d = z_vals[..., 1:] - z_vals[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], far_dist)], dim=-1)
    return d * torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def _transmittance(alpha):
    """T_i = prod_{j<i} (1 - alpha_j + 1e-10) along the last axis."""
    ones = torch.ones_like(alpha[..., :1])
    return torch.cumprod(torch.cat([ones, 1.0 - alpha + TRANS_EPS], dim=-1), dim=-1)[..., :-1]


def raw2outputs(raw_alpha, raw_rgb, z_vals, rays_d, noise: Optional[torch.Tensor] = None,
                white_bkgd: bool = False, far_dist: float = 1e10):
    """Single-field compositing. raw_alpha [R, S], raw_rgb [R, S, 3];
    noise (shape of raw_alpha) is the training-time density noise."""
    R, S = raw_alpha.shape
    assert tuple(raw_rgb.shape) == (R, S, 3) and tuple(z_vals.shape) == (R, S)
    assert tuple(rays_d.shape) == (R, 3)
    dists = _dists_from_z(z_vals, rays_d, far_dist)
    rgb = torch.sigmoid(raw_rgb)
    if noise is not None:
        raw_alpha = raw_alpha + noise
    alpha = raw2alpha(raw_alpha, dists)
    weights = alpha * _transmittance(alpha)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    weights_sum = torch.sum(weights, dim=-1)
    weights_sum = torch.where(weights_sum >= 0, weights_sum, torch.full_like(weights_sum, 1e-7))
    disp_map = 1.0 / torch.clamp(depth_map / weights_sum, min=DISP_EPS)
    acc_map = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "disp": disp_map, "acc": acc_map, "weights": weights,
            "depth": depth_map, "dists": dists, "z_vals": z_vals}


def raw2outputs_star(raw_alpha_static, raw_rgb_static, raw_alpha_dynamic, raw_rgb_dynamic,
                     z_vals, rays_d, noise: Optional[torch.Tensor] = None,
                     white_bkgd: bool = False, far_dist: float = 1e10,
                     with_test_outputs: bool = False, reference_numerics: bool = False):
    """STaR compositing under a joint transmittance.

    Shapes: raw_alpha_static [R, S]; raw_rgb_static [R, S, 3];
    raw_alpha_dynamic [R, K, S]; raw_rgb_dynamic [R, K, S, 3].
    alpha_total = 1 - exp(-(sigma_s + sum_k sigma_d^k) dist) with sigma =
    softplus(raw) (reference_numerics=True sums the raw values before the
    softplus instead); T = cumprod(1 - alpha_total); the colour integrates
    T (alpha_s c_s + sum_k alpha_d^k c_d^k). Also returns the five
    regularizer scalars and each vehicle's final transmittance."""
    R, S = raw_alpha_static.shape
    K = raw_alpha_dynamic.shape[1]
    assert tuple(raw_rgb_static.shape) == (R, S, 3)
    assert tuple(raw_alpha_dynamic.shape) == (R, K, S)
    assert tuple(raw_rgb_dynamic.shape) == (R, K, S, 3)
    assert tuple(z_vals.shape) == (R, S) and tuple(rays_d.shape) == (R, 3)

    dists = _dists_from_z(z_vals, rays_d, far_dist)
    rgb_static = torch.sigmoid(raw_rgb_static)
    rgb_dynamic = torch.sigmoid(raw_rgb_dynamic)
    if noise is not None:
        raw_alpha_static = raw_alpha_static + noise
        raw_alpha_dynamic = raw_alpha_dynamic + noise[:, None, :]

    sigma_s = F.softplus(raw_alpha_static)
    sigma_d = F.softplus(raw_alpha_dynamic)
    sigma_total = sigma_s + torch.sum(sigma_d, dim=1)

    alpha_static = raw2alpha(raw_alpha_static, dists)
    alpha_dynamic = raw2alpha(raw_alpha_dynamic, dists[:, None, :])
    if reference_numerics:
        alpha_total = raw2alpha(raw_alpha_static + torch.sum(raw_alpha_dynamic, dim=1), dists)
    else:
        alpha_total = 1.0 - torch.exp(-sigma_total * dists)

    T_s = _transmittance(alpha_static)
    T_d = _transmittance(alpha_dynamic)
    T = _transmittance(alpha_total)

    rgb_map = torch.sum(
        T[..., None] * (alpha_static[..., None] * rgb_static
                        + torch.sum(alpha_dynamic[..., None] * rgb_dynamic, dim=1)),
        dim=-2,
    )
    rgb_map_static = torch.sum(T_s[..., None] * alpha_static[..., None] * rgb_static, dim=-2)
    rgb_map_dynamic = torch.sum(T_d[..., None] * alpha_dynamic[..., None] * rgb_dynamic, dim=-2)
    depth_dynamic = torch.sum(T_d * alpha_dynamic * z_vals[:, None, :], dim=-1)
    depth_static = torch.sum(T_s * alpha_static * z_vals, dim=-1)

    weights = T * alpha_total
    depth_map = torch.sum(weights * z_vals, dim=-1)
    weights_sum = torch.sum(weights, dim=-1)
    weights_sum = torch.where(weights_sum >= 0, weights_sum, torch.full_like(weights_sum, EPS))
    disp_map = 1.0 / torch.clamp(depth_map / weights_sum, min=DISP_EPS)
    acc_map = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    result = {
        "rgb": rgb_map,
        "disp": disp_map,
        "acc": acc_map,
        "weights": weights,
        "depth": depth_map,
        "dists": dists,
        "z_vals": z_vals,
        "rgb_static": rgb_map_static,
        "rgb_dynamic": rgb_map_dynamic,
        "depth_static": depth_static,
        "depth_dynamic": depth_dynamic,
        "dynamic_transmittance": T_d[:, :, -1],
        "loss_alpha_entropy": alpha_entropy(alpha_static, alpha_dynamic),
        "loss_dynamic_vs_static_reg": dynamic_vs_static_reg(alpha_static, alpha_dynamic),
        "loss_ray_reg": ray_reg(sigma_d, sigma_total),
        "loss_static_reg": static_reg(sigma_s, alpha_static),
        "loss_dynamic_reg": dynamic_reg(sigma_d),
    }
    if with_test_outputs:
        # dynamic-only render through the all-vehicles transmittance
        alpha_dynamic_all = 1.0 - torch.exp(-torch.sum(sigma_d, dim=1) * dists)
        T_d_all = _transmittance(alpha_dynamic_all)
        result["rgb_dynamic_all"] = torch.sum(
            T_d_all[..., None] * torch.sum(alpha_dynamic[..., None] * rgb_dynamic, dim=1), dim=-2)
    return result
