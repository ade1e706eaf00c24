"""NeRF positional encoding and BARF coarse-to-fine weights (PyTorch).

Counterpart of startrax/ops/encoding.py. The layout is the reference
Embedder's: [x, sin(x f0), cos(x f0), sin(x f1), cos(x f1), ...], with each
sin/cos group three columns wide. The mip-NeRF integrated positional
encoding (IPE) of a conical frustum's Gaussian has the same sin/cos layout
without the raw input.
"""

from __future__ import annotations

import math

import torch


def encoding_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dims * (int(include_input) + 2 * num_freqs)


def barf_weights(step, end_barf: int, num_freqs: int, start: int = 0, device=None):
    """Per-frequency BARF weights in [0, 1]: frequency k fades in as
    (1 - cos(pi * clamp(alpha - k, 0, 1))) / 2, alpha = (step - start) /
    (end_barf - start) * num_freqs."""
    alpha = (float(step) - start) / (end_barf - start) * num_freqs
    k = torch.arange(num_freqs, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def positional_encoding(x, num_freqs: int, include_input: bool = True, step=None,
                        end_barf: int = -1):
    """x [..., d] -> [..., d * (include_input + 2 num_freqs)]; the sin/cos
    bands are masked by the BARF schedule when step is given and end_barf > 0."""
    bands = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * bands[:, None]  # [..., F, d]
    sin = torch.sin(scaled)
    cos = torch.cos(scaled)
    if step is not None and end_barf > 0:
        w = barf_weights(step, end_barf, num_freqs, device=x.device)[:, None].to(x.dtype)
        sin = sin * w
        cos = cos * w
    enc = torch.stack([sin, cos], dim=-2).reshape(x.shape[:-1] + (2 * num_freqs * x.shape[-1],))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def integrated_positional_encoding(mean, cov_diag, num_freqs: int, min_deg: int = 0):
    """mip-NeRF IPE of a Gaussian (mean, diagonal covariance) [..., d] ->
    [..., 2 * num_freqs * d]: E[sin(f x)] for x ~ N(mu, sigma^2) is
    sin(f mu) exp(-f^2 sigma^2 / 2), f = 2^min_deg .. 2^(min_deg +
    num_freqs - 1); a sin block and a cos block per frequency."""
    scales = 2.0 ** torch.arange(min_deg, min_deg + num_freqs, dtype=mean.dtype,
                                 device=mean.device)
    sm = mean[..., None, :] * scales[:, None]  # [..., F, d]
    damp = torch.exp(-0.5 * (cov_diag[..., None, :] * (scales[:, None] ** 2)))
    enc = torch.stack([torch.sin(sm) * damp, torch.cos(sm) * damp], dim=-2)
    return enc.reshape(mean.shape[:-1] + (2 * num_freqs * mean.shape[-1],))


def conical_frustum_to_gaussian(origins, directions, t0, t1, base_radius):
    """The Gaussian of a conical frustum along a ray (mip-NeRF eq. 7):
    origins, directions [..., 3]; t0, t1 [...]; base_radius the radius at
    unit distance -> (mean [..., 3], cov_diag [..., 3])."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    mu2, hw2 = mu * mu, hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + (2.0 * mu * hw2) / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * ((hw2 * hw2) * (12.0 * mu2 - hw2)) / (denom * denom)
    r_var = base_radius ** 2 * (mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * (hw2 * hw2) / denom)
    mean = origins + directions * t_mean[..., None]
    d_outer_diag = directions * directions
    d2 = torch.clamp(d_outer_diag.sum(-1, keepdim=True), min=1e-10)
    null_outer_diag = 1.0 - d_outer_diag / d2
    cov_diag = t_var[..., None] * d_outer_diag + r_var[..., None] * null_outer_diag
    return mean, cov_diag
