"""Ray sampling: stratified coarse samples and inverse-CDF importance samples.

Counterpart of startrax/ops/sampling.py. Randomness comes in as tensors of
uniforms (or is drawn from a ``torch.Generator`` by the caller), so that a
test can feed both packages the same numbers. The CDF inverse is
``torch.searchsorted``; the coarse/fine union is a sort.
"""

from __future__ import annotations

import torch

from ..constants import PDF_EPS


def stratified_z_vals(n_rays: int, near: float, far: float, n_samples: int,
                      lindisp: bool = False, perturb: float = 1.0, u=None,
                      device=None, dtype=torch.float32):
    """[n_rays, n_samples] depths, linear in depth (or disparity). With
    perturb > 0 and uniforms u [n_rays, n_samples], each sample is jittered
    inside its interval (training); u=None gives the plain linspace (eval)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=dtype, device=device)
    if not lindisp:
        z = near * (1.0 - t) + far * t
    else:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    z = z.expand(n_rays, n_samples)
    if u is not None and perturb > 0.0:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * u
    return z


def pts_from_z(rays_o, rays_d, z_vals):
    """o + d z -> [n_rays, n_samples, 3]."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def sample_pdf(bins, weights, n_samples: int, u=None, stratified: bool = False):
    """Inverse-CDF sampling of n_samples depths from a per-ray histogram.

    bins: [R, B+1] (or B+2) edges; weights: [R, B]. u=None gives evenly
    spaced u (eval). Otherwise u [R, n_samples] holds uniforms: used as they
    are, or stratified as (i + u_i) / n_samples with stratified=True."""
    B = weights.shape[-1]
    if bins.shape[-1] not in (B + 1, B + 2):
        raise AssertionError(
            f"bins last dim {bins.shape[-1]} must be weights last dim + 1 or + 2 ({B})")
    weights = weights + PDF_EPS
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, B+1]

    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    elif stratified:
        i = torch.arange(n_samples, dtype=cdf.dtype, device=cdf.device)
        u = (i + u) / n_samples
    bins = bins[..., : cdf.shape[-1]]
    u = u.contiguous()

    # below = last edge with cdf <= u; above = the next one, clamped to the end
    below = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    above = torch.clamp(below + 1, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_z_vals(z_vals, weights, n_importance: int, u=None,
                        stratified: bool = True):
    """Coarse weights -> (sorted union of coarse z and importance samples
    [R, S+I], importance samples [R, I]); the samples carry no gradient."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_importance, u=u,
                           stratified=stratified).detach()
    z_union, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    return z_union, z_samples
