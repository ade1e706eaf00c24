"""STaR-mip: the mip-NeRF variant of STaR, with the integrated positional
encoding of conical frustums (PyTorch).

Counterpart of startrax/models/mip.py, with the same parameter layout and
rendering:

- the field is plain layers with a [h, x] skip at depth // 2, a softplus
  density and no raw-input concat, on the IPE of each frustum's Gaussian
  (24 position and 4 direction frequencies by default). It is not the fused
  field: its products are torch matmuls with ``_dense``'s numerics (bf16
  operands and f32 accumulation when compute_dtype is bf16, else f32), and
  the K dynamic fields are one batched matmul a layer over their stacked
  params;
- frustums are moved into each vehicle's frame by warping the ray origins
  and directions with ops.lie; the bins, and so the deltas, are invariant
  under the rigid transform;
- compositing takes post-softplus densities: alpha = 1 - exp(-delta
  density), T = exp(-cumsum(delta density)).

Randomness comes in as uniforms: the bins' jitter ``u_uni`` [R, S + 1] and
the PDF resample's ``u_pdf`` [R, I + 1], drawn from ``generator`` in
training when they are not given, so a test can feed the JAX package's
draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve
from ..kernels.fused_mlp import _dot
from ..ops import lie
from ..ops.encoding import (
    conical_frustum_to_gaussian,
    integrated_positional_encoding,
    positional_encoding,
)
from ..ops.regularizers import (
    alpha_entropy,
    dynamic_reg,
    dynamic_vs_static_reg,
    ray_reg,
    static_reg,
)
from ..ops.sampling import sample_pdf
from ..utils.tree import tree_stack
from .fields import _linear, _xavier_uniform

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MipConfig:
    num_vehicles: int = 1
    depth: int = 8
    width: int = 256
    num_freqs_pos: int = 24
    num_freqs_dir: int = 4
    n_samples: int = 128
    n_importance: int = 128
    near: float = 3.0
    far: float = 80.0
    base_radius: float = 0.0005  # frustum radius at unit distance
    compute_dtype: Any = torch.bfloat16

    @property
    def input_ch(self) -> int:
        # IPE has no raw-input concat: the mean is encoded only through sin/cos
        return 2 * self.num_freqs_pos * 3

    @property
    def input_ch_views(self) -> int:
        return 3 + 2 * self.num_freqs_dir * 3


def init_mip_field(cfg: MipConfig, generator: Optional[torch.Generator] = None,
                   device=None) -> Params:
    """He-normal layers and heads, Xavier-uniform rgb, zero biases; layer
    depth // 2 takes [h, x] (W + input_ch rows). device=None is the card."""
    device = resolve(device)
    W = cfg.width
    layers, d_in = [], cfg.input_ch
    for i in range(cfg.depth):
        if i == cfg.depth // 2 and i > 0:
            d_in = W + cfg.input_ch
        layers.append(_linear(d_in, W, generator, device))
        d_in = W
    return {
        "layers": layers,
        "density": _linear(W, 1, generator, device),
        "feature": _linear(W, W, generator, device),
        "views": _linear(W + cfg.input_ch_views, W // 2, generator, device),
        "rgb": _linear(W // 2, 3, generator, device, init=_xavier_uniform),
    }


def init_star_mip(cfg: MipConfig, generator: Optional[torch.Generator] = None,
                  device=None) -> Params:
    """{"static": one field, "dynamic": num_vehicles fields, every leaf
    stacked on a leading [K] axis}."""
    device = resolve(device)
    static = init_mip_field(cfg, generator, device)
    dynamic = [init_mip_field(cfg, generator, device) for _ in range(cfg.num_vehicles)]
    return {"static": static, "dynamic": tree_stack(dynamic)}


def _dense(layer, x, compute_dtype):
    """x @ w + b: bf16 operands and f32 accumulation for bf16 compute, else
    f32. Stacked params ([K, in, out] w, [K, out] b) take x [K, N, in]."""
    w = layer["w"]
    y = _dot(x, w) if compute_dtype == torch.bfloat16 else x @ w
    return y + layer["b"].unsqueeze(-2)


def apply_mip_field(params: Params, cfg: MipConfig, mean, cov_diag, viewdirs):
    """The IPE field on frustum Gaussians: mean, cov_diag [..., R, S, 3] and
    viewdirs [..., R, 3] -> (density [..., R, S] post-softplus, rgb [..., R,
    S, 3] post-sigmoid). A leading [K] axis goes with stacked params."""
    lead, (R, S) = mean.shape[:-3], mean.shape[-3:-1]
    x = integrated_positional_encoding(mean.reshape(*lead, R * S, 3),
                                       cov_diag.reshape(*lead, R * S, 3), cfg.num_freqs_pos)
    dirs = viewdirs[..., :, None, :].expand(*lead, R, S, 3).reshape(*lead, R * S, 3)
    emb_dirs = positional_encoding(dirs, cfg.num_freqs_dir)

    cd = cfg.compute_dtype
    h = x
    for i, layer in enumerate(params["layers"]):
        if i == cfg.depth // 2 and i > 0:
            h = torch.cat([h, x], -1)
        h = F.relu(_dense(layer, h, cd))
    density = F.softplus(_dense(params["density"], h, cd)[..., 0])
    feature = _dense(params["feature"], h, cd)
    hv = F.relu(_dense(params["views"], torch.cat([feature, emb_dirs], -1), cd))
    rgb = torch.sigmoid(_dense(params["rgb"], hv, cd))
    return density.reshape(*lead, R, S), rgb.reshape(*lead, R, S, 3)


def uniform_frustum_bins(n_rays: int, near: float, far: float, n_samples: int, u=None,
                         device=None):
    """[R, S + 1] bin edges from near to far; with uniforms u [R, S + 1],
    each edge jittered inside its interval and the edges sorted."""
    edges = torch.linspace(near, far, n_samples + 1, device=device).expand(n_rays, n_samples + 1)
    if u is not None:
        mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
        upper = torch.cat([mids, edges[..., -1:]], -1)
        lower = torch.cat([edges[..., :1], mids], -1)
        edges, _ = torch.sort(lower + (upper - lower) * u, dim=-1)
    return edges


def pdf_frustum_bins(bins, weights, n_importance: int, u=None):
    """[R, I + 1] bin edges resampled from the coarse weights [R, S] by
    inverse CDF over the bins' midpoints, sorted; u [R, I + 1] uniforms, or
    None for evenly spaced ones (eval)."""
    mids = 0.5 * (bins[..., 1:] + bins[..., :-1])
    new_edges = sample_pdf(mids, weights[..., 1:-1], n_importance + 1, u=u)
    return torch.sort(new_edges, dim=-1)[0]


def _transmittance(dd):
    """exp(-exclusive cumsum) over the last axis."""
    return torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], -1)],
                                -1))


def mip_composite(density, rgb, bins, z_mids):
    """Composite of one field: density [R, S], rgb [R, S, 3], bins [R, S +
    1] -> rgb, acc, depth, weights, alphas, trans."""
    delta_density = (bins[..., 1:] - bins[..., :-1]) * density
    alphas = 1.0 - torch.exp(-delta_density)
    trans = _transmittance(delta_density)
    weights = torch.nan_to_num(alphas * trans)
    return {"rgb": torch.sum(weights[..., None] * rgb, dim=-2), "acc": weights.sum(-1),
            "depth": torch.sum(weights * z_mids, dim=-1), "weights": weights, "alphas": alphas,
            "trans": trans}


def mip_composite_star(density_s, rgb_s, density_d, rgb_d, bins, z_mids,
                       with_test_outputs: bool = False):
    """Joint static + dynamic composite: density_s [R, S], density_d [R, K,
    S], rgb_* [..., 3] -> the joint, static and dynamic maps, the weights,
    the per-vehicle transmittance and the five regularizers (and, with
    with_test_outputs, rgb_dynamic_all)."""
    deltas = bins[..., 1:] - bins[..., :-1]
    dd_s = deltas * density_s
    dd_d = deltas[:, None, :] * density_d
    dd_tot = dd_s + dd_d.sum(1)
    alpha_s = 1.0 - torch.exp(-dd_s)
    alpha_d = 1.0 - torch.exp(-dd_d)
    T, T_s, T_d = _transmittance(dd_tot), _transmittance(dd_s), _transmittance(dd_d)

    rgb_map = torch.sum(T[..., None] * (alpha_s[..., None] * rgb_s
                                        + torch.sum(alpha_d[..., None] * rgb_d, dim=1)), dim=-2)
    weights = T * (1.0 - torch.exp(-dd_tot))
    sigma_sum = density_s + density_d.sum(1)
    result = {
        "rgb": rgb_map,
        "acc": weights.sum(-1),
        "depth": torch.sum(weights * z_mids, dim=-1),
        "weights": weights,
        "rgb_static": torch.sum(T_s[..., None] * alpha_s[..., None] * rgb_s, dim=-2),
        "rgb_dynamic": torch.sum(T_d[..., None] * alpha_d[..., None] * rgb_d, dim=-2),
        "depth_dynamic": torch.sum(T_d * alpha_d * z_mids[:, None, :], dim=-1),
        "dynamic_transmittance": T_d[:, :, -1],
        "loss_alpha_entropy": alpha_entropy(alpha_s, alpha_d),
        "loss_dynamic_vs_static_reg": dynamic_vs_static_reg(alpha_s, alpha_d),
        "loss_ray_reg": ray_reg(density_d, sigma_sum),
        "loss_static_reg": static_reg(density_s, alpha_s),
        "loss_dynamic_reg": dynamic_reg(density_d),
    }
    if with_test_outputs:
        T_d_all = _transmittance(dd_d.sum(1))
        result["rgb_dynamic_all"] = torch.sum(
            T_d_all[..., None] * torch.sum(alpha_d[..., None] * rgb_d, dim=1), dim=-2)
    return result


def _eval_pass(params, cfg: MipConfig, rays_o, viewdirs, bins, pose, with_test_outputs):
    t0, t1 = bins[..., :-1], bins[..., 1:]
    z_mids = 0.5 * (t0 + t1)
    mean, cov = conical_frustum_to_gaussian(rays_o[..., None, :], viewdirs[..., None, :], t0, t1,
                                            cfg.base_radius)
    density_s, rgb_s = apply_mip_field(params["static"], cfg, mean, cov, viewdirs)
    if pose is None:
        return mip_composite(density_s, rgb_s, bins, z_mids)

    # the frustum Gaussians in each vehicle's frame: warped origins and directions
    o_dyn = lie.se3_act(pose[:, None, :], rays_o[None])  # [K, R, 3]
    d_dyn = lie.so3_act(pose[:, None, 3:7], viewdirs[None])
    mean_d, cov_d = conical_frustum_to_gaussian(o_dyn[..., None, :], d_dyn[..., None, :],
                                                t0[None], t1[None], cfg.base_radius)
    density_d, rgb_d = apply_mip_field(params["dynamic"], cfg, mean_d, cov_d, d_dyn)
    return mip_composite_star(density_s, rgb_s, density_d.transpose(0, 1),
                              rgb_d.transpose(0, 1), bins, z_mids,
                              with_test_outputs=with_test_outputs)


def render_star_mip(params: Params, cfg: MipConfig, rays_o, rays_d, pose=None,
                    train: bool = True, with_test_outputs: bool = False, u_uni=None, u_pdf=None,
                    generator: Optional[torch.Generator] = None):
    """Uniform pass -> PDF resample -> fine pass over conical frustums; the
    coarse outputs get a "0" suffix. rays_o, rays_d [R, 3]; pose [K, 7] or
    None (the static field alone). In training the bins are jittered by
    u_uni [R, S + 1] and resampled by u_pdf [R, I + 1], drawn from
    ``generator`` when not given; eval (train=False) is deterministic."""
    R = rays_o.shape[0]
    dev = rays_o.device
    assert tuple(rays_o.shape) == (R, 3) and tuple(rays_d.shape) == (R, 3)
    if pose is not None:
        assert tuple(pose.shape) == (cfg.num_vehicles, 7), tuple(pose.shape)
    if train:
        if u_uni is None:
            u_uni = torch.rand((R, cfg.n_samples + 1), generator=generator, device=dev)
        if u_pdf is None and cfg.n_importance > 0:
            u_pdf = torch.rand((R, cfg.n_importance + 1), generator=generator, device=dev)
    else:
        u_uni = u_pdf = None
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    bins = uniform_frustum_bins(R, cfg.near, cfg.far, cfg.n_samples, u=u_uni, device=dev)
    coarse = _eval_pass(params, cfg, rays_o, viewdirs, bins, pose, with_test_outputs)
    result = {f"{k}0": v for k, v in coarse.items()}
    if cfg.n_importance > 0:
        bins_fine = pdf_frustum_bins(bins, coarse["weights"].detach(), cfg.n_importance, u=u_pdf)
        result.update(_eval_pass(params, cfg, rays_o, viewdirs, bins_fine, pose,
                                 with_test_outputs))
    return result
