"""Time-conditioned NeRF baseline: the no-decomposition model STaR is
compared against, with the normalised frame time as a fourth input
coordinate (PyTorch).

Counterpart of startrax/models/nerf_time.py. One field pair (coarse, fine)
of the static field's shape with input_dims 4: the points' encoding is
4 x (1 + 2 multires) wide (84 at multires 10), so the fields run the fused
kernels' pre-encoded mode (models/fields.apply_field with ``time``).
Randomness is explicit, as in models/star.render_star.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import resolve
from ..ops.compositing import raw2outputs
from ..ops.sampling import hierarchical_z_vals, pts_from_z, stratified_z_vals
from .fields import FieldConfig, apply_field, init_field
from .star import StarConfig

Params = Dict[str, Any]


def time_field_cfg(cfg: StarConfig, fine: bool) -> FieldConfig:
    return dataclasses.replace(cfg.static_field(fine), input_dims=4)


def init_nerf_time(cfg: StarConfig, generator: Optional[torch.Generator] = None,
                   device=None) -> Params:
    """{"coarse", "fine"} field params; device=None is the card
    (device.resolve)."""
    device = resolve(device)
    return {"coarse": init_field(time_field_cfg(cfg, False), generator, device),
            "fine": init_field(time_field_cfg(cfg, True), generator, device)}


def render_nerf_time(params: Params, cfg: StarConfig, rays_o, rays_d, frame, num_frames: int,
                     train: bool = True, u_strat=None, u_pdf=None,
                     generator: Optional[torch.Generator] = None):
    """Coarse -> importance resample -> fine render of a ray batch at one
    frame, time = frame / (num_frames - 1). Coarse outputs get a "0" suffix,
    fine outputs keep bare names, and z_std is the spread of the importance
    samples. In training, u_strat [R, S] and u_pdf [R, I] default to draws
    from ``generator``; eval (train=False) is deterministic."""
    R = rays_o.shape[0]
    dev = rays_o.device
    assert tuple(rays_o.shape) == (R, 3) and tuple(rays_d.shape) == (R, 3)
    time = torch.as_tensor(frame, dtype=torch.float32, device=dev) / (num_frames - 1)
    if train:
        if u_strat is None and cfg.perturb > 0:
            u_strat = torch.rand((R, cfg.n_samples), generator=generator, device=dev)
        if u_pdf is None and cfg.n_importance > 0:
            u_pdf = torch.rand((R, cfg.n_importance), generator=generator, device=dev)
    else:
        u_strat = u_pdf = None

    z_vals = stratified_z_vals(R, cfg.near, cfg.far, cfg.n_samples, lindisp=cfg.lindisp,
                               perturb=cfg.perturb if train else 0.0, u=u_strat, device=dev)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = pts_from_z(rays_o, rays_d, z_vals)
    raw_alpha, raw_rgb = apply_field(params["coarse"], time_field_cfg(cfg, False), pts, viewdirs,
                                     time=time)
    result_coarse = raw2outputs(raw_alpha, raw_rgb, z_vals, rays_d, white_bkgd=cfg.white_bkgd,
                                far_dist=cfg.far_dist)
    result = {f"{k}0": v for k, v in result_coarse.items()}
    if cfg.n_importance > 0:
        z_union, z_samples = hierarchical_z_vals(z_vals, result_coarse["weights"],
                                                 cfg.n_importance, u=u_pdf,
                                                 stratified=cfg.stratified_fine)
        pts_fine = pts_from_z(rays_o, rays_d, z_union)
        raw_alpha_f, raw_rgb_f = apply_field(params["fine"], time_field_cfg(cfg, True), pts_fine,
                                             viewdirs, time=time)
        result.update(raw2outputs(raw_alpha_f, raw_rgb_f, z_union, rays_d,
                                  white_bkgd=cfg.white_bkgd, far_dist=cfg.far_dist))
        result["z_std"] = torch.std(z_samples, dim=-1, correction=0)
    return result
