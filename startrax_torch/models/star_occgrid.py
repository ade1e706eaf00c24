"""Occupancy-grid STaR: a static and K dynamic radiance fields of equal
depth, rendered with empty-space-skipped marching (PyTorch).

Counterpart of startrax/models/star_occgrid.py: the static field and the
stack of K dynamic fields share one architecture (StarConfig.static_field,
unlike the main STaR's half-depth dynamic fields); a pose [K, 7] warps the
sample points into each vehicle's frame (models/star.warp_to_vehicle_frames)
and the K dynamic fields run through apply_stacked_fields, one field-axis
launch on the card. The march is kernels/occgrid.march_and_select; its
invalid slots composite with alpha 0.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve
from ..kernels import occgrid
from ..ops.compositing import raw2outputs, raw2outputs_star
from .fields import (FieldConfig, _down_dirs, apply_field, apply_stacked_fields, init_field,
                     init_stacked_fields)
from .star import StarConfig, warp_to_vehicle_frames

Params = Dict[str, Any]


def _pair_field_cfg(cfg: StarConfig) -> FieldConfig:
    return cfg.static_field()


def init_star_occgrid(cfg: StarConfig, generator: Optional[torch.Generator] = None,
                      device=None) -> Params:
    """{"static": field, "dynamic": K stacked fields}; device=None is the card
    (device.resolve)."""
    device = resolve(device)
    fcfg = _pair_field_cfg(cfg)
    return {"static": init_field(fcfg, generator, device),
            "dynamic": init_stacked_fields(fcfg, cfg.num_vehicles, generator, device)}


def joint_density_fn(params: Params, cfg: StarConfig, pose=None):
    """pts [N, 3] -> world-space density [N] of the static field plus, with
    a pose [K, 7], the K warped dynamic fields (post-softplus), each point
    seen along (0, 0, -1): the density an occupancy-grid update reads."""
    fcfg = _pair_field_cfg(cfg)

    def fn(pts):
        dirs = _down_dirs(pts)
        raw_s, _ = apply_field(params["static"], fcfg, pts[:, None, :], dirs)
        sigma = F.softplus(raw_s[:, 0])
        if pose is not None:
            pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, pts[:, None, :], dirs)
            raw_d, _ = apply_stacked_fields(params["dynamic"], fcfg, pts_dyn, dirs_dyn)
            sigma = sigma + torch.sum(F.softplus(raw_d[:, :, 0]), dim=0)
        return sigma

    return fn


def render_star_occgrid(params: Params, cfg: StarConfig, grid: Dict[str, Any],
                        occ_cfg: occgrid.OccGridConfig, rays_o, rays_d, pose=None, u=None,
                        generator: Optional[torch.Generator] = None,
                        with_test_outputs: bool = False):
    """Occupancy-skipped render of the static and dynamic pair.

    pose=None renders the static field alone (raw2outputs); a pose [K, 7]
    composites the pair under the joint transmittance (raw2outputs_star).
    The march is jittered by u [R, n_march], or by draws from ``generator``;
    with neither it is not. The outputs gain n_occupied [R] and valid
    [R, n_selected]."""
    n_rays = rays_o.shape[0]
    assert tuple(rays_o.shape) == (n_rays, 3) and tuple(rays_d.shape) == (n_rays, 3)
    if pose is not None:
        assert tuple(pose.shape) == (cfg.num_vehicles, 7), tuple(pose.shape)

    z_sel, valid, n_occ = occgrid.march_and_select(grid, occ_cfg, rays_o, rays_d, cfg.near,
                                                   cfg.far, u=u, generator=generator)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]

    fcfg = _pair_field_cfg(cfg)
    raw_alpha_s, raw_rgb_s = apply_field(params["static"], fcfg, pts, viewdirs)
    raw_alpha_s = occgrid.masked_raw_alpha(raw_alpha_s, valid)
    if pose is None:
        out = raw2outputs(raw_alpha_s, raw_rgb_s, z_sel, rays_d, white_bkgd=cfg.white_bkgd,
                          far_dist=cfg.far_dist)
    else:
        pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, pts, viewdirs)
        raw_alpha_d, raw_rgb_d = apply_stacked_fields(params["dynamic"], fcfg, pts_dyn, dirs_dyn)
        raw_alpha_d = occgrid.masked_raw_alpha(raw_alpha_d, valid[None])  # [K, R, S]
        out = raw2outputs_star(raw_alpha_s, raw_rgb_s, raw_alpha_d.transpose(0, 1),
                               raw_rgb_d.transpose(0, 1), z_sel, rays_d,
                               white_bkgd=cfg.white_bkgd, far_dist=cfg.far_dist,
                               with_test_outputs=with_test_outputs,
                               reference_numerics=cfg.reference_numerics)
    out["n_occupied"] = n_occ
    out["valid"] = valid
    return out
