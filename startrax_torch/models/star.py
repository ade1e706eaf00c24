"""The STaR network: one static radiance field + K rigid dynamic fields,
composited under a joint transmittance, with differentiable SE(3) pose
warps (PyTorch).

Counterpart of startrax/models/star.py. Randomness is explicit: the
stratified jitter ``u_strat [R, S]`` and the importance-sampling uniforms
``u_pdf [R, I]`` are passed in, or drawn from ``generator`` on the rays'
device; on a rank's shard of a batch (``shard``) the draws are made at the
whole batch's shape and the shard's rows kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve
from ..ops import lie
from ..ops.compositing import raw2outputs, raw2outputs_star
from ..ops.sampling import hierarchical_z_vals, pts_from_z, stratified_z_vals
from .fields import (
    FieldConfig,
    apply_field,
    apply_stacked_fields,
    field_slice,
    init_field,
    init_stacked_fields,
    resolve_use_fused,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StarConfig:
    """Model and rendering configuration (mirrors the reference's flags)."""

    num_vehicles: int = 1
    netdepth: int = 8
    netdepth_fine: int = 8
    netwidth: int = 256
    netwidth_fine: int = 256
    multires: int = 10
    multires_views: int = 4
    n_samples: int = 256
    n_importance: int = 256
    near: float = 3.0
    far: float = 80.0
    far_dist: float = 1e10
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    perturb: float = 1.0
    end_barf: int = -1
    compute_dtype: Any = torch.bfloat16
    use_fused: Optional[bool] = None  # None = auto (fused kernels for CUDA tensors)
    # sum raw densities before the softplus for the joint alpha, as the
    # reference does, instead of summing post-softplus densities
    reference_numerics: bool = False
    # stratified (ascending) importance-sample uniforms instead of iid ones
    stratified_fine: bool = True

    def static_field(self, fine: bool = False) -> FieldConfig:
        return FieldConfig(
            depth=self.netdepth_fine if fine else self.netdepth,
            width=self.netwidth_fine if fine else self.netwidth,
            multires=self.multires,
            multires_views=self.multires_views,
            end_barf=self.end_barf,
            compute_dtype=self.compute_dtype,
            use_fused=self.use_fused,
        )

    def dynamic_field(self, fine: bool = False) -> FieldConfig:
        # dynamic fields are half depth
        cfg = self.static_field(fine)
        return dataclasses.replace(cfg, depth=cfg.depth // 2)


def init_star(cfg: StarConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Params:
    """The static and K dynamic fields, coarse and fine; device=None is the
    card (device.resolve)."""
    device = resolve(device)
    params: Params = {
        "static_coarse": init_field(cfg.static_field(), generator, device),
        "dynamic_coarse": init_stacked_fields(cfg.dynamic_field(), cfg.num_vehicles,
                                              generator, device),
    }
    if cfg.n_importance > 0:
        params["static_fine"] = init_field(cfg.static_field(fine=True), generator, device)
        params["dynamic_fine"] = init_stacked_fields(cfg.dynamic_field(fine=True),
                                                     cfg.num_vehicles, generator, device)
    return params


def warp_to_vehicle_frames(pose, pts, viewdirs):
    """World points [R, S, 3] and view directions [R, 3] -> each vehicle's
    frame: (pts_dyn [K, R, S, 3], viewdirs_dyn [K, R, 3]). pose: [K, 7]
    shared by all rays, or [R, K, 7] per ray."""
    if pose.dim() == 3:
        pose = pose.transpose(0, 1)  # [K, R, 7]
        pts_dyn = lie.se3_act(pose[:, :, None, :], pts[None])
        dirs_dyn = lie.so3_act(pose[:, :, 3:7], viewdirs[None])
    else:
        pts_dyn = lie.se3_act(pose[:, None, None, :], pts[None])
        dirs_dyn = lie.so3_act(pose[:, None, 3:7], viewdirs[None])
    return pts_dyn, dirs_dyn


def pack_warp(pose7):
    """SE(3) 7-vector -> packed [16] kernel warp (M row-major, t, zeros)."""
    M = lie.quat_to_matrix(pose7[3:7])
    return torch.cat([M.reshape(9), pose7[:3], pose7.new_zeros(4)])


def _apply_dynamic(params, cfg: FieldConfig, pose, pts, viewdirs, step):
    """K dynamic fields on world points -> ([K, R, S], [K, R, S, 3]).

    A shared pose [K, 7] on the fused kernels warps inside the kernel, one
    launch per vehicle. A per-ray pose [R, K, 7] (mixed-frame batches), and
    every pose on the plain path, warps the points outside and evaluates the
    K fields through apply_stacked_fields; the pose grad then comes back
    through the points' and directions' grads."""
    if pose.dim() == 2 and resolve_use_fused(cfg, pts.device):
        outs = [apply_field(field_slice(params, k), cfg, pts, viewdirs, step=step,
                            warp=pack_warp(pose[k]))
                for k in range(pose.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, pts, viewdirs)
    return apply_stacked_fields(params, cfg, pts_dyn, dirs_dyn, step=step)


def apply_star(params: Params, cfg: StarConfig, pts, viewdirs, z_vals, rays_d, pose=None,
               is_coarse: bool = True, step=None, noise=None, with_test_outputs: bool = False):
    """One coarse or fine pass. pose=None is the appearance-init path (static
    field only, with optional density noise); otherwise pose is [K, 7] (or
    [R, K, 7]) and the static and K dynamic fields composite jointly."""
    static_params = params["static_coarse"] if is_coarse else params["static_fine"]
    raw_alpha_s, raw_rgb_s = apply_field(static_params, cfg.static_field(fine=not is_coarse),
                                         pts, viewdirs)
    if pose is None:
        return raw2outputs(raw_alpha_s, raw_rgb_s, z_vals, rays_d, noise=noise,
                           white_bkgd=cfg.white_bkgd, far_dist=cfg.far_dist)
    dyn_params = params["dynamic_coarse"] if is_coarse else params["dynamic_fine"]
    raw_alpha_d, raw_rgb_d = _apply_dynamic(dyn_params, cfg.dynamic_field(fine=not is_coarse),
                                            pose, pts, viewdirs, step)
    return raw2outputs_star(
        raw_alpha_s, raw_rgb_s, raw_alpha_d.transpose(0, 1), raw_rgb_d.transpose(0, 1),
        z_vals, rays_d, white_bkgd=cfg.white_bkgd, far_dist=cfg.far_dist,
        with_test_outputs=with_test_outputs, reference_numerics=cfg.reference_numerics)


def render_star(params: Params, cfg: StarConfig, rays_o, rays_d, pose=None, train: bool = True,
                step=None, with_test_outputs: bool = False, u_strat=None, u_pdf=None,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Tuple[int, int]] = None):
    """Coarse -> importance resample -> fine render of a ray batch.

    Coarse outputs get a "0" suffix, fine outputs keep bare names, and z_std
    is the spread of the importance samples. In training, u_strat [R, S] and
    u_pdf [R, I] default to draws from ``generator``, as does the
    appearance-init density noise; with shard = (rank, world) the rays are
    rank's rows of a batch of world * R rays, and each draw is made at that
    whole batch's shape and rank's rows kept, so that the ranks together
    draw what one process draws for the whole batch. Eval (train=False) is
    deterministic."""
    R = rays_o.shape[0]
    dev = rays_o.device
    rank, world = (0, 1) if shard is None else shard

    def draw(sample, cols):
        return sample((R * world, cols), generator=generator, device=dev)[rank * R:(rank + 1) * R]

    assert tuple(rays_o.shape) == (R, 3) and tuple(rays_d.shape) == (R, 3)
    if pose is not None:
        K = cfg.num_vehicles
        assert tuple(pose.shape) in ((K, 7), (R, K, 7)), tuple(pose.shape)
    if train:
        if u_strat is None and cfg.perturb > 0:
            u_strat = draw(torch.rand, cfg.n_samples)
        if u_pdf is None and cfg.n_importance > 0:
            u_pdf = draw(torch.rand, cfg.n_importance)
    else:
        u_strat = u_pdf = None

    def noise_like(n_samples):
        if not train or pose is not None or cfg.raw_noise_std <= 0:
            return None
        return cfg.raw_noise_std * draw(torch.randn, n_samples)

    z_vals = stratified_z_vals(R, cfg.near, cfg.far, cfg.n_samples, lindisp=cfg.lindisp,
                               perturb=cfg.perturb if train else 0.0, u=u_strat, device=dev)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = pts_from_z(rays_o, rays_d, z_vals)
    result_coarse = apply_star(params, cfg, pts, viewdirs, z_vals, rays_d, pose=pose,
                               is_coarse=True, step=step, noise=noise_like(cfg.n_samples),
                               with_test_outputs=with_test_outputs)
    result = {f"{k}0": v for k, v in result_coarse.items()}
    if cfg.n_importance > 0:
        z_union, z_samples = hierarchical_z_vals(
            z_vals, result_coarse["weights"], cfg.n_importance, u=u_pdf,
            stratified=cfg.stratified_fine)
        pts_fine = pts_from_z(rays_o, rays_d, z_union)
        result_fine = apply_star(params, cfg, pts_fine, viewdirs, z_union, rays_d, pose=pose,
                                 is_coarse=False, step=step,
                                 noise=noise_like(cfg.n_samples + cfg.n_importance),
                                 with_test_outputs=with_test_outputs)
        result.update(result_fine)
        result["z_std"] = torch.std(z_samples, dim=-1, correction=0)
    return result
