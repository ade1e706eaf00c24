"""Training steps for appearance init and online tracking (PyTorch).

Counterpart of startrax/train/loop.py. A step renders the batch (coarse and
fine, all fields), computes the losses, backpropagates and applies one
optimizer step. Parameters are leaf tensors updated in place; the step
returns the loss and the logged metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..models.star import StarConfig, init_star, render_star
from ..ops import lie
from ..ops.losses import depth_loss as depth_loss_fn
from ..ops.losses import img2mse, mse2psnr
from ..ops.losses import sigma_loss as sigma_loss_fn
from ..utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Regularizer weights and depth supervision."""

    lambda_alpha_entropy: float = 0.0
    lambda_dynamic_vs_static_reg: float = 0.0
    lambda_ray_reg: float = 0.0
    lambda_static_reg: float = 0.0
    lambda_dynamic_reg: float = 0.0
    epoch_start_dynamic_reg: int = 0
    use_depth_loss: bool = False
    depth_lambda: float = 0.0
    use_sigma_loss: bool = False
    sigma_lambda: float = 0.0


def _coarse_fine_avg(result, name, has_fine):
    v = result[f"{name}0"]
    if has_fine:
        v = (v + result[name]) / 2.0
    return v


def compute_losses(result: Dict[str, Any], batch: Dict[str, Any], star_cfg: StarConfig,
                   loss_cfg: LossConfig, epoch=None, online: bool = True):
    """Total loss and logged metrics."""
    has_fine = star_cfg.n_importance > 0
    target = batch["target"]
    img_loss0 = img2mse(result["rgb0"], target)
    loss = img_loss0
    metrics = {"loss0": img_loss0, "psnr0": mse2psnr(img_loss0)}
    if has_fine:
        img_loss = img2mse(result["rgb"], target)
        loss = loss + img_loss
        metrics["fine_loss"] = img_loss
        metrics["psnr"] = mse2psnr(img_loss)
    else:
        metrics["fine_loss"] = img_loss0

    if online:
        reg_terms = {
            "alpha_entropy": loss_cfg.lambda_alpha_entropy,
            "dynamic_vs_static_reg": loss_cfg.lambda_dynamic_vs_static_reg,
            "ray_reg": loss_cfg.lambda_ray_reg,
            "static_reg": loss_cfg.lambda_static_reg,
        }
        for name, lam in reg_terms.items():
            if lam > 0:
                v = _coarse_fine_avg(result, f"loss_{name}", has_fine)
                loss = loss + lam * v
                metrics[name] = v
        if loss_cfg.lambda_dynamic_reg > 0:
            v = _coarse_fine_avg(result, "loss_dynamic_reg", has_fine)
            gate = 1.0 if epoch is None else float(epoch >= loss_cfg.epoch_start_dynamic_reg)
            loss = loss + loss_cfg.lambda_dynamic_reg * gate * v
            metrics["dynamic_reg"] = v

    # supervision attaches to the fine outputs when they exist
    suff = "" if has_fine else "0"
    if loss_cfg.use_depth_loss:
        dl = depth_loss_fn(result["depth" + suff], batch["target_depth"],
                           star_cfg.near, star_cfg.far)
        loss = loss + loss_cfg.depth_lambda * dl
        metrics["depth_loss"] = dl
    if loss_cfg.use_sigma_loss:
        sl = sigma_loss_fn(result["weights" + suff], result["z_vals" + suff],
                           result["dists" + suff], batch["target_depth"], star_cfg.near,
                           star_cfg.far, max_dist=0.5 * star_cfg.far_dist)
        loss = loss + loss_cfg.sigma_lambda * sl
        metrics["sigma_loss"] = sl
    metrics["loss"] = loss
    return loss, metrics


def gather_frame_pose(poses, frame: int, num_vehicles: int):
    """Pose of a frame; frame 0 is pinned to identity. poses: [F-1, K, 7]
    learnable -> [K, 7]."""
    pose0 = lie.se3_identity(1, num_vehicles, dtype=poses.dtype, device=poses.device)
    return torch.cat([pose0, poses], dim=0)[frame]


def init_online_params(star_cfg: StarConfig, num_frames: int,
                       generator: Optional[torch.Generator] = None, device=None,
                       init_poses=None):
    """{"nerf": field params, "poses": [F-1, K, 7]} as leaf tensors that
    require grad; poses start at identity unless init_poses is given."""
    nerf = init_star(star_cfg, generator, device)
    if init_poses is None:
        poses = lie.se3_identity(num_frames - 1, star_cfg.num_vehicles, device=device)
    else:
        poses = torch.as_tensor(init_poses, dtype=torch.float32, device=device).clone()
    params = {"nerf": nerf, "poses": poses}
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def make_online_train_step(star_cfg: StarConfig, loss_cfg: LossConfig, opt,
                           trans_only: bool = False, freeze_rot: bool = False):
    """Returns step(params, batch, epoch=0, u_strat=None, u_pdf=None,
    generator=None) -> (loss, metrics), updating params and opt in place.

    trans_only pins every quaternion to identity and optimises translations
    only; freeze_rot keeps each pose's current rotation. In both, the
    rotation grads are zeroed before the optimizer so the Adam moments stay
    untouched. Otherwise quaternions are renormalised after each update."""

    def train_step(params, batch, epoch=0, u_strat=None, u_pdf=None, generator=None):
        poses = params["poses"]
        q_before = poses.detach()[..., 3:7].clone()
        opt.zero_grad()
        pose = gather_frame_pose(poses, int(batch["frame"]), star_cfg.num_vehicles)
        result = render_star(params["nerf"], star_cfg, batch["rays_o"], batch["rays_d"],
                             pose=pose, train=True, step=epoch, u_strat=u_strat, u_pdf=u_pdf,
                             generator=generator)
        loss, metrics = compute_losses(result, batch, star_cfg, loss_cfg, epoch=epoch,
                                       online=True)
        loss.backward()
        with torch.no_grad():
            if (trans_only or freeze_rot) and poses.grad is not None:
                poses.grad[..., 3:7] = 0.0
            opt.step()
            if trans_only:
                poses[..., 3:7] = poses.new_tensor([0.0, 0.0, 0.0, 1.0])
            elif freeze_rot:
                poses[..., 3:7] = q_before
            else:
                poses[..., 3:7] = lie.quat_normalize(poses[..., 3:7])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_appinit_train_step(star_cfg: StarConfig, loss_cfg: LossConfig, opt):
    """Appearance-init step: static field only, photometric (+ depth/sigma)
    loss. Returns step(params, batch, u_strat=None, u_pdf=None,
    generator=None) -> (loss, metrics)."""

    def train_step(params, batch, u_strat=None, u_pdf=None, generator=None):
        opt.zero_grad()
        result = render_star(params, star_cfg, batch["rays_o"], batch["rays_d"], pose=None,
                             train=True, u_strat=u_strat, u_pdf=u_pdf, generator=generator)
        loss, metrics = compute_losses(result, batch, star_cfg, loss_cfg, online=False)
        loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step
