"""Training steps for appearance init, online tracking and the
time-conditioned baseline (PyTorch).

Counterpart of startrax/train/loop.py. A step renders the batch (coarse and
fine, all fields), computes the losses, backpropagates and applies one
optimizer step. Parameters are leaf tensors updated in place; the step
returns the loss and the logged metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import resolve
from ..models.nerf_time import render_nerf_time
from ..models.star import StarConfig, init_star, render_star
from ..ops import lie
from ..ops.losses import depth_loss as depth_loss_fn
from ..ops.losses import img2mse, mse2psnr
from ..ops.losses import sigma_loss as sigma_loss_fn
from ..utils.profiling import span
from ..utils.tree import tree_leaves, tree_map


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
                   loss_cfg: LossConfig, epoch=None, online: bool = True, group=None):
    """Total loss and logged metrics.

    With a ray group (parallel.mesh.RayGroup) the batch is this rank's
    shard and the loss is this rank's share: the plain means over the ray
    axis (mse, the regularizers) are divided by the world size, the masked
    means (depth, sigma) divide by the whole batch's mask count, so that the
    shares sum to the one-process loss. The metrics are then the whole
    batch's values on every rank (one all-reduce of the shares, no grad),
    psnr from the whole batch's mse."""
    with span("train.losses"):
        has_fine = star_cfg.n_importance > 0
        world = 1 if group is None else group.world

        def mse(rgb):
            v = img2mse(rgb, batch["target"])
            return v if group is None else v / world

        img_loss0 = mse(result["rgb0"])
        loss = img_loss0
        metrics = {"loss0": img_loss0}
        if has_fine:
            img_loss = mse(result["rgb"])
            loss = loss + img_loss
            metrics["fine_loss"] = img_loss
        else:
            metrics["fine_loss"] = img_loss0

        if online:
            reg_terms = {
                "alpha_entropy": loss_cfg.lambda_alpha_entropy,
                "dynamic_vs_static_reg": loss_cfg.lambda_dynamic_vs_static_reg,
                "ray_reg": loss_cfg.lambda_ray_reg,
                "static_reg": loss_cfg.lambda_static_reg,
                "dynamic_reg": loss_cfg.lambda_dynamic_reg,
            }
            for name, lam in reg_terms.items():
                if lam > 0:
                    v = _coarse_fine_avg(result, f"loss_{name}", has_fine)
                    if group is not None:
                        v = v / world
                    if name == "dynamic_reg" and epoch is not None:
                        lam = lam * float(epoch >= loss_cfg.epoch_start_dynamic_reg)
                    loss = loss + lam * v
                    metrics[name] = v

        # supervision attaches to the fine outputs when they exist
        suff = "" if has_fine else "0"
        if loss_cfg.use_depth_loss:
            dl = depth_loss_fn(result["depth" + suff], batch["target_depth"],
                               star_cfg.near, star_cfg.far, group=group)
            loss = loss + loss_cfg.depth_lambda * dl
            metrics["depth_loss"] = dl
        if loss_cfg.use_sigma_loss:
            sl = sigma_loss_fn(result["weights" + suff], result["z_vals" + suff],
                               result["dists" + suff], batch["target_depth"], star_cfg.near,
                               star_cfg.far, max_dist=0.5 * star_cfg.far_dist, group=group)
            loss = loss + loss_cfg.sigma_lambda * sl
            metrics["sigma_loss"] = sl
        metrics["loss"] = loss
        metrics = reduce_metrics(metrics, group)
        metrics["psnr0"] = mse2psnr(metrics["loss0"])
        if has_fine:
            metrics["psnr"] = mse2psnr(metrics["fine_loss"])
        return loss, metrics


def reduce_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The scalar metrics detached; with a ray group, each summed over the
    ranks in one all-reduce (every rank gets the whole batch's values)."""
    out = {k: v.detach() for k, v in metrics.items()}
    if group is None:
        return out
    total = group.all_reduce(torch.stack([v.reshape(()) for v in out.values()]))
    return dict(zip(out, total.unbind()))


def _shard(opt):
    """(rank, world) of the ray group the optimizer reduces its grads over,
    or None: where a step draws its random numbers at the whole batch's
    shape."""
    g = opt.ray_group
    return None if g is None else (g.rank, g.world)


def gather_frame_pose(poses, frame, num_vehicles: int):
    """Pose of a frame; frame 0 is pinned to identity. poses: [F-1, K, 7]
    learnable; frame: an int (-> [K, 7]) or an [R] integer tensor of per-ray
    frames (a mixed-frame batch, -> [R, K, 7]). The gradient of a per-ray
    pose scatter-adds back into its frame's row."""
    pose0 = lie.se3_identity(1, num_vehicles, dtype=poses.dtype, device=poses.device)
    if torch.is_tensor(frame):
        frame = frame.to(device=poses.device, dtype=torch.long)
    return torch.cat([pose0, poses], dim=0)[frame]


def init_online_params(star_cfg: StarConfig, num_frames: int,
                       generator: Optional[torch.Generator] = None, device=None,
                       init_poses=None):
    """{"nerf": field params, "poses": [F-1, K, 7]} as leaf tensors that
    require grad; poses start at identity unless init_poses is given.
    device=None is the card (device.resolve)."""
    device = resolve(device)
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
    generator=None) -> (loss, metrics), updating params and opt in place;
    step.opt is opt. batch["frame"] is an int, or an [R] tensor of per-ray
    frames. When opt reduces its grads over a ray group (opt.ray_group), the
    batch is this rank's shard: the loss is its share (compute_losses), the
    draws are made at the whole batch's shape (models.star.render_star's
    shard), and the returned loss and metrics are the whole batch's.

    trans_only pins every quaternion to identity and optimises translations
    only; freeze_rot keeps each pose's current rotation. In both, the
    rotation grads are zeroed before the optimizer so the Adam moments stay
    untouched. Otherwise quaternions are renormalised after each optimizer
    step, whether or not it emitted an update (gradient accumulation)."""

    def train_step(params, batch, epoch=0, u_strat=None, u_pdf=None, generator=None):
        with span("train.step"):
            poses = params["poses"]
            q_before = poses.detach()[..., 3:7].clone()
            opt.zero_grad()
            with span("train.forward"):
                pose = gather_frame_pose(poses, batch["frame"], star_cfg.num_vehicles)
                result = render_star(params["nerf"], star_cfg, batch["rays_o"], batch["rays_d"],
                                     pose=pose, train=True, step=epoch, u_strat=u_strat,
                                     u_pdf=u_pdf, generator=generator, shard=_shard(opt))
                loss, metrics = compute_losses(result, batch, star_cfg, loss_cfg, epoch=epoch,
                                               online=True, group=opt.ray_group)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"), torch.no_grad():
                if (trans_only or freeze_rot) and poses.grad is not None:
                    poses.grad[..., 3:7] = 0.0
                opt.step()
                if trans_only:
                    poses[..., 3:7] = poses.new_tensor([0.0, 0.0, 0.0, 1.0])
                elif freeze_rot:
                    poses[..., 3:7] = q_before
                else:
                    poses[..., 3:7] = lie.quat_normalize(poses[..., 3:7])
        return metrics["loss"], metrics

    train_step.opt = opt  # what a measurement reads of the step's optimizer
    return train_step


def batch_kind(batch) -> str:
    """"per_ray" for a batch of per-ray frames (an [R] tensor), "shared" for
    a batch at one frame (an int)."""
    return "per_ray" if torch.is_tensor(batch["frame"]) else "shared"


def make_gauge_train_step(star_cfg: StarConfig, opt, freeze_rot: bool = False,
                          depth_lambda: float = 0.0):
    """Fit of one shared per-vehicle SE(3) gauge G [K, 7] (the gauge_align
    polish of apps/online.py): each ray is rendered with pose G ∘ p_f, where
    p_f is its frame's pose, against fixed fields and poses. The loss is the
    photometric MSE (coarse + fine), plus depth_lambda times the depth loss
    when the batch carries target_depth. freeze_rot zeroes the quaternion's
    grad before the optimizer, so it stays at its value and its Adam moments
    at zero.

    Returns step(gauge, nerf, poses, batch, u_strat=None, u_pdf=None,
    generator=None) -> loss, updating the gauge (a leaf that requires grad)
    and opt in place. The fields and poses are read detached: no grad of
    theirs is formed, and their .grad stays as it was. Over a ray group
    (opt.ray_group) the loss is reduced as make_online_train_step's is."""

    def gauge_step(gauge, nerf, poses, batch, u_strat=None, u_pdf=None, generator=None):
        with span("train.step"):
            opt.zero_grad()
            group = opt.ray_group
            with span("train.forward"):
                fixed = tree_map(torch.Tensor.detach, nerf)
                pose_f = gather_frame_pose(poses.detach(), batch["frame"], star_cfg.num_vehicles)
                pose_c = lie.se3_multiply(gauge.expand(pose_f.shape), pose_f)
                result = render_star(fixed, star_cfg, batch["rays_o"], batch["rays_d"],
                                     pose=pose_c, train=True, u_strat=u_strat, u_pdf=u_pdf,
                                     generator=generator, shard=_shard(opt))
                has_fine = star_cfg.n_importance > 0
                world = 1 if group is None else group.world
                loss = img2mse(result["rgb0"], batch["target"])
                if has_fine:
                    loss = loss + img2mse(result["rgb"], batch["target"])
                if group is not None:
                    loss = loss / world
                if depth_lambda > 0 and "target_depth" in batch:
                    loss = loss + depth_lambda * depth_loss_fn(
                        result["depth" if has_fine else "depth0"], batch["target_depth"],
                        star_cfg.near, star_cfg.far, group=group)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"), torch.no_grad():
                if freeze_rot:
                    gauge.grad[..., 3:7] = 0.0
                opt.step()
                gauge[..., 3:7] = lie.quat_normalize(gauge[..., 3:7])
        return reduce_metrics({"loss": loss}, group)["loss"]

    return gauge_step


def make_appinit_train_step(star_cfg: StarConfig, loss_cfg: LossConfig, opt):
    """Appearance-init step: static field only, photometric (+ depth/sigma)
    loss. Returns step(params, batch, u_strat=None, u_pdf=None,
    generator=None) -> (loss, metrics); over a ray group (opt.ray_group) as
    make_online_train_step, the density noise drawn at the whole batch's
    shape too."""

    def train_step(params, batch, u_strat=None, u_pdf=None, generator=None):
        with span("train.step"):
            opt.zero_grad()
            with span("train.forward"):
                result = render_star(params, star_cfg, batch["rays_o"], batch["rays_d"],
                                     pose=None, train=True, u_strat=u_strat, u_pdf=u_pdf,
                                     generator=generator, shard=_shard(opt))
                loss, metrics = compute_losses(result, batch, star_cfg, loss_cfg, online=False,
                                               group=opt.ray_group)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                opt.step()
        return metrics["loss"], metrics

    return train_step


def make_nerf_time_train_step(star_cfg: StarConfig, loss_cfg: LossConfig, opt, num_frames: int):
    """The time-conditioned baseline's step (``step_fn`` of
    startrax/apps/nerf_time.py): render the batch at its frame, the
    photometric (+ depth/sigma) loss, one optimizer step; opt as
    train.optim.make_appinit_optimizer builds it over the coarse and fine
    fields. Returns step(params, batch, u_strat=None, u_pdf=None,
    generator=None) -> (loss, metrics); batch["frame"] is the batch's
    frame, an int or a 0-d tensor."""

    def train_step(params, batch, u_strat=None, u_pdf=None, generator=None):
        with span("train.step"):
            opt.zero_grad()
            with span("train.forward"):
                result = render_nerf_time(params, star_cfg, batch["rays_o"], batch["rays_d"],
                                          batch["frame"], num_frames, train=True,
                                          u_strat=u_strat, u_pdf=u_pdf, generator=generator)
                loss, metrics = compute_losses(result, batch, star_cfg, loss_cfg, online=False)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                opt.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_render(star_cfg: StarConfig, with_test_outputs: bool = False):
    """Deterministic (eval-mode) renderer over a ray batch: returns
    eval_render(params, rays_o, rays_d, pose) -> render_star's outputs,
    under torch.no_grad with train=False (no jitter, no noise, no graph)."""

    @torch.no_grad()
    def eval_render(params, rays_o, rays_d, pose):
        return render_star(params, star_cfg, rays_o, rays_d, pose=pose, train=False,
                           with_test_outputs=with_test_outputs)

    return eval_render
