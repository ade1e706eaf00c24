"""STaR-mip training and test: appearance init and online tracking with the
integrated-positional-encoding (mip-NeRF) variant (PyTorch).

Counterpart of startrax/apps/mip.py on one device, over models/mip.py's
field, frustum samplers and density-based compositing:

- ``train_app_init``: the static and dynamic mip fields from one init,
  trained on frame 0 (or a Blender capture's views) with the app-init Adam
  and its schedule; an epoch logs train/fine_loss, a {"params"} checkpoint
  every epoch_ckpt epochs; a run stops at appearance_init_thres.
- ``train_online``: {"nerf": mip params, "poses": [F-1, K, 7]}, the static
  field warm-started from appearance_ckpt_path and the poses from the noisy
  GT where noisy_pose_init asks for it; the three-group fused Adam (clip
  1.0, accumulate_grad_batches), the quaternions renormalised after every
  step; the frame curriculum; the pose errors every epoch, a validation
  render every epoch_val epochs and a {"params", "curriculum"} checkpoint
  every epoch_ckpt epochs.
- ``test``: the shared test protocol (apps/test_protocol.run_test_protocol)
  over render_image_mip on the checkpoint at online_ckpt_path.

The mip field runs no fused kernel: its products are torch matmuls, as
startrax computes them with XLA outside any Pallas kernel.

Usage: python -m startrax_torch.apps.mip --config startrax/configs/carla_star_app_init_mip.txt [--key value ...]
(online with --appearance_ckpt_path or --skip_appearance_init true, the
test with --test true --online_ckpt_path <run>/ckpts)
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..eval.image import psnr as psnr_fn
from ..eval.image import ssim as ssim_fn
from ..eval.pose import get_pose_metrics_multi
from ..eval.render import render_image_mip
from ..models import mip
from ..ops import lie
from ..ops.losses import img2mse, mse2psnr
from ..train import checkpoint as ckpt
from ..train import loop, optim
from ..train.curriculum import CurriculumConfig, CurriculumState, advance
from ..utils.config import Config, load_config, loss_config_from
from ..utils.tree import tree_leaves
from .common import Workspace, host_prng, make_dataset
from .test_protocol import check_supported, run_test_protocol


def mip_config_from(cfg: Config) -> mip.MipConfig:
    """The mip field and sampler of a config: near and far in scaled
    units, bf16 matmuls with mixed_precision (else f32)."""
    scale = cfg.scale_factor if cfg.scale_factor > 0 else 1.0
    return mip.MipConfig(
        num_vehicles=cfg.num_vehicles, depth=cfg.netdepth, width=cfg.netwidth,
        num_freqs_pos=cfg.num_freqs_pos, num_freqs_dir=cfg.num_freqs_dir,
        n_samples=cfg.N_samples, n_importance=cfg.N_importance, near=cfg.near * scale,
        far=cfg.far * scale, base_radius=cfg.mip_base_radius,
        compute_dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32)


def _mip_losses(result, batch, loss_cfg, has_fine: bool):
    """Coarse (+ fine) photometric loss plus each regularizer with a
    positive weight that the render gives, averaged over the passes."""
    img_loss0 = img2mse(result["rgb0"], batch["target"])
    loss = img_loss0
    metrics = {"psnr0": mse2psnr(img_loss0)}
    if has_fine:
        img_loss = img2mse(result["rgb"], batch["target"])
        loss = loss + img_loss
        metrics["fine_loss"] = img_loss
        metrics["psnr"] = mse2psnr(img_loss)
    else:
        metrics["fine_loss"] = img_loss0
    for name, lam in (("alpha_entropy", loss_cfg.lambda_alpha_entropy),
                      ("dynamic_vs_static_reg", loss_cfg.lambda_dynamic_vs_static_reg),
                      ("ray_reg", loss_cfg.lambda_ray_reg),
                      ("static_reg", loss_cfg.lambda_static_reg),
                      ("dynamic_reg", loss_cfg.lambda_dynamic_reg)):
        k = f"loss_{name}"
        if lam > 0 and k in result:
            v = result[f"{k}0"]
            if has_fine:
                v = (v + result[k]) / 2.0
            loss = loss + lam * v
            metrics[name] = v
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(mcfg: mip.MipConfig, loss_cfg, opt, online: bool):
    """Returns step(params, batch, u_uni=None, u_pdf=None, generator=None)
    -> (loss, metrics), updating params and opt in place. App init renders
    the static field on the mip params; online renders {"nerf", "poses"}
    at batch["frame"]'s pose and renormalises the quaternions after the
    optimizer step, whether or not it emitted an update."""

    def train_step(params, batch, u_uni=None, u_pdf=None, generator=None):
        opt.zero_grad()
        nerf = params["nerf"] if online else params
        pose = (loop.gather_frame_pose(params["poses"], batch["frame"], mcfg.num_vehicles)
                if online else None)
        out = mip.render_star_mip(nerf, mcfg, batch["rays_o"], batch["rays_d"], pose=pose,
                                  train=True, u_uni=u_uni, u_pdf=u_pdf, generator=generator)
        loss, metrics = _mip_losses(out, batch, loss_cfg, mcfg.n_importance > 0)
        loss.backward()
        with torch.no_grad():
            opt.step()
            if online:
                params["poses"][..., 3:7] = lie.quat_normalize(params["poses"][..., 3:7])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step


def _next_batch(prefetcher, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in next(prefetcher).items()}


def train_app_init(cfg: Config, device=None):
    """Mip appearance init; returns the mip params (leaf tensors on
    ``device``, None: the card)."""
    dev = resolve(device)
    ws = Workspace(cfg, "mip_app_init")
    mcfg = mip_config_from(cfg)
    loss_cfg = loss_config_from(cfg)
    train_data = make_dataset(cfg, "train", dev)

    _, gen = host_prng(cfg.seed, dev)
    params = mip.init_star_mip(mcfg, gen, dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = optim.make_appinit_optimizer(
        params, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch, decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay, decay_milestones=cfg.lrate_decay_steps)
    step_fn = make_train_step(mcfg, loss_cfg, opt, online=False)

    if cfg.dataset_type == "blender":
        def sample_fn(r, st):
            return train_data.sample_batch(r, cfg.N_rand)
    else:
        def sample_fn(r, st):
            return train_data.sample_batch(r, cfg.N_rand, frame=0)
    prefetcher = BatchPrefetcher(sample_fn, {}, seed=cfg.seed * 7919 + 3,
                                 depth=6, workers=max(cfg.num_workers, 1))
    step = 0
    try:
        for epoch in range(cfg.epochs_appearance):
            fine_losses = []
            for _ in range(cfg.steps_per_epoch):
                _, metrics = step_fn(params, _next_batch(prefetcher, dev), generator=gen)
                step += 1
                fine_losses.append(metrics["fine_loss"])  # device scalar, no sync
            avg = float(torch.stack(fine_losses).mean())  # one device read
            ws.metrics.log({"train/fine_loss": avg, "epoch": epoch}, step)
            ws.log(f"epoch {epoch}: fine_loss={avg:.6f}")
            if (epoch + 1) % cfg.epoch_ckpt == 0:
                ckpt.save_checkpoint(ws.ckpt_dir, {"params": params}, step=epoch)
            if avg <= cfg.appearance_init_thres:
                break
    finally:
        prefetcher.close()
    return params


def train_online(cfg: Config, device=None):
    """Mip online tracking; returns {"nerf", "poses"} (leaf tensors on
    ``device``, None: the card)."""
    dev = resolve(device)
    ws = Workspace(cfg, "mip_online")
    mcfg = mip_config_from(cfg)
    loss_cfg = loss_config_from(cfg)
    train_data = make_dataset(cfg, "train", dev)
    val_data = make_dataset(cfg, "val", dev)
    gt_rel = np.swapaxes(train_data.gt_relative_poses(), 0, 1)  # [F, K, 7]
    rng, gen = host_prng(cfg.seed, dev)

    params = {"nerf": mip.init_star_mip(mcfg, gen, dev),
              "poses": lie.se3_identity(cfg.num_frames - 1, mcfg.num_vehicles, device=dev)}
    if cfg.appearance_ckpt_path:
        app = ckpt.restore_checkpoint(cfg.appearance_ckpt_path, device=dev)
        app_params = app["params"] if "params" in app else app
        ckpt.copy_into(params["nerf"]["static"], app_params["static"])
    if cfg.noisy_pose_init and hasattr(train_data, "noisy_gt_relative_poses"):
        noisy = train_data.noisy_gt_relative_poses(rng)
        params["poses"] = torch.as_tensor(np.swapaxes(noisy, 0, 1)[1:], dtype=torch.float32,
                                          device=dev).contiguous()
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)

    opt = optim.make_fused_star_optimizer(
        params, lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
        lrate_pose=cfg.lrate_pose, steps_per_epoch=cfg.steps_per_epoch,
        decay_rate=cfg.lrate_decay_rate, decay_milestones=cfg.lrate_decay_steps, grad_clip=1.0,
        accumulate_steps=cfg.accumulate_grad_batches)
    step_fn = make_train_step(mcfg, loss_cfg, opt, online=True)

    cur_cfg = CurriculumConfig(num_frames=cfg.num_frames,
                               initial_num_frames=cfg.initial_num_frames,
                               online_thres=cfg.online_thres,
                               min_epochs_between=cfg.epochs_between_frames,
                               tightened_thres=cfg.online_thres_tightened)
    cur = CurriculumState.initial(cur_cfg)
    # current_frame = num_frames + 1 once the curriculum is done
    sample_state = {"start": cur.start_frame, "end": min(cur.current_frame, cfg.num_frames)}
    prefetcher = BatchPrefetcher(
        lambda r, st: train_data.sample_batch(r, cfg.N_rand, start_frame=st["start"],
                                              current_frame=st["end"]),
        sample_state, seed=cfg.seed * 7919 + 4, depth=6, workers=max(cfg.num_workers, 1))

    step = 0
    try:
        for epoch in range(cfg.epochs_online):
            sample_state.update(start=cur.start_frame, end=min(cur.current_frame, cfg.num_frames))
            fine_losses = []
            for _ in range(cfg.steps_per_epoch):
                _, metrics = step_fn(params, _next_batch(prefetcher, dev), generator=gen)
                step += 1
                fine_losses.append(metrics["fine_loss"])  # device scalar, no sync
            avg = float(torch.stack(fine_losses).mean())  # one device read
            cur = advance(cur, cur_cfg, avg)
            trans_err, rot_err, *_ = get_pose_metrics_multi(
                params["poses"].detach().cpu().numpy(), gt_rel[1:])
            ws.metrics.log(
                {"train/fine_loss": avg, "train/current_frame_num": cur.current_frame,
                 "epoch": epoch,
                 **{f"train/trans_error_{k}": float(v) for k, v in enumerate(trans_err)},
                 **{f"train/rot_error_{k}": float(v) for k, v in enumerate(rot_err)}}, step)
            if (epoch + 1) % cfg.epoch_val == 0:
                _validate(ws, cfg, mcfg, params, val_data, cur, step, dev)
            if (epoch + 1) % cfg.epoch_ckpt == 0:
                ckpt.save_checkpoint(ws.ckpt_dir, {"params": params,
                                                   "curriculum": ckpt.curriculum_to_dict(cur)},
                                     step=epoch)
            if cur.done:
                break
    finally:
        prefetcher.close()
    return params


def _validate(ws, cfg, mcfg, params, val_data, cur, step, device):
    """Val view 0 at the curriculum's last frame: PSNR, SSIM and the image."""
    frame = min(cur.current_frame, cfg.num_frames) - 1
    rays_o, rays_d = val_data.view_rays(0)
    target = torch.as_tensor(np.asarray(val_data.images[0, frame], np.float32))
    with torch.no_grad():
        pose = loop.gather_frame_pose(params["poses"], frame, mcfg.num_vehicles)
    out = render_image_mip(params["nerf"], mcfg, rays_o, rays_d, pose=pose, device=device)
    rgb = torch.from_numpy(out["rgb"])
    p, s = float(psnr_fn(rgb, target)), float(ssim_fn(rgb, target))
    ws.metrics.log({"val/psnr": p, "val/ssim": s}, step)
    ws.metrics.log_image("val/rgb", out["rgb"], step)
    ws.log(f"val: psnr={p:.2f} ssim={s:.4f}")


def test(cfg: Config, device=None):
    """The mip test protocol on the checkpoint at cfg.online_ckpt_path.
    LPIPS weights that exist raise before a run directory is made;
    save_video_frames writes each view's GIF (apps/test_protocol)."""
    dev = resolve(device)
    check_supported(cfg)
    ws = Workspace(cfg, "mip_test")
    mcfg = mip_config_from(cfg)
    test_data = make_dataset(cfg, "test", dev)
    restored = ckpt.restore_checkpoint(cfg.online_ckpt_path, device=dev)
    params = restored["params"] if "params" in restored else restored

    def render_frame(pose, rays_o, rays_d):
        return render_image_mip(params["nerf"], mcfg, rays_o, rays_d, pose=pose.to(dev),
                                with_test_outputs=True, device=dev)

    run_test_protocol(ws, cfg, mcfg.num_vehicles, params["poses"].detach().cpu().numpy(),
                      test_data, render_frame)


def main(argv=None):
    cfg = load_config(argv)
    if cfg.test:
        return test(cfg)
    if cfg.skip_appearance_init or cfg.appearance_ckpt_path:
        return train_online(cfg)
    return train_app_init(cfg)


if __name__ == "__main__":
    main()
