"""Time-conditioned NeRF baseline training and test (no decomposition, no
poses) (PyTorch).

Counterpart of startrax/apps/nerf_time.py: one xyzt-conditioned field pair
(coarse, fine) trained on random rays of every frame with Adam and its
schedule (train.loop.make_nerf_time_train_step), validated on val view 0 at
the last frame every epoch_val epochs, checkpointed every epoch_ckpt epochs,
stopped at online_thres; ``test`` renders every test view and frame from the
checkpoint at online_ckpt_path and logs the full, static- and
dynamic-masked PSNR and SSIM (no LPIPS, as apps/test_protocol).

Usage: python -m startrax_torch.apps.nerf_time --config startrax/configs/carla_nerf_time.txt [--test true] [--key value ...]
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..eval.image import psnr as psnr_fn
from ..eval.image import ssim as ssim_fn
from ..eval.render import render_image_nerf_time
from ..models import nerf_time as nt
from ..train import checkpoint as ckpt
from ..train import loop, optim
from ..utils.config import Config, load_config, loss_config_from, star_config_from
from ..utils.tree import tree_leaves
from .common import Workspace, host_prng, make_dataset
from .test_protocol import check_supported, dynamic_mask_for, frame_metrics, make_lpips


def train(cfg: Config, device=None):
    """Train the baseline; returns its {"coarse", "fine"} params (leaf
    tensors on ``device``, None: the card, device.resolve)."""
    dev = resolve(device)
    ws = Workspace(cfg, "nerf_time")
    star_cfg = star_config_from(cfg)
    loss_cfg = loss_config_from(cfg)

    train_data = make_dataset(cfg, "train", dev)
    val_data = make_dataset(cfg, "val", dev)

    _, gen = host_prng(cfg.seed, dev)
    params = nt.init_nerf_time(star_cfg, gen, dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)

    opt = optim.make_appinit_optimizer(
        params, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch,
        decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
        decay_milestones=cfg.lrate_decay_steps)
    step_fn = loop.make_nerf_time_train_step(star_cfg, loss_cfg, opt, cfg.num_frames)

    prefetcher = BatchPrefetcher(
        lambda r, st: train_data.sample_batch(
            r, cfg.N_rand, start_frame=0, current_frame=cfg.num_frames),
        {}, seed=cfg.seed * 7919 + 5, depth=6, workers=max(cfg.num_workers, 1))

    step = 0
    try:
        for epoch in range(cfg.epochs_online):
            fine_losses = []
            for _ in range(cfg.steps_per_epoch):
                batch = {k: torch.as_tensor(v, device=dev) for k, v in next(prefetcher).items()}
                _, metrics = step_fn(params, batch, generator=gen)
                step += 1
                fine_losses.append(metrics["fine_loss"])  # device scalar, no sync
            avg = float(torch.stack(fine_losses).mean())  # one device read
            ws.metrics.log({"train/fine_loss": avg, "epoch": epoch}, step)
            ws.log(f"epoch {epoch}: fine_loss={avg:.6f}")
            if (epoch + 1) % cfg.epoch_val == 0:
                _validate(ws, cfg, star_cfg, params, val_data, step, dev)
            if (epoch + 1) % cfg.epoch_ckpt == 0:
                ckpt.save_checkpoint(ws.ckpt_dir, {"params": params}, step=epoch)
            if avg <= cfg.online_thres:
                break
    finally:
        prefetcher.close()
    return params


def _validate(ws, cfg, star_cfg, params, val_data, step, device):
    """Val view 0 at the last frame: PSNR and SSIM, and the rendered image."""
    frame = cfg.num_frames - 1
    rays_o, rays_d = val_data.view_rays(0)
    target = torch.as_tensor(np.asarray(val_data.images[0, frame], np.float32))
    out = render_image_nerf_time(params, star_cfg, rays_o, rays_d, frame, cfg.num_frames,
                                 device=device)
    rgb = torch.from_numpy(out["rgb"])
    p, s = float(psnr_fn(rgb, target)), float(ssim_fn(rgb, target))
    ws.metrics.log({"val/psnr": p, "val/ssim": s}, step)
    ws.metrics.log_image("val/rgb", out["rgb"], step)
    ws.log(f"val: psnr={p:.2f} ssim={s:.4f}")


def test(cfg: Config, device=None):
    """The baseline's test protocol: per test view, every frame up to
    eval_last_frame rendered from the checkpoint at cfg.online_ckpt_path,
    a frame_metrics row each and their mean a view. LPIPS weights that exist
    raise before a run directory is made; save_video_frames writes nothing
    here, as in startrax's."""
    dev = resolve(device)
    check_supported(cfg)
    ws = Workspace(cfg, "nerf_time_test")
    star_cfg = star_config_from(cfg)
    test_data = make_dataset(cfg, "test", dev)

    restored = ckpt.restore_checkpoint(cfg.online_ckpt_path, device=dev)
    params = restored["params"] if "params" in restored else restored

    make_lpips(cfg, ws)
    eval_last = cfg.eval_last_frame or cfg.num_frames
    for view in range(test_data.rays_o.shape[0]):
        rays_o, rays_d = test_data.view_rays(view)
        acc: dict = {}
        for frame in range(min(eval_last, test_data.images.shape[1])):
            out = render_image_nerf_time(params, star_cfg, rays_o, rays_d, frame,
                                         cfg.num_frames, device=dev)
            row = frame_metrics(out, test_data.images[view, frame],
                                dynamic_mask_for(test_data, view, frame))
            for k, v in row.items():
                acc.setdefault(k, []).append(v)
            ws.metrics.log({f"test/view{view}_frame_{k}": v for k, v in row.items()}, frame)
            ws.metrics.log_image(f"test/view{view}_rgb", out["rgb"], frame)
        row = {f"test/view{view}_{k}": float(np.mean(vs)) for k, vs in acc.items()}
        ws.metrics.log(row, view)
        ws.log(" ".join(f"{k}={v:.4f}" for k, v in row.items()))


def main(argv=None):
    cfg = load_config(argv)
    return test(cfg) if cfg.test else train(cfg)


if __name__ == "__main__":
    main()
