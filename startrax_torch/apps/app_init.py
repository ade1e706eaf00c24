"""Appearance initialization: fit the static field on frame-0 multi-view
images, with early stopping on the fine photometric loss (PyTorch).

Counterpart of startrax/apps/app_init.py: pseudo-epochs of
steps_per_epoch steps of N_rand random rays (car-balanced, frame 0; on a
Blender capture, of every view), Adam
with its schedule and gradient accumulation, early stopping when the
epoch's fine MSE <= appearance_init_thres, a validation render and a
checkpoint every epoch_val epochs, and a final checkpoint at step
epochs_appearance. Under a launcher's ranks (``data_parallel``,
apps.common.make_run_mesh) each step runs on the rays of one rank's shard
of rank 0's batch and the grads are summed over the ranks.

Usage: python -m startrax_torch.apps.app_init --config startrax/configs/<name>.txt [--key value ...]
       torchrun --nproc_per_node N -m startrax_torch.apps.app_init --config ...
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..eval.image import psnr as psnr_fn
from ..eval.image import ssim as ssim_fn
from ..eval.render import render_image
from ..models.star import init_star
from ..parallel.mesh import replicate_params
from ..train import loop, optim
from ..utils.config import Config, load_config, loss_config_from, star_config_from
from ..utils.tree import tree_leaves
from .common import (Workspace, agree, host_prng, log_run_mesh, make_dataset, make_run_mesh,
                     next_batch)
from .online import _place_batch


def train(cfg: Config, device=None):
    """Run appearance init; returns the parameters (leaf tensors on
    ``device``, None: the card, device.resolve; over a ray group, the
    group's device)."""
    group = make_run_mesh(cfg, device)
    dev = resolve(device) if group is None else group.device
    ws = Workspace(cfg, "app_init", group)
    star_cfg = star_config_from(cfg)
    loss_cfg = loss_config_from(cfg)

    train_data = make_dataset(cfg, "train", dev)
    val_data = make_dataset(cfg, "val", dev)

    rng, gen = host_prng(cfg.seed, dev)
    params = init_star(star_cfg, gen, dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    n_rand = log_run_mesh(ws, group, cfg.N_rand)
    if group is not None:
        replicate_params(params, group)

    opt = optim.make_appinit_optimizer(
        params,
        cfg.lrate,
        steps_per_epoch=cfg.steps_per_epoch,
        decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay,
        decay_milestones=cfg.lrate_decay_steps,
        accumulate_steps=cfg.accumulate_grad_batches,
        ray_group=group,
    )
    step_fn = loop.make_appinit_train_step(star_cfg, loss_cfg, opt)

    if cfg.dataset_type == "blender":
        def sample_fn(r, st):
            return train_data.sample_batch(r, n_rand)
    else:
        # car-balanced sampling covers the reference's semantic app-init variant
        def sample_fn(r, st):
            return train_data.sample_batch(r, n_rand, frame=0,
                                           car_sample_ratio=cfg.car_sample_ratio)

    # over a ray group only rank 0 samples (apps.common.next_batch)
    prefetcher = (BatchPrefetcher(sample_fn, {}, seed=cfg.seed * 7919 + 2,
                                  depth=6, workers=max(cfg.num_workers, 1))
                  if ws.writes else None)

    deadline = (time.time() + cfg.train_minutes * 60
                if cfg.train_minutes > 0 else None)
    step = 0
    try:
        for epoch in range(cfg.epochs_appearance):
            if agree(deadline is not None and time.time() > deadline, group):
                ws.log("train_minutes budget exhausted; stopping")
                break
            fine_losses = []
            for _ in range(cfg.steps_per_epoch):
                batch = _place_batch(next_batch(prefetcher, group), dev, group)
                _, metrics = step_fn(params, batch, generator=gen)
                step += 1
                fine_losses.append(metrics["fine_loss"])  # device scalar, no sync
            avg_fine = float(torch.stack(fine_losses).mean())  # one device read
            ws.metrics.log({"train/fine_loss": avg_fine, "epoch": epoch}, step)
            ws.log(f"epoch {epoch}: fine_loss={avg_fine:.6f}")

            if (epoch + 1) % cfg.epoch_val == 0:
                _validate(ws, params, star_cfg, val_data, rng, step, dev, group)
                ws.save_checkpoint(ws.ckpt_dir, {"params": params}, step=epoch)

            # EarlyStopping on train/fine_loss
            if avg_fine <= cfg.appearance_init_thres:
                ws.log(f"appearance threshold {cfg.appearance_init_thres} reached; stopping")
                break
    finally:
        if prefetcher is not None:
            prefetcher.close()

    ws.save_checkpoint(ws.ckpt_dir, {"params": params}, step=cfg.epochs_appearance)
    return params


def _validate(ws: Workspace, params, star_cfg, val_data, rng, step, device, group=None):
    """Render one held-out view (drawn from rng), log its PSNR and SSIM and
    the rendered and target images (frame 0; a Blender capture's images
    [views, H, W, 3] have no frame axis)."""
    view = int(rng.integers(0, val_data.rays_o.shape[0]))
    rays_o, rays_d = val_data.view_rays(view)
    target = val_data.images[view] if val_data.images.ndim == 4 else val_data.images[view, 0]
    out = render_image(params, star_cfg, rays_o, rays_d, pose=None, device=device, group=group)
    rgb, tgt = torch.from_numpy(out["rgb"]), torch.tensor(np.asarray(target))
    p = float(psnr_fn(rgb, tgt))
    s = float(ssim_fn(rgb, tgt))
    ws.metrics.log({"val/psnr": p, "val/ssim": s}, step)
    ws.metrics.log_image("val/rgb", out["rgb"], step)
    ws.metrics.log_image("val/target", np.asarray(target), step)
    ws.log(f"val view {view}: psnr={p:.2f} ssim={s:.4f}")


def main(argv=None):
    cfg = load_config(argv)
    return train(cfg)


if __name__ == "__main__":
    main()
