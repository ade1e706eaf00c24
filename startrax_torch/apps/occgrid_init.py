"""Occupancy-grid accelerated appearance initialization (PyTorch).

Counterpart of startrax/apps/occgrid_init.py: one NeRF field trained on
frame 0 with empty-space skipping. The grid (kernels/occgrid.py) covers the
AABB [-far, far]^3 in scaled units and is updated from the field's density
before every GRID_UPDATE_EVERY-th step, the first included (one forward
over one jittered point a cell, under torch.no_grad, so the fused kernels
save no activations). Each step marches N_samples fixed steps a ray and
renders the first n_selected occupied samples (N_samples // 4, at least
32); when more than 1% of an epoch's occupied samples were cut, the budget
doubles, up to N_samples, from the next step on. Epochs log
train/fine_loss, train/mean_samples and train/dropped_frac; checkpoints
hold {"params"}; a run stops at appearance_init_thres or after
train_minutes.

GridStep is one step as train() runs it (the grid update when it is due,
then the train step), which the benchmark drives as well. It opens the
span train.step around both; inside it the update opens occgrid.update
and the train step train.forward (march, field, compositing, loss;
kernels/occgrid's occgrid.march inside it), train.backward and
train.optimizer. No part of it reads anything from the device.

Usage: python -m startrax_torch.apps.occgrid_init --config startrax/configs/<name>.txt [--key value ...]
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..kernels import occgrid
from ..models.fields import FieldConfig, apply_field, init_field
from ..ops.compositing import raw2outputs
from ..ops.losses import img2mse, mse2psnr
from ..train import checkpoint as ckpt
from ..train import optim
from ..utils.config import Config, load_config
from ..utils.profiling import span
from ..utils.tree import tree_leaves
from .common import Workspace, host_prng, make_dataset

GRID_UPDATE_EVERY = 16


def occgrid_config(cfg: Config) -> occgrid.OccGridConfig:
    """The grid and march of a config: the AABB [-far, far]^3 in scaled
    units, N_samples march steps, a budget of max(N_samples // 4, 32)."""
    far = cfg.far * (cfg.scale_factor if cfg.scale_factor > 0 else 1.0)
    return occgrid.OccGridConfig(
        resolution=cfg.grid_resolution, aabb_min=(-far, -far, -far), aabb_max=(far, far, far),
        render_step_size=cfg.render_step_size, n_march=cfg.N_samples,
        n_selected=max(cfg.N_samples // 4, 32))


def field_config(cfg: Config) -> FieldConfig:
    """The app's field: netdepth x netwidth, bf16 matmuls with
    mixed_precision (else f32)."""
    return FieldConfig(
        depth=cfg.netdepth, width=cfg.netwidth, multires=cfg.multires,
        multires_views=cfg.multires_views,
        compute_dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32)


def density_fn(params, field_cfg: FieldConfig):
    """pts [N, 3] -> the field's density [N] (post-softplus), each point
    seen along (0, 0, -1)."""

    def fn(pts):
        # (0, 0, -1) made on the device: a copy from the host would wait for it
        down = F.pad(pts.new_full((1, 1), -1.0), (2, 0))
        raw_alpha, _ = apply_field(params, field_cfg, pts[:, None, :],
                                   down.expand(pts.shape[0], 3))
        return torch.nn.functional.softplus(raw_alpha[:, 0])

    return fn


def _given(**draws):
    """The keyword arguments given (not None). The step passes the march
    and the update no draw it was not given, so that a function put in
    their place that takes only ``generator`` still fits."""
    return {k: v for k, v in draws.items() if v is not None}


def make_train_step(field_cfg: FieldConfig, opt, near: float, far: float,
                    white_bkgd: bool = False, far_dist: float = 1e10):
    """Returns step(params, grid, batch, occ_cfg, u=None, generator=None) ->
    (loss, metrics), updating params and opt in place: the march (jittered
    by u [R, n_march], or by draws from ``generator``), the field on the
    selected samples, the photometric loss, one optimizer step. The metrics
    are device scalars: fine_loss, psnr, mean_samples (valid slots a ray)
    and dropped_frac (the occupied samples cut by the budget over all
    occupied ones)."""

    def train_step(params, grid, batch, occ_cfg, u=None, generator=None):
        opt.zero_grad()
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        with span("train.forward"):
            z_sel, valid, n_occ = occgrid.march_and_select(
                grid, occ_cfg, rays_o, rays_d, near, far, **_given(u=u, generator=generator))
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]
            raw_alpha, raw_rgb = apply_field(params, field_cfg, pts, viewdirs)
            raw_alpha = occgrid.masked_raw_alpha(raw_alpha, valid)
            out = raw2outputs(raw_alpha, raw_rgb, z_sel, rays_d, white_bkgd=white_bkgd,
                              far_dist=far_dist)
            loss = img2mse(out["rgb"], batch["target"])
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            opt.step()
        loss = loss.detach()
        n_occ = n_occ.to(torch.float32)
        dropped = torch.clamp(n_occ - occ_cfg.n_selected, min=0.0)
        return loss, {"fine_loss": loss, "psnr": mse2psnr(loss),
                      "mean_samples": valid.sum(-1).to(torch.float32).mean(),
                      "dropped_frac": dropped.sum() / torch.clamp(n_occ.sum(), min=1.0)}

    return train_step


class GridStep:
    """The app's step with its grid, as train() runs it: before every
    GRID_UPDATE_EVERY-th call (counting from ``count`` calls made; 0: the
    first call included) the grid takes one update from the field's
    density, then make_train_step's step runs at the budget
    ``occ_cfg.n_selected``. ``grid``, ``count`` and ``occ_cfg`` are the
    step's state: train() raises the budget by replacing ``occ_cfg``.

    step(batch, u=None, u_jitter=None, u_refresh=None, generator=None) ->
    (loss, metrics): u [R, n_march] jitters the march, u_jitter [r, r, r, 3]
    and u_refresh [r, r, r] are the update's draws (kernels/occgrid.py);
    each one not given is drawn from ``generator``."""

    def __init__(self, params, field_cfg: FieldConfig, opt, occ_cfg: occgrid.OccGridConfig,
                 near: float, far: float, grid, white_bkgd: bool = False, far_dist: float = 1e10,
                 count: int = 0):
        self.params, self.field_cfg, self.occ_cfg = params, field_cfg, occ_cfg
        self.grid, self.count = grid, count
        self.train_step = make_train_step(field_cfg, opt, near, far, white_bkgd, far_dist)

    def __call__(self, batch, u=None, u_jitter=None, u_refresh=None, generator=None):
        with span("train.step"):
            if self.count % GRID_UPDATE_EVERY == 0:
                self.grid = occgrid.update_grid(
                    self.grid, density_fn(self.params, self.field_cfg), self.occ_cfg,
                    **_given(u_jitter=u_jitter, u_refresh=u_refresh, generator=generator))
            self.count += 1
            return self.train_step(self.params, self.grid, batch, self.occ_cfg,
                                   **_given(u=u, generator=generator))


def train(cfg: Config, device=None):
    """Run occupancy-grid appearance init; returns (params, grid), their
    tensors on ``device`` (None: the card, device.resolve)."""
    dev = resolve(device)
    ws = Workspace(cfg, "occgrid_init")
    scale = cfg.scale_factor if cfg.scale_factor > 0 else 1.0
    near, far = cfg.near * scale, cfg.far * scale

    field_cfg = field_config(cfg)
    occ_cfg = occgrid_config(cfg)

    train_data = make_dataset(cfg, "train", dev)
    _, gen = host_prng(cfg.seed, dev)
    params = init_field(field_cfg, gen, dev)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = optim.make_appinit_optimizer(
        params, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch,
        decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
        decay_milestones=cfg.lrate_decay_steps)
    step_fn = GridStep(params, field_cfg, opt, occ_cfg, near, far, occgrid.init_grid(occ_cfg, dev),
                       cfg.white_bkgd, cfg.far_dist)

    if cfg.dataset_type == "blender":
        def sample_fn(r, st):
            return train_data.sample_batch(r, cfg.N_rand)
    else:
        def sample_fn(r, st):
            return train_data.sample_batch(r, cfg.N_rand, frame=0)
    prefetcher = BatchPrefetcher(sample_fn, {}, seed=cfg.seed * 7919 + 6,
                                 depth=6, workers=max(cfg.num_workers, 1))

    deadline = (time.time() + cfg.train_minutes * 60
                if cfg.train_minutes > 0 else None)
    try:
        for epoch in range(cfg.epochs_appearance):
            if deadline is not None and time.time() > deadline:
                ws.log("train_minutes budget exhausted; stopping")
                break
            fine_losses, dropped = [], []
            for _ in range(cfg.steps_per_epoch):
                batch = {k: torch.as_tensor(v, device=dev) for k, v in next(prefetcher).items()}
                _, metrics = step_fn(batch, generator=gen)
                fine_losses.append(metrics["fine_loss"])  # device scalars, no sync
                dropped.append(metrics["dropped_frac"])
            avg = float(torch.stack(fine_losses).mean())  # one device read each
            avg_dropped = float(torch.stack(dropped).mean())
            mean_samples = float(metrics["mean_samples"])
            ws.metrics.log({"train/fine_loss": avg, "train/mean_samples": mean_samples,
                            "train/dropped_frac": avg_dropped, "epoch": epoch}, step_fn.count)
            ws.log(f"epoch {epoch}: fine_loss={avg:.6f} mean_samples={mean_samples:.1f} "
                   f"dropped_frac={avg_dropped:.4f}")
            if avg_dropped > 0.01 and occ_cfg.n_selected < occ_cfg.n_march:
                # more than 1% of the occupied samples were cut: double the budget
                step_fn.occ_cfg = occ_cfg = dataclasses.replace(
                    occ_cfg, n_selected=min(occ_cfg.n_selected * 2, occ_cfg.n_march))
                ws.log(f"raised occgrid sample budget to {occ_cfg.n_selected} "
                       f"(dropped_frac={avg_dropped:.4f})")
            if (epoch + 1) % cfg.epoch_ckpt == 0:
                ckpt.save_checkpoint(ws.ckpt_dir, {"params": params}, step=epoch)
            if avg <= cfg.appearance_init_thres:
                ws.log("appearance threshold reached; stopping")
                break
    finally:
        prefetcher.close()
    return params, step_fn.grid


def main(argv=None):
    return train(load_config(argv))


if __name__ == "__main__":
    main()
