"""Shared app scaffolding: run workspace, dataset construction and the host
random generators of the training entry points (PyTorch).

Counterpart of startrax/apps/common.py, with its three datasets: CARLA and
Blender captures (read on the host) and the synthetic scene.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve
from ..utils.config import Config, save_config
from ..utils.logging import MetricsLogger, configure_logger


class Workspace:
    """Run directory <basedir>/<expname>/<app_name> with args.json, the
    loggers (run.log, metrics.jsonl, images/) and the checkpoint path."""

    def __init__(self, cfg: Config, app_name: str):
        self.cfg = cfg
        self.run_dir = os.path.join(cfg.basedir, cfg.expname, app_name)
        os.makedirs(self.run_dir, exist_ok=True)
        save_config(cfg, self.run_dir)
        self.logger = configure_logger(self.run_dir, app_name)
        self.metrics = MetricsLogger(self.run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpts")

    def log(self, msg: str):
        self.logger.info(msg)


def make_dataset(cfg: Config, split: str, device=None):
    """Dataset factory over dataset_type. A CARLA or Blender capture is read
    on the host; a synthetic scene that is neither in memory nor in
    cfg.synth_cache_dir is generated on ``device`` (None: the card)."""
    if cfg.dataset_type == "carla":
        from ..data.carla import CarlaConfig, CarlaScene

        return CarlaScene(CarlaConfig(
            datadir=cfg.datadir, num_frames=cfg.num_frames, num_vehicles=cfg.num_vehicles,
            has_depth_data=cfg.has_depth_data, scale_factor=cfg.scale_factor, near=cfg.near,
            far=cfg.far, eval_last_frame=cfg.eval_last_frame), split)
    if cfg.dataset_type == "blender":
        from ..data.blender import BlenderScene

        return BlenderScene(cfg.datadir, split=split, half_res=cfg.half_res,
                            testskip=cfg.testskip, white_bkgd=cfg.white_bkgd, near=cfg.near,
                            far=cfg.far)
    if cfg.dataset_type == "synthetic":
        from ..data.synthetic import SyntheticAdapter, SyntheticScene

        scene = SyntheticScene(
            num_vehicles=cfg.num_vehicles, num_frames=cfg.num_frames,
            H=cfg.synth_height, W=cfg.synth_height,
            focal=float(cfg.synth_height),
        )
        return SyntheticAdapter(
            scene, num_views=cfg.synth_views,
            num_val_views=cfg.synth_val_views,
            cache_dir=cfg.synth_cache_dir,
            split="train" if split == "train" else "val",
            device=device,
        )
    raise ValueError(f"unknown dataset_type {cfg.dataset_type}")


def check_one_device(cfg: Config) -> None:
    """The apps run on one device: data_parallel = on raises
    NotImplementedError, and a value other than auto/on/off ValueError."""
    if cfg.data_parallel == "on":
        raise NotImplementedError("data_parallel = on: ray-axis data parallelism is not ported "
                                  "yet (ROADMAP queue 1, item 8)")
    if cfg.data_parallel not in ("auto", "off"):
        raise ValueError(f"data_parallel must be auto/on/off, got {cfg.data_parallel}")


def host_prng(seed: int = 42, device=None):
    """(numpy Generator, torch.Generator on ``device``), both seeded with
    ``seed``; device None is the card (device.resolve)."""
    return np.random.default_rng(seed), torch.Generator(device=resolve(device)).manual_seed(seed)
