"""Shared app scaffolding: run workspace, dataset construction and the host
random generators of the training entry points (PyTorch).

Counterpart of startrax/apps/common.py, with its three datasets: CARLA and
Blender captures (read on the host) and the synthetic scene, and the apps'
data-parallel rule (startrax's make_run_mesh, apps/online.py): one process a
rank, rank 0 sampling each batch and writing the run directory.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from ..parallel.mesh import init_ray_group, pad_rays_to_multiple
from ..train import checkpoint as ckpt
from ..utils.config import Config, save_config
from ..utils.logging import MetricsLogger, configure_logger


class _NoMetrics:
    """The metrics sink of a rank that writes nothing."""

    def log(self, metrics, step):
        pass

    def log_image(self, name, img, step):
        pass


class Workspace:
    """Run directory <basedir>/<expname>/<app_name> with args.json, the
    loggers (run.log, metrics.jsonl, images/) and the checkpoint path.

    Over a ray group only rank 0 writes (``writes``): the other ranks make
    no directory, log nothing, and wait at a barrier while rank 0 saves a
    checkpoint (save_checkpoint), so that a rank reads only what is
    written."""

    def __init__(self, cfg: Config, app_name: str, group=None):
        self.cfg = cfg
        self.group = group
        self.writes = group is None or group.rank == 0
        self.run_dir = os.path.join(cfg.basedir, cfg.expname, app_name)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpts")
        self.logger = None
        self.metrics = _NoMetrics()
        if self.writes:
            os.makedirs(self.run_dir, exist_ok=True)
            save_config(cfg, self.run_dir)
            self.logger = configure_logger(self.run_dir, app_name)
            self.metrics = MetricsLogger(self.run_dir)

    def log(self, msg: str):
        if self.writes:
            self.logger.info(msg)

    def save_checkpoint(self, path: str, state, step: int):
        """train.checkpoint.save_checkpoint on rank 0; every rank leaves
        once it is written."""
        if self.writes:
            ckpt.save_checkpoint(path, state, step=step)
        if self.group is not None:
            self.group.barrier()

    def write_json(self, name: str, obj):
        """<run_dir>/<name> holding obj as JSON, written by rank 0."""
        if self.writes:
            with open(os.path.join(self.run_dir, name), "w") as f:
                json.dump(obj, f)


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


def make_run_mesh(cfg: Config, device=None):
    """The ray group of a run per the data_parallel flag (startrax's
    make_run_mesh): the world size is the process group's, or else the
    launcher's WORLD_SIZE. "off", or "auto" on one rank, gives None (one
    process on ``device``); "on" on one rank raises RuntimeError; another
    value raises ValueError. Otherwise the group is the launcher's process
    group where one exists, else one made from the launcher's environment:
    nccl, a card a rank (parallel.mesh.init_ray_group); gloo only where the
    launcher made it."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if cfg.data_parallel == "off" or (cfg.data_parallel == "auto" and world <= 1):
        return None
    if cfg.data_parallel not in ("auto", "on"):
        raise ValueError(f"data_parallel must be auto/on/off, got {cfg.data_parallel}")
    if cfg.data_parallel == "on" and world <= 1:
        raise RuntimeError("data_parallel=on but only one device is visible")
    return init_ray_group(device=device)


def log_run_mesh(ws: Workspace, group, n_rand: int) -> int:
    """Log the ray group and return the batch's ray count: n_rand, padded
    to a multiple of 8 a rank over a group (parallel.mesh.pad_rays_to_multiple,
    logged when it changes)."""
    if group is None:
        return n_rand
    ws.log(f"ray-axis data parallelism over {group.world} ranks ({group.backend}, "
           f"{group.device})")
    padded = pad_rays_to_multiple(n_rand, group.world)
    if padded != n_rand:
        ws.log(f"N_rand {n_rand} -> {padded} (divisible by the world size)")
    return padded


def next_batch(prefetcher, group):
    """The next global host batch: the prefetcher's; over a ray group rank
    0's (the only rank that samples) broadcast to every rank, so that the
    ranks shard one batch (apps.online._place_batch) whatever order rank
    0's sampling threads deliver in."""
    batch = next(prefetcher) if prefetcher is not None else None
    return batch if group is None else group.broadcast_object(batch)


def agree(value, group):
    """Rank 0's value of a host decision (a wall-clock deadline) on every
    rank; the value itself without a group."""
    return value if group is None else group.broadcast_object(value)


def host_prng(seed: int = 42, device=None):
    """(numpy Generator, torch.Generator on ``device``), both seeded with
    ``seed``; device None is the card (device.resolve)."""
    return np.random.default_rng(seed), torch.Generator(device=resolve(device)).manual_seed(seed)
