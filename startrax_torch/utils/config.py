"""Config system: one flat namespace of experiment flags, and its mapping
onto the port's StarConfig and LossConfig.

The port's own copy of the JAX package's flag namespace and parser
(``Config``, ``parse_config_file``, ``load_config``, ``save_config``), in the
standard library alone, so that nothing here imports the JAX package. It
reads the same ``startrax/configs/*.txt`` files (``key = value`` lines, ``#``
comments) with the same field names, defaults and value rules, and
``--key value`` command-line overrides. One rule differs on purpose: an
``Optional[bool]`` flag (``use_fused``) is parsed strictly by ``parse_bool``,
where the JAX parser returns the raw string, so that ``use_fused = 0`` there
turns the kernels on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import List, Optional

import torch

from ..models.star import StarConfig
from ..train.loop import LossConfig


@dataclasses.dataclass
class Config:
    # run identity / paths
    job_id: str = ""
    config: str = ""
    expname: str = "exp"
    test: bool = False
    basedir: str = "./logs"
    datadir: str = ""
    code_dir: str = ""

    # workload
    num_frames: int = 16
    num_vehicles: int = 1
    has_depth_data: bool = False
    epochs: int = 100
    epochs_appearance: int = 800
    epochs_online: int = 10000

    # model; i_embed 0 = positional encoding, -1 = identity
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    use_viewdirs: bool = True
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    end_barf: int = -1
    reference_numerics: bool = False
    stratified_fine: bool = True
    # field-MLP dispatch: true = the fused kernels, false = the plain body,
    # unset = the kernels for CUDA tensors
    use_fused: Optional[bool] = None

    # sampling / rendering
    N_rand: int = 1000
    N_samples: int = 256
    N_importance: int = 256
    perturb: float = 1.0
    near: float = 3.0
    far: float = 80.0
    far_dist: float = 1e10
    white_bkgd: bool = False
    lindisp: bool = False
    no_ndc: bool = True

    # optimization
    lrate: float = 5e-4
    lrate_static: float = 5e-4
    lrate_dynamic: float = 5e-4
    lrate_pose: float = 5e-4
    accumulate_grad_batches: int = 1
    lrate_decay: Optional[int] = None
    lrate_decay_rate: float = 0.5
    lrate_decay_steps: Optional[List[int]] = None
    pose_lrate_decay: Optional[int] = None
    pose_lrate_decay_rate: float = 0.5
    pose_lrate_decay_steps: Optional[List[int]] = None
    mixed_precision: bool = False

    # chunking (config compatibility; eval renders tile their rays)
    chunk: int = 8192
    netchunk: int = 16384

    # ray-axis data parallelism: "auto", "off" or "on"
    data_parallel: str = "auto"

    # checkpoints
    ckpt_path: str = ""
    skip_appearance_init: bool = False
    appearance_ckpt_path: str = ""
    online_ckpt_path: str = ""

    # online training
    car_sample_ratio: float = 0.0
    load_gt_poses: bool = False
    noisy_pose_init: bool = True
    pose_trans_only: bool = False
    pose_only_every: int = 0
    epochs_between_frames: int = 70
    online_thres_tightened: float = 95e-5
    seed: int = 1453

    # pose recipe
    pose_delay_epochs: int = 0
    barf_freeze_rot: bool = True
    car_sample_ratio_pose: float = -1.0
    ghost_sample_ratio: float = 0.0
    frame0_sample_ratio: float = 0.0

    # post-curriculum polish
    polish_epochs: int = 0
    polish_mode: str = "alternate"
    refit_epochs: int = 12
    refit_pose_epochs: int = 20
    refit_window: int = 1
    refit_pose_freeze_rot: bool = False
    polish_joint_every: int = 4
    polish_pose_lrate_decay: int = 12
    polish_pose_lrate_decay_rate: float = 0.8
    alt_field_epochs: int = 16
    alt_pose_epochs: int = 6
    alt_plateau_window: int = 2
    alt_plateau_tol: float = 0.03
    gauge_rounds: int = 1
    gauge_epochs: int = 2
    gauge_mode: str = "ref_field"
    gauge_freeze_rot: bool = True
    gauge_guard: bool = True
    gauge_guard_min_vis: float = 0.3
    gauge_depth_lambda: float = 0.0
    gauge_max_trans: float = 0.2
    gauge_max_rot: float = 0.5

    # photometric multi-start
    multi_start_rounds: int = 0
    multi_start_candidates: int = 4
    multi_start_epochs: int = 2
    multi_start_scale: float = 0.05

    # best-epoch selection and stopping
    selection: str = "photometric"
    selection_depth_lambda: float = 1.0
    selection_boundary_only: bool = False
    selection_frames: int = 0
    selection_stride: int = 1
    selection_patience: int = 40
    train_minutes: float = 0.0
    target_pose_err: float = 0.0
    mixed_frames: bool = False
    appearance_init_thres: float = 9e-4
    online_thres: float = 1e-3
    initial_num_frames: int = 5
    entropy_weight: float = 0.0  # accepted, inert (as in the reference)

    # regularizers
    lambda_alpha_entropy: float = 0.0
    lambda_dynamic_vs_static_reg: float = 0.0
    lambda_ray_reg: float = 0.0
    lambda_static_reg: float = 0.0
    lambda_dynamic_reg: float = 0.0
    epoch_start_dynamic_reg: int = 0

    # depth supervision
    depth_loss: bool = False
    depth_lambda: float = 0.0
    sigma_loss: bool = False
    sigma_lambda: float = 0.0

    # dataset
    dataset_type: str = "carla"
    testskip: int = 8
    num_workers: int = 2
    synth_height: int = 64
    synth_views: int = 8
    synth_val_views: int = 1
    synth_cache_dir: str = ""
    scale_factor: float = -1.0
    half_res: bool = False
    factor: int = 8
    precrop_iters: int = -1
    precrop_frac: float = 0.5

    # mip (IPE) variant encoding
    num_freqs_pos: int = 24
    num_freqs_dir: int = 4
    mip_base_radius: float = 0.0005

    # occupancy grid
    grid_resolution: int = 128
    grid_nlvl: int = 1
    render_step_size: float = 5e-3
    target_sample_batch_size: int = 1 << 16

    # eval
    bbox_view: int = 0
    has_bbox: bool = False
    eval_last_frame: int = 0
    save_video_frames: bool = False
    render_test: bool = False
    lpips_weights: str = ""

    # logging cadence
    epoch_ckpt: int = 1
    epoch_print: int = 1
    epoch_val: int = 1

    # steps per pseudo-epoch
    steps_per_epoch: int = 1000


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def parse_bool(value) -> Optional[bool]:
    """Strict boolean: None and bools pass through, ints by truth, and the
    spellings 1/0, true/false, yes/no, on/off; anything else raises."""
    if value is None or isinstance(value, bool):
        return value
    if isinstance(value, int):
        return bool(value)
    text = str(value).strip().lower()
    if text in ("1", "true", "yes", "on"):
        return True
    if text in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


def _parse_value(name: str, raw: str):
    kind = str(_FIELDS[name].type)
    raw = raw.strip()
    if kind == "Optional[bool]":
        return parse_bool(raw)
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.startswith("["):
        return [int(x) for x in raw.strip("[]").split(",") if x.strip()]
    if kind == "int":
        return int(float(raw))
    if kind == "float":
        return float(raw)
    if kind == "bool":
        return raw.lower() in ("1", "true", "yes")
    if "List" in kind:
        return [int(x) for x in raw.replace(",", " ").split()]
    if kind == "Optional[int]":
        return int(float(raw))
    return raw


def parse_config_file(path: str) -> dict:
    """Parse the `key = value` txt format (comments with #); unknown keys
    are skipped."""
    out = {}
    with open(path) as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            key = key.strip()
            if key in _FIELDS:
                out[key] = _parse_value(key, val)
    return out


def load_config(argv: Optional[List[str]] = None) -> Config:
    """--config file + --key value CLI overrides -> Config. A flag with no
    value is "true"; an unknown flag raises."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = {}
    cfg_path = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            i += 1
            continue
        key = a[2:]
        val = "true"
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            val = argv[i + 1]
            i += 1
        if key == "config":
            cfg_path = val
        elif key in _FIELDS:
            overrides[key] = _parse_value(key, val)
        else:
            raise ValueError(f"unknown flag --{key}")
        i += 1

    values = {}
    if cfg_path:
        values.update(parse_config_file(cfg_path))
        values["config"] = cfg_path
    values.update(overrides)
    return Config(**values)


def save_config(cfg: Config, run_dir: str):
    """Snapshot the resolved config into run_dir/args.json."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "args.json"), "w") as fp:
        json.dump(dataclasses.asdict(cfg), fp, indent=2, default=str)


def star_config_from(cfg: Config) -> StarConfig:
    """Map the flat flags onto the port's StarConfig."""
    scale = cfg.scale_factor if cfg.scale_factor > 0 else 1.0
    if cfg.i_embed not in (0, -1):
        raise ValueError(f"i_embed must be 0 (PE) or -1 (identity), got {cfg.i_embed}")
    identity_embed = cfg.i_embed == -1
    return StarConfig(
        num_vehicles=cfg.num_vehicles,
        netdepth=cfg.netdepth,
        netdepth_fine=cfg.netdepth_fine,
        netwidth=cfg.netwidth,
        netwidth_fine=cfg.netwidth_fine,
        multires=0 if identity_embed else cfg.multires,
        multires_views=0 if identity_embed else cfg.multires_views,
        n_samples=cfg.N_samples,
        n_importance=cfg.N_importance,
        near=cfg.near * scale,
        far=cfg.far * scale,
        far_dist=cfg.far_dist,
        raw_noise_std=cfg.raw_noise_std,
        white_bkgd=cfg.white_bkgd,
        lindisp=cfg.lindisp,
        perturb=cfg.perturb,
        end_barf=cfg.end_barf,
        compute_dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32,
        reference_numerics=cfg.reference_numerics,
        stratified_fine=cfg.stratified_fine,
        use_fused=parse_bool(cfg.use_fused),
    )


def loss_config_from(cfg: Config) -> LossConfig:
    return LossConfig(
        lambda_alpha_entropy=cfg.lambda_alpha_entropy,
        lambda_dynamic_vs_static_reg=cfg.lambda_dynamic_vs_static_reg,
        lambda_ray_reg=cfg.lambda_ray_reg,
        lambda_static_reg=cfg.lambda_static_reg,
        lambda_dynamic_reg=cfg.lambda_dynamic_reg,
        epoch_start_dynamic_reg=cfg.epoch_start_dynamic_reg,
        use_depth_loss=cfg.depth_loss,
        depth_lambda=cfg.depth_lambda or 0.0,
        use_sigma_loss=cfg.sigma_loss,
        sigma_lambda=cfg.sigma_lambda or 0.0,
    )
