"""Config adapter: the JAX package's flag namespace -> the port's configs.

``startrax.utils.config`` (``Config``, ``parse_config_file``, ``load_config``)
imports only the standard library and numpy, so the port uses it as it is and
reads the same ``startrax/configs/*.txt`` files. Only the mapping onto the
port's StarConfig and LossConfig lives here.
"""

from __future__ import annotations

from typing import Optional

import torch

from startrax.utils.config import Config

from ..models.star import StarConfig
from ..train.loop import LossConfig


def parse_bool(value) -> Optional[bool]:
    """Strict boolean: the shared parser returns an Optional[bool] flag's raw
    string ("0" would be truthy), so map the spellings explicitly."""
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
