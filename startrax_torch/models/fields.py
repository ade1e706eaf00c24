"""Radiance-field MLPs as init/apply functions over parameter dicts (PyTorch).

Counterpart of startrax/models/fields.py. Parameters keep the JAX layout:
{"lin_in", "blocks": [{"fc0", "fc1"}], "lin_out", "alpha", "feature",
"views", "rgb"}, each {"w": [in, out], "b": [out]}; K dynamic fields stack
every leaf on a leading [K] axis.

Dispatch: with ``use_fused`` (default: on for CUDA tensors) the field runs
through the fused MLP kernels (kernels/fused_mlp.py); otherwise through their
plain version, ``fused_mlp_plain``, in ``compute_dtype`` (bf16 operands with
f32 accumulation, rounded as the kernels round, or f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..kernels.fused_mlp import fused_field_apply, fused_mlp_plain, flatten_params, pe_mask_row
from ..ops.encoding import barf_weights, encoding_dim
from ..utils.tree import tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Architecture of one NeRF field; the trunk holds depth // 2 residual
    blocks."""

    depth: int = 8
    width: int = 256
    multires: int = 10
    multires_views: int = 4
    input_dims: int = 3
    end_barf: int = -1
    compute_dtype: Any = torch.bfloat16
    # None = auto: the fused CUDA kernels for CUDA tensors, the plain body
    # elsewhere. The fused path always runs bf16 matmuls.
    use_fused: Optional[bool] = None

    @property
    def n_blocks(self) -> int:
        return self.depth // 2

    @property
    def input_ch(self) -> int:
        return encoding_dim(self.input_dims, self.multires)

    @property
    def input_ch_views(self) -> int:
        return encoding_dim(3, self.multires_views)


def _kaiming_normal(shape, generator, device):
    std = (2.0 / shape[0]) ** 0.5
    return std * torch.randn(shape, generator=generator, device=device)


def _xavier_uniform(shape, generator, device):
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * limit


def _linear(d_in, d_out, generator, device, init=_kaiming_normal):
    return {"w": init((d_in, d_out), generator, device),
            "b": torch.zeros((d_out,), device=device)}


def init_field(cfg: FieldConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Params:
    """He-normal trunk and heads, Xavier-uniform rgb, zero fc1 (so each
    residual block starts as the identity)."""
    W = cfg.width
    params: Params = {
        "lin_in": _linear(cfg.input_ch, W, generator, device),
        "lin_out": _linear(W, W, generator, device),
        "alpha": _linear(W, 1, generator, device),
        "feature": _linear(W, W, generator, device),
        "views": _linear(W + cfg.input_ch_views, W // 2, generator, device),
        "rgb": _linear(W // 2, 3, generator, device, init=_xavier_uniform),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "fc0": _linear(W, W, generator, device),
            "fc1": {"w": torch.zeros((W, W), device=device),
                    "b": torch.zeros((W,), device=device)},
        })
    return params


def init_stacked_fields(cfg: FieldConfig, n: int, generator=None, device=None) -> Params:
    """n independently initialised fields, leaves stacked on axis 0."""
    fields = [init_field(cfg, generator, device) for _ in range(n)]

    def stack(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: stack([t[k] for t in trees]) for k in first}
        if isinstance(first, list):
            return [stack([t[i] for t in trees]) for i in range(len(first))]
        return torch.stack(trees)

    return stack(fields)


def resolve_use_fused(cfg: FieldConfig, device) -> bool:
    if cfg.use_fused is not None:
        return bool(cfg.use_fused)
    return torch.device(device).type == "cuda"


def barf_masks(cfg: FieldConfig, step, device):
    """The BARF column masks at this step, or None when BARF is off."""
    if step is None or cfg.end_barf <= 0:
        return None
    wx = barf_weights(step, cfg.end_barf, cfg.multires, device=device)
    wd = barf_weights(step, cfg.end_barf, cfg.multires_views, device=device)
    return pe_mask_row(wx, cfg.multires), pe_mask_row(wd, cfg.multires_views)


def apply_field(params: Params, cfg: FieldConfig, pts, viewdirs, step=None, warp=None):
    """Evaluate the field on pts [R, S, 3] with per-ray viewdirs [R, 3].

    warp: optional packed [16] SE(3) (M row-major at [0:9], t at [9:12])
    applied to the inputs first, differentiably. Returns (raw_alpha [R, S],
    raw_rgb [R, S, 3]) in f32."""
    R, S = pts.shape[0], pts.shape[1]
    assert tuple(pts.shape) == (R, S, 3) and tuple(viewdirs.shape) == (R, 3)
    if cfg.input_dims != 3:
        raise NotImplementedError("time-conditioned (4-D input) fields are not ported yet")
    x = pts.reshape(-1, 3)
    dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

    pe = (cfg.multires, cfg.multires_views)
    masks = barf_masks(cfg, step, pts.device)
    if resolve_use_fused(cfg, pts.device):
        raw_alpha, raw_rgb = fused_field_apply(params, x.contiguous(), dirs.contiguous(),
                                               cfg.n_blocks, pe, pe_masks=masks, warp=warp)
    else:
        out = fused_mlp_plain(x, dirs, flatten_params(params, cfg.n_blocks), cfg.n_blocks, pe,
                              warp=warp, masks=masks, compute_dtype=cfg.compute_dtype)
        raw_alpha, raw_rgb = out[:, 0], out[:, 1:4]
    return raw_alpha.reshape(R, S), raw_rgb.reshape(R, S, 3)


def field_slice(params: Params, k: int) -> Params:
    """Field k of a stack of fields."""
    return tree_map(lambda x: x[k], params)


def apply_stacked_fields(params: Params, cfg: FieldConfig, pts, viewdirs, step=None):
    """n stacked fields on per-field inputs: pts [n, R, S, 3], viewdirs
    [n, R, 3] -> (raw_alpha [n, R, S], raw_rgb [n, R, S, 3]). The field axis
    is a Python loop; a single-launch stacked kernel is not ported yet."""
    n = pts.shape[0]
    outs = [apply_field(field_slice(params, k), cfg, pts[k], viewdirs[k], step=step)
            for k in range(n)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
