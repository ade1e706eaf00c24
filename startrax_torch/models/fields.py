"""Radiance-field MLPs as init/apply functions over parameter dicts (PyTorch).

Counterpart of startrax/models/fields.py. Parameters keep the JAX layout:
{"lin_in", "blocks": [{"fc0", "fc1"}], "lin_out", "alpha", "feature",
"views", "rgb"}, each {"w": [in, out], "b": [out]}; K dynamic fields stack
every leaf on a leading [K] axis.

Dispatch: with ``use_fused`` (default: on for CUDA tensors) the field runs
through the fused MLP kernels (kernels/fused_mlp.py), and a stack of fields
through one launch of them; otherwise through their plain version,
``fused_mlp_plain``, in ``compute_dtype`` (bf16 operands with f32
accumulation, rounded as the kernels round, or f32). A time-conditioned
field (``input_dims`` 4, nerf_time) appends the time to each point, encodes
points and directions outside the kernels and runs their pre-encoded mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import resolve
from ..kernels.fused_mlp import (
    flatten_params,
    fused_field_apply,
    fused_mlp_plain,
    fused_stacked_apply,
    fused_stacked_plain,
    pe_mask_row,
)
from ..ops.encoding import barf_weights, encoding_dim, positional_encoding
from ..utils.tree import tree_map, tree_stack

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
    residual block starts as the identity). device=None is the card
    (device.resolve)."""
    device = resolve(device)
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
    device = resolve(device)
    return tree_stack([init_field(cfg, generator, device) for _ in range(n)])


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


def apply_field(params: Params, cfg: FieldConfig, pts, viewdirs, step=None, warp=None,
                time=None):
    """Evaluate the field on pts [R, S, 3] with per-ray viewdirs [R, 3].

    warp: optional packed [16] SE(3) (M row-major at [0:9], t at [9:12])
    applied to the inputs first, differentiably. time: a scalar (or one
    value per point) appended to every point as a fourth coordinate, for a
    field with input_dims 4; it takes no warp. Returns (raw_alpha [R, S],
    raw_rgb [R, S, 3]) in f32."""
    R, S = pts.shape[0], pts.shape[1]
    assert tuple(pts.shape) == (R, S, 3) and tuple(viewdirs.shape) == (R, 3)
    if warp is not None and time is not None:
        raise ValueError("warp is only supported for 3-d inputs")
    x = pts.reshape(-1, 3)
    dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    if time is not None:
        t = torch.as_tensor(time, dtype=x.dtype, device=x.device).reshape(-1)
        x = torch.cat([x, t.expand(x.shape[0])[:, None]], -1)
    if x.shape[-1] != cfg.input_dims:
        raise ValueError(f"the field takes {cfg.input_dims}-d inputs, got {x.shape[-1]}-d "
                         "(a time-conditioned field needs time)")
    if cfg.input_dims != 3:
        return _apply_encoded(params, cfg, x, dirs, step, R, S)

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


def _down_dirs(pts):
    """(0, 0, -1) for each point of pts [N, 3], made on the device: a copy
    from the host would wait for the device's queue to drain."""
    return torch.nn.functional.pad(pts.new_full((1, 1), -1.0), (2, 0)).expand(pts.shape[0], 3)


def query_density(params: Params, cfg: FieldConfig, pts):
    """Density at world points [N, 3] (post-softplus), seen along -z: the
    nerfacc example models' query_density (startrax/models/fields.py). On
    the card it is one fused forward, which saves nothing under
    torch.no_grad."""
    raw_alpha, _ = apply_field(params, cfg, pts[:, None, :], _down_dirs(pts))
    return torch.nn.functional.softplus(raw_alpha[:, 0])


def query_opacity(params: Params, cfg: FieldConfig, pts, step_size: float):
    """Opacity of a step through each point: 1 - exp(-density * step)."""
    return 1.0 - torch.exp(-query_density(params, cfg, pts) * step_size)


def query_rgb(params: Params, cfg: FieldConfig, pts, viewdirs=None):
    """Radiance at points [N, 3] (post-sigmoid) along viewdirs [N, 3]
    (default -z): the vertex colours of utils/mesh.extract_color_mesh."""
    if viewdirs is None:
        viewdirs = _down_dirs(pts)
    _, raw_rgb = apply_field(params, cfg, pts[:, None, :], viewdirs)
    return torch.sigmoid(raw_rgb[:, 0])


def _apply_encoded(params: Params, cfg: FieldConfig, x, dirs, step, R: int, S: int):
    """The field on points x [N, input_dims] and directions [N, 3], encoded
    outside the kernels (with the BARF schedule at ``step``) and run through
    their pre-encoded mode or its plain version."""
    emb = positional_encoding(x, cfg.multires, step=step, end_barf=cfg.end_barf)
    emb_dirs = positional_encoding(dirs, cfg.multires_views, step=step, end_barf=cfg.end_barf)
    if resolve_use_fused(cfg, x.device):
        raw_alpha, raw_rgb = fused_field_apply(params, emb.contiguous(), emb_dirs.contiguous(),
                                               cfg.n_blocks)
    else:
        out = fused_mlp_plain(emb, emb_dirs, flatten_params(params, cfg.n_blocks), cfg.n_blocks,
                              compute_dtype=cfg.compute_dtype)
        raw_alpha, raw_rgb = out[:, 0], out[:, 1:4]
    return raw_alpha.reshape(R, S), raw_rgb.reshape(R, S, 3)


def field_slice(params: Params, k: int) -> Params:
    """Field k of a stack of fields."""
    return tree_map(lambda x: x[k], params)


def apply_stacked_fields(params: Params, cfg: FieldConfig, pts, viewdirs, step=None):
    """n stacked fields on per-field inputs: pts [n, R, S, 3], viewdirs
    [n, R, 3] -> (raw_alpha [n, R, S], raw_rgb [n, R, S, 3]), differentiable
    in the params and in pts and viewdirs.

    With the fused kernels, one launch evaluates all n fields, BARF masks
    included when ``step`` makes them active (kernels.fused_mlp.
    fused_stacked_apply); otherwise the plain version, field by field."""
    n, R, S = pts.shape[0], pts.shape[1], pts.shape[2]
    assert tuple(pts.shape) == (n, R, S, 3) and tuple(viewdirs.shape) == (n, R, 3)
    if cfg.input_dims != 3:
        # the JAX package's apply_stacked_fields takes no time either
        raise NotImplementedError("stacked fields take 3-D points: there is no time-conditioned "
                                  "stack of fields")
    x = pts.reshape(n, R * S, 3)
    dirs = viewdirs[:, :, None, :].expand(n, R, S, 3).reshape(n, R * S, 3)
    pe = (cfg.multires, cfg.multires_views)
    masks = barf_masks(cfg, step, pts.device)
    if resolve_use_fused(cfg, pts.device):
        raw_alpha, raw_rgb = fused_stacked_apply(params, x.contiguous(), dirs.contiguous(),
                                                 cfg.n_blocks, pe, pe_masks=masks)
    else:
        out = fused_stacked_plain(x, dirs, flatten_params(params, cfg.n_blocks), cfg.n_blocks,
                                  pe, masks=masks, compute_dtype=cfg.compute_dtype)
        raw_alpha, raw_rgb = out[..., 0], out[..., 1:4]
    return raw_alpha.reshape(n, R, S), raw_rgb.reshape(n, R, S, 3)
