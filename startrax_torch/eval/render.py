"""Tiled full-frame rendering for validation and test (PyTorch).

Counterpart of startrax/eval/render.py (``render_image``,
``render_image_nerf_time``, ``render_image_mip``): H*W rays go through
the eval render (for ``render_image``, train.loop.make_eval_render) in
tiles of ``tile`` rays under ``torch.no_grad``, so no graph is kept and
the fused kernels save no activations (kernels/fused_mlp: each tile's
scratch is freed with the tile). The last tile may be short. With a ray
group (parallel.mesh.RayGroup, startrax's ``mesh``) each tile's rays are
split over the ranks, its last ray repeated to a multiple of the world
size, and the outputs all-gathered: every rank returns the whole image.
Each tile's outputs are copied to the host; the result is numpy arrays
[H, W, ...].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve
from ..models.mip import MipConfig, render_star_mip
from ..models.nerf_time import render_nerf_time
from ..models.star import StarConfig
from ..train.loop import make_eval_render

DEFAULT_KEYS = ("rgb", "depth", "rgb0", "depth0", "rgb_static", "rgb_dynamic",
                "depth_static", "depth_dynamic", "dynamic_transmittance",
                "rgb_dynamic_all", "acc", "disp")


def _render_shard(tile_render, o, d, keys, group):
    """tile_render over this rank's part of a tile's rays, the parts'
    outputs of ``keys`` gathered into the whole tile's on every rank."""
    r = o.shape[0]
    m = -(-r // group.world)
    pad = m * group.world - r
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    part = slice(group.rank * m, (group.rank + 1) * m)
    out = tile_render(o[part], d[part])
    return {k: group.all_gather_rows(out[k])[:r] for k in keys if out.get(k) is not None}


def _render_tiles(tile_render, rays_o, rays_d, tile: int, keys, device,
                  group=None) -> Dict[str, np.ndarray]:
    """tile_render(o [r, 3], d [r, 3]) -> outputs, over the H*W rays of
    rays_o, rays_d [H, W, 3] (tensors or arrays) in tiles of ``tile`` rays;
    with a ray group, each tile split over the ranks (_render_shard)."""
    H, W = rays_o.shape[:2]
    n = H * W
    ro, rd = (r.to(torch.float32) if isinstance(r, torch.Tensor)
              else torch.from_numpy(np.array(r, dtype=np.float32))  # a copy: r may be read-only
              for r in (rays_o, rays_d))
    ro, rd = ro.reshape(n, 3), rd.reshape(n, 3)
    chunks: Dict[str, list] = {}
    with torch.no_grad():
        for i in range(0, n, tile):
            o, d = ro[i:i + tile].to(device), rd[i:i + tile].to(device)
            out = (tile_render(o, d) if group is None
                   else _render_shard(tile_render, o, d, keys, group))
            for k in keys:
                if out.get(k) is not None:
                    chunks.setdefault(k, []).append(out[k].cpu().numpy())
    return {k: np.concatenate(parts, axis=0).reshape((H, W) + parts[0].shape[1:])
            for k, parts in chunks.items()}


def render_image(params, cfg: StarConfig, rays_o, rays_d, pose=None, tile: int = 8192,
                 with_test_outputs: bool = False, keys=DEFAULT_KEYS,
                 device=None, group=None) -> Dict[str, np.ndarray]:
    """Eval render of H*W rays (rays_o, rays_d [H, W, 3]) in tiles: host
    arrays [H, W, ...] of ``keys``; keys the render does not give (the
    dynamic maps of appearance init) are skipped. pose: [K, 7] or None.
    device=None is the card (device.resolve). group: a ray group to split
    each tile over (every rank returns the whole image), or None."""
    device = resolve(device)
    eval_render = make_eval_render(cfg, with_test_outputs)
    return _render_tiles(lambda o, d: eval_render(params, o, d, pose), rays_o, rays_d, tile,
                         keys, device, group)


def render_image_nerf_time(params, cfg: StarConfig, rays_o, rays_d, frame, num_frames: int,
                           tile: int = 8192, keys=DEFAULT_KEYS,
                           device=None, group=None) -> Dict[str, np.ndarray]:
    """render_image for the time-conditioned baseline at ``frame``."""
    device = resolve(device)

    def tile_render(o, d):
        return render_nerf_time(params, cfg, o, d, frame, num_frames, train=False)

    return _render_tiles(tile_render, rays_o, rays_d, tile, keys, device, group)


def render_image_mip(params, cfg: MipConfig, rays_o, rays_d, pose=None, tile: int = 8192,
                     with_test_outputs: bool = False, keys=DEFAULT_KEYS,
                     device=None, group=None) -> Dict[str, np.ndarray]:
    """render_image for the mip (IPE) variant (models.mip.render_star_mip,
    eval mode): params and pose [K, 7] (or None) as the mip render takes
    them."""
    device = resolve(device)

    def tile_render(o, d):
        return render_star_mip(params, cfg, o, d, pose=pose, train=False,
                               with_test_outputs=with_test_outputs)

    return _render_tiles(tile_render, rays_o, rays_d, tile, keys, device, group)
