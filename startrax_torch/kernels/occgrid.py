"""Occupancy-grid ray marching with empty-space skipping (PyTorch).

Counterpart of startrax/kernels/occgrid.py, which is plain jnp (no Pallas):
- the grid is a dense [res, res, res] f32 density EMA over the scene AABB,
  with a bool occupancy (density * render_step_size > occ_threshold);
- an update evaluates the density at one jittered point a cell, refreshes a
  random subset of cells (all of them on the first update) and keeps the
  EMA elsewhere;
- the march takes n_march fixed steps a ray (jittered in training), looks
  up each sample's occupancy, moves the occupied samples to the front in
  depth order (a stable sort on the mask) and keeps the first n_selected;
  the other slots are flagged invalid and sit at ``far``.

Randomness is explicit: the update's jitter and refresh uniforms and the
march's jitter uniforms are arguments; where they are absent they are drawn
from the ``generator`` given.

Each update runs inside the span ``occgrid.update`` and each march inside
``occgrid.march`` (utils/profiling.span); ``counts`` holds how many of each
ran since ``reset_counts()``. Neither reads a value from the device: the
AABB is copied to a device once, at its first use there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import resolve
from ..utils.profiling import span

counts = {"marches": 0, "updates": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 128
    aabb_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    aabb_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    occ_threshold: float = 1e-2  # on density * step_size
    ema_decay: float = 0.95
    update_fraction: float = 0.25  # fraction of cells refreshed per update
    render_step_size: float = 5e-3
    n_march: int = 512  # dense march steps per ray
    n_selected: int = 128  # post-compaction sample budget per ray


def init_grid(cfg: OccGridConfig, device=None) -> Dict[str, Any]:
    """An empty grid on ``device`` (None: the card, device.resolve); its
    step counts the updates (0: none yet, every cell occupied)."""
    r = cfg.resolution
    return {"density_ema": torch.zeros((r, r, r), dtype=torch.float32, device=resolve(device)),
            "step": 0}


def _aabb(cfg: OccGridConfig, device):
    """(lo [3], hi [3]) on ``device``, made once a box and device: a copy
    from the host waits for the device to drain its queue."""
    return _box(cfg.aabb_min, cfg.aabb_max, torch.device(device))


@functools.lru_cache(maxsize=None)
def _box(aabb_min, aabb_max, device):
    box = torch.tensor([aabb_min, aabb_max], dtype=torch.float32, device=device)
    return box[0], box[1]


def _cell_centers(cfg: OccGridConfig, device):
    """[r, r, r, 3] world positions of the cell centres, x on the first axis."""
    r = cfg.resolution
    lo, hi = _aabb(cfg, device)
    idx = (torch.arange(r, dtype=torch.float32, device=device) + 0.5) / r
    frac = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1)
    return lo + frac * (hi - lo)


def _draw(u, shape, generator, device, what):
    if u is not None:
        return torch.as_tensor(u, dtype=torch.float32, device=device).reshape(shape)
    if generator is None:
        raise ValueError(f"{what}: pass the uniforms or a torch.Generator to draw them from")
    return torch.rand(shape, generator=generator, device=device)


def update_grid(grid: Dict[str, Any], density_fn: Callable, cfg: OccGridConfig,
                u_jitter=None, u_refresh=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The grid after one EMA update from the field density.

    density_fn: pts [N, 3] -> density [N] (post-softplus), at one point a
    cell (the centre jittered by u_jitter [r, r, r, 3] - 0.5 cells); the
    cells with u_refresh [r, r, r] < update_fraction (every cell on the first
    update) take max(ema * ema_decay, density), the others keep their EMA.
    Runs under torch.no_grad: no graph is kept."""
    r = cfg.resolution
    ema = grid["density_ema"]
    dev = ema.device
    counts["updates"] += 1
    with span("occgrid.update"), torch.no_grad():
        centers = _cell_centers(cfg, dev)
        lo, hi = _aabb(cfg, dev)
        jitter = (_draw(u_jitter, centers.shape, generator, dev, "update_grid") - 0.5) \
            * ((hi - lo) / r)
        density = density_fn((centers + jitter).reshape(-1, 3)).reshape(r, r, r)
        refresh = _draw(u_refresh, (r, r, r), generator, dev, "update_grid") \
            < cfg.update_fraction
        if grid["step"] == 0:
            refresh = torch.ones_like(refresh)
        new_ema = torch.where(refresh, torch.maximum(ema * cfg.ema_decay, density), ema)
    return {"density_ema": new_ema, "step": grid["step"] + 1}


def occupancy(grid: Dict[str, Any], cfg: OccGridConfig):
    """[r, r, r] bool: density * render_step_size > occ_threshold; all True
    before the first update."""
    if grid["step"] == 0:
        return torch.ones_like(grid["density_ema"], dtype=torch.bool)
    return grid["density_ema"] * cfg.render_step_size > cfg.occ_threshold


def _lookup(grid_occ, pts, cfg: OccGridConfig):
    """Occupancy at world points [..., 3] (points outside the AABB are
    unoccupied): the cell index truncates frac * res toward zero, then
    clips."""
    lo, hi = _aabb(cfg, pts.device)
    frac = (pts - lo) / (hi - lo)
    inside = ((frac >= 0.0) & (frac < 1.0)).all(dim=-1)
    r = cfg.resolution
    idx = (frac * r).to(torch.int64).clamp(0, r - 1)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    return grid_occ.reshape(-1)[flat] & inside


def march_and_select(grid: Dict[str, Any], cfg: OccGridConfig, rays_o, rays_d, near: float,
                     far: float, u=None, generator: Optional[torch.Generator] = None):
    """Fixed-step march and occupied-sample compaction.

    Returns (z_sel [R, n_selected], valid [R, n_selected] bool, n_occupied
    [R]): the first slots of a ray are its occupied samples in depth order,
    the rest are invalid and at ``far``; n_occupied counts the ray's
    occupied samples before the budget cut. The march is jittered by
    u [R, n_march] (one step at most; the last sample may pass ``far``),
    drawn from ``generator`` when u is None; with neither it is not
    jittered."""
    counts["marches"] += 1
    with span("occgrid.march"):
        R, n, dev = rays_o.shape[0], cfg.n_march, rays_o.device
        # the sample positions i / (n - 1), the last one exactly 1
        t = torch.cat([torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1),
                       torch.ones(1, device=dev)]) if n > 1 else torch.zeros(1, device=dev)
        z = (near * (1.0 - t) + far * t).expand(R, n)
        if u is not None or generator is not None:
            z = z + _draw(u, (R, n), generator, dev, "march_and_select") * ((far - near) / n)

        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        occ = _lookup(occupancy(grid, cfg), pts, cfg)  # [R, n_march]

        # stable compaction: occupied first, depth order kept within each part
        order = torch.sort((~occ).to(torch.uint8), dim=-1, stable=True).indices
        sel = order[:, :cfg.n_selected]
        valid = torch.gather(occ, 1, sel)
        z_sel = torch.where(valid, torch.gather(z, 1, sel), torch.full_like(z[:, :1], far))
        return z_sel, valid, occ.sum(dim=-1)


def masked_raw_alpha(raw_alpha, valid):
    """Force alpha -> 0 on invalid (empty-space) slots before compositing:
    their raw density becomes -1e9 (f32)."""
    return torch.where(valid, raw_alpha, torch.full_like(raw_alpha, -1e9))
