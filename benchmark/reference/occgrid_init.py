"""The reference of the occupancy-grid appearance-init step
(steps/occgrid_init.py, the app apps/occgrid_init.py): one NeRF field on
frame-0 rays, marched through a density grid that skips empty space.

A step: before every UPDATE_EVERY-th step the grid's density EMA takes
max(ema * EMA_DECAY, density) on a random quarter of its cells (every cell
on a grid's first update), the density read at one jittered point a cell;
then each ray takes N_samples jittered fixed steps from near to far, looks
up each sample's cell (the index truncates, points outside the box are
empty), keeps its occupied samples in depth order up to the budget, and
renders them (the empty slots at far, their raw density -1e9); the loss is
the photometric MSE and Adam takes one step.

Departures from nerfacc's OccGridEstimator, which the reference repository
drives (models/star_nerfacc.py, train_app_init_nerfacc.py), shared with the
program: a fixed budget of max(N_samples // 4, 32) samples a ray in place
of nerfacc's packed variable-length samples, and no dynamic resizing of the
ray batch towards target_sample_batch_size (train_app_init_nerfacc.py:99-105);
fixed march steps of (far - near) / N_samples in place of render_step_size
steps (render_step_size only sets the occupancy threshold
density * render_step_size > OCC_THRESHOLD); the refresh of a random
quarter of the cells and a fixed threshold stand for nerfacc's partial
updates.

The inputs of a run that the program's step and this reference share are
made here, from the run's own draws (benchmark/inputs.py): the ray origins
scaled into the grid's box (the workload's ``origin_scale``), the grid at
set-up from the first batch, and each update's draws from the batch of its
step. Float32 with TF32 off, or the control's float8 products
(reference/star.py). It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import train
from .star import Model, composite, dot_for, field, schedule

FIELD = "static_coarse"  # the inputs' field that the app trains
UPDATE_EVERY = 16
EMA_DECAY = 0.95
REFRESH = 0.25  # the share of cells an update refreshes
OCC_THRESHOLD = 1e-2  # on density * render_step_size
COARSE = 16  # cells a side of the set-up grid's noise, before it is upsampled
# the set-up grid's occupied cells: their EMA over the threshold, from the
# first factor to the second, so that one decay (EMA_DECAY) empties them
BAND = (1.01, 1.05)
RAW_EMPTY = -1e9


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The march and the grid of a configuration: the box [-far, far]^3 in
    scaled units, ``res`` cells a side, ``n_march`` steps a ray, ``budget``
    samples kept."""

    near: float
    far: float
    res: int
    n_march: int
    budget: int
    step_size: float

    @staticmethod
    def from_flags(flags: Dict) -> "Geometry":
        scale = flags["scale_factor"] if flags.get("scale_factor", -1) > 0 else 1.0
        n = flags["N_samples"]
        return Geometry(flags["near"] * scale, flags["far"] * scale, flags["grid_resolution"], n,
                        min(max(n // 4, 32), n), flags["render_step_size"])

    def box(self, device):
        """(lo [3], hi [3]) in float32."""
        return (torch.full((3,), -self.far, device=device),
                torch.full((3,), self.far, device=device))


def rays(workload: Dict, b: Dict):
    """(origins, directions) of a batch: its origins scaled into the box."""
    return b["rays_o"] * workload["origin_scale"], b["rays_d"]


def initial_grid(flags: Dict, workload: Dict, b: Dict):
    """(density EMA [res]^3, updates made) of the grid at set-up, from the
    first batch's targets: COARSE^3 of them (cycled where the batch has
    fewer) upsampled trilinearly, the workload's ``occupied_share`` of the
    cells with the highest values occupied: smooth blobs of occupied space,
    so that some rays cross more occupied samples than the budget and most
    cross fewer. The empty cells' EMA is the noise scaled to reach the
    threshold at the blobs' edge; the occupied cells' lies in BAND over the
    threshold, in the noise's order: cells that the field's density no
    longer holds up, which one decay empties. So an update turns every
    refreshed cell's occupancy to what the field's density says there,
    and the march after it shows whether the update was made and decayed."""
    geo = Geometry.from_flags(flags)
    noise = _cycled(b["target"].reshape(-1), COARSE ** 3).reshape(1, 1, COARSE, COARSE, COARSE)
    up = F.interpolate(noise, size=(geo.res,) * 3, mode="trilinear", align_corners=False)[0, 0]
    q = torch.quantile(up.reshape(-1), 1.0 - workload["grid"]["occupied_share"])
    thr = OCC_THRESHOLD / geo.step_size
    above = BAND[0] + (BAND[1] - BAND[0]) * (up - q) / (up.max() - q)
    return (torch.where(up > q, thr * above, up * (thr / q)),
            int(workload["grid"]["updates"]))


def update_draws(b: Dict, res: int) -> Dict[str, torch.Tensor]:
    """An update's draws from the batch of its step: its march uniforms
    (cycled to res^3), read as the refresh draw and, with two
    rearrangements of the cells, as the jitter's three axes."""
    n = res ** 3
    u = _cycled(b["u_strat"].reshape(-1), n)
    return {"u_jitter": torch.stack([u, u.flip(0), u.roll(n // 2)], -1).reshape(res, res, res, 3),
            "u_refresh": u.roll(n // 4).reshape(res, res, res)}


def _cycled(u, n: int):
    return (u if u.numel() >= n else u.repeat(-(-n // u.numel())))[:n]


def occupied(ema, geo: Geometry):
    return ema * geo.step_size > OCC_THRESHOLD


def update(ema, first: bool, density_fn, geo: Geometry, draws: Dict):
    """The EMA after one update: density_fn at each cell's centre jittered
    by u_jitter - 0.5 cells; refreshed cells (u_refresh < REFRESH, or every
    cell with ``first``) take max(ema * EMA_DECAY, density)."""
    r = geo.res
    lo, hi = geo.box(ema.device)
    idx = (torch.arange(r, dtype=torch.float32, device=ema.device) + 0.5) / r
    centers = lo + torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1) * (hi - lo)
    pts = centers + (draws["u_jitter"] - 0.5) * ((hi - lo) / r)
    density = density_fn(pts.reshape(-1, 3)).reshape(r, r, r)
    refresh = draws["u_refresh"] < REFRESH
    if first:
        refresh = torch.ones_like(refresh)
    return torch.where(refresh, torch.maximum(ema * EMA_DECAY, density), ema)


def march(occ, geo: Geometry, rays_o, rays_d, u):
    """(z [R, budget], valid [R, budget], occupied samples a ray [R]): the
    jittered fixed-step march, each sample's cell looked up, the occupied
    samples put in order into the first slots (a sample's slot is the count
    of occupied samples before it), the rest at far."""
    R, n, r = rays_o.shape[0], geo.n_march, geo.res
    t = torch.cat([torch.arange(n - 1, dtype=torch.float32, device=u.device) / (n - 1),
                   torch.ones(1, device=u.device)])
    z = (geo.near * (1.0 - t) + geo.far * t).expand(R, n) + u * ((geo.far - geo.near) / n)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    lo, hi = geo.box(u.device)
    frac = (pts - lo) / (hi - lo)
    inside = ((frac >= 0.0) & (frac < 1.0)).all(-1)
    cell = (frac * r).to(torch.int64).clamp(0, r - 1)
    hit = occ[cell[..., 0], cell[..., 1], cell[..., 2]] & inside
    slot = torch.cumsum(hit.to(torch.int64), -1) - 1
    kept = hit & (slot < geo.budget)
    ray = torch.arange(R, device=u.device)[:, None].expand(R, n)
    z_sel = torch.full((R, geo.budget), geo.far, device=u.device)
    valid = torch.zeros((R, geo.budget), dtype=torch.bool, device=u.device)
    z_sel[ray[kept], slot[kept]] = z[kept]
    valid[ray[kept], slot[kept]] = True
    return z_sel, valid, hit.sum(-1)


def run_steps(flags: Dict, workload: Dict, params0, batches: List[Dict], n_steps: int, state,
              precision: str = "f32", chunk_points: int = 1 << 18) -> Dict:
    """n_steps steps from params0's field and the grid at set-up (phase:
    the workload's ``grid`` ``phase`` steps into the update cycle); batch i
    with its march draws u_strat. Returns what reference.train.run_steps
    returns, over the field's leaves, and the grid's EMA after the steps
    (``ema``)."""
    model = Model.from_flags(flags)
    geo = Geometry.from_flags(flags)
    dot = dot_for(precision)
    init = train.leaves_of({FIELD: params0[FIELD]})
    live = {n: t.detach().clone().to(torch.float32).requires_grad_(True) for n, t in init.items()}
    p = train.rebuild({FIELD: params0[FIELD]}, live)[FIELD]
    opt = train.adam(flags, live, dict.fromkeys(live, 0),
                     [schedule(flags["lrate"], **train.decay(flags))], None, state)
    ema, updates = initial_grid(flags, workload, batches[0])
    count = workload["grid"]["phase"]

    def density(pts):
        """The field's density (post-softplus) at pts [N, 3], each seen
        along (0, 0, -1), in chunks."""
        down = torch.zeros(1, 3, device=pts.device)
        down[0, 2] = -1.0
        parts = [pts[a:a + chunk_points] for a in range(0, len(pts), chunk_points)]
        return torch.cat([F.softplus(field(p, x, down.expand(len(x), 3), model, dot)[0])
                          for x in parts])

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    losses, grads = [], None
    try:
        for i in range(n_steps):
            b = batches[i]
            if count % UPDATE_EVERY == 0:
                with torch.no_grad():
                    ema = update(ema, updates == 0, density, geo, update_draws(b, geo.res))
                updates += 1
            count += 1
            rays_o, rays_d = rays(workload, b)
            z, valid, _ = march(occupied(ema, geo), geo, rays_o, rays_d, b["u_strat"])
            R = rays_o.shape[0]
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            chunk = max(1, chunk_points // geo.budget)
            total = 0.0
            for a in range(0, R, chunk):
                rows = slice(a, min(R, a + chunk))
                zr = z[rows]
                S = zr.shape[1]
                pts = rays_o[rows, None, :] + rays_d[rows, None, :] * zr[..., None]
                dirs = viewdirs[rows, None, :].expand(-1, S, 3).reshape(-1, 3)
                raw, rgb = field(p, pts.reshape(-1, 3), dirs, model, dot)
                raw = torch.where(valid[rows], raw.reshape(-1, S), torch.full_like(zr, RAW_EMPTY))
                out = composite(raw, rgb.reshape(-1, S, 3), None, None, zr, rays_d[rows], model)
                share = torch.sum((out["rgb"] - b["target"][rows]) ** 2) / (3 * R)
                share.backward()
                total += float(share.detach())
            losses.append(total)
            g = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in live.items()}
            if i == 0:
                grads = {n: t.detach().to("cpu", copy=True) for n, t in g.items()}
            opt.step(g)
            for t in live.values():
                t.grad = None
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    changes = {n: (live[n].detach() - init[n].to(torch.float32)).to("cpu") for n in live}
    return {"losses": losses, "grads": grads, "changes": changes, "clip_norms": opt.clip_norms,
            "ema": ema}
