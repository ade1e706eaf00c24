"""The occupancy-grid appearance-init step (apps/occgrid_init.GridStep: a
grid update before every 16th step, then the march, the field on the
selected samples, the loss and Adam) with the optimizer that the app
builds: one group over the field, its decay, no accumulation, no clip.
Its reference is reference/occgrid_init.py, whose helpers make the inputs
both sides share: the ray origins scaled into the grid's box, the grid at
set-up from the first batch (made at the first step, which the check
runs), and each update's draws from the batch of its step."""

from __future__ import annotations

import sys
from typing import Dict, List

from .. import work
from ..reference import occgrid_init as ref
from ..work_occgrid import OccgridCall
from .common import Program, configs, program_leaves, resume


def build(flags: Dict, workload: Dict, params, state) -> Program:
    from startrax_torch.apps import occgrid_init as app
    from startrax_torch.train import optim

    cfg, _, _ = configs(flags)
    tree, leaves = program_leaves({ref.FIELD: params[ref.FIELD]})
    opt = optim.make_appinit_optimizer(
        tree, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch, decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay, decay_milestones=cfg.lrate_decay_steps)
    resume(opt, leaves, state)
    geo = ref.Geometry.from_flags(flags)
    held = {}

    def step(b):
        if not held:
            ema, updates = ref.initial_grid(flags, workload, b)
            held["step"] = app.GridStep(
                tree[ref.FIELD], app.field_config(cfg), opt, app.occgrid_config(cfg), geo.near,
                geo.far, {"density_ema": ema, "step": updates}, cfg.white_bkgd, cfg.far_dist,
                count=workload["grid"]["phase"])
            _print_shares(ema, geo, workload, b)
        grid_step = held["step"]
        draws = (ref.update_draws(b, geo.res)
                 if grid_step.count % app.GRID_UPDATE_EVERY == 0 else {})
        rays_o, rays_d = ref.rays(workload, b)
        batch = {"rays_o": rays_o, "rays_d": rays_d, "target": b["target"]}
        return grid_step(batch, u=b["u_strat"], **draws)[0]

    return Program(step, leaves, opt)


def _print_shares(ema, geo, workload: Dict, b: Dict) -> None:
    """The set-up grid's share of occupied cells, and the share of the
    first batch's rays that cross more occupied samples than the budget."""
    rays_o, rays_d = ref.rays(workload, b)
    _, _, n_occ = ref.march(ref.occupied(ema, geo), geo, rays_o, rays_d, b["u_strat"])
    print(f"grid at set-up: {float(ref.occupied(ema, geo).float().mean()):.4f} of the cells "
          f"occupied; {float((n_occ > geo.budget).float().mean()):.4f} of the first batch's rays "
          f"over the budget of {geo.budget} (occupied samples a ray: median "
          f"{float(n_occ.float().median()):.0f}, largest {int(n_occ.max())})", file=sys.stderr)


def calls(flags: Dict, workload: Dict) -> List[work.FieldCall]:
    """The step's fused forward and backward call, the field on every slot
    of the budget, with the march's and the grid's sizes (the grid
    update's forward-only call is counted by work_occgrid.py)."""
    static, _, _, _ = work.field_shapes(flags)
    geo = ref.Geometry.from_flags(flags)
    return [OccgridCall("occgrid field", static, flags["N_rand"] * geo.budget,
                        rays=flags["N_rand"], n_march=geo.n_march, res=geo.res)]
