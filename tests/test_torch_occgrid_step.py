"""The occupancy-grid app's step (apps/occgrid_init.GridStep) against the
benchmark's plain reference of it (benchmark/reference/occgrid_init.py),
on the CPU in float32, at a small size: a 16^3 grid, 40 rays of 128 march
steps kept to a budget of 32, a 4 x 32 field.

- The march alone and the update alone, given the same grid and draws:
  bit for bit (the same float32 arithmetic on the positions and the EMA;
  the compaction by another algorithm).
- Three steps across a grid update (before the second): each step's loss,
  each leaf's gradient at the first step, each leaf's change over the three
  and the grid's EMA after them. The field runs the program's plain path
  and the reference's own equations, the same float32 arithmetic in
  another order; on this seed the losses were equal and the gaps 2.1e-7
  (gradients), 2.1e-5 (changes: Adam divides by the root of a second
  moment near the gradient's square, which amplifies rounding) and 1.7e-7
  (EMA) of each leaf's or the EMA's largest magnitude, held to about ten
  times that: 1e-6 (losses, relative), 4e-6, 2e-4, 3e-6. Two other seeds
  (2**31 + 101, 3e9 + 7) read up to 2.4e-6, 2.2e-5 and 2.2e-7.
- Two planted faults fail that comparison on all three seeds: a
  compaction that keeps each ray's last occupied samples in place of its
  first (gradients 0.41 to 2.7 of the largest), and an update without the
  EMA's decay (changes 0.16 to 3.2, EMA 1.6e-2 to 5.0e-2: the set-up
  grid's occupied cells sit just over the threshold, and one decay
  empties those the update refreshes).
- train() runs its steps through the step function: a grid update before
  steps 0, 16 and 32 of 36, and occgrid.counts counts the marches and
  updates.
"""

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import inputs  # noqa: E402
from benchmark.reference import occgrid_init as ref  # noqa: E402
from benchmark.run import load_cell  # noqa: E402
from benchmark.steps.common import configs, program_leaves, resume  # noqa: E402
from startrax_torch.apps import occgrid_init as app  # noqa: E402
from startrax_torch.kernels import occgrid  # noqa: E402
from startrax_torch.train import optim  # noqa: E402
from startrax_torch.utils import config as tconfig  # noqa: E402

CELL = "star_carla_nerfacc.occgrid_init"
SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=2, netwidth_fine=16, N_rand=40,
             N_samples=128, grid_resolution=16, mixed_precision=False)
SEED = 2**31 + 29
STEPS = 3
TOL = {"losses": 1e-6, "grads": 4e-6, "changes": 2e-4, "ema": 3e-6}


def _setup(occupied_share=0.3):
    """(flags, workload, inputs) of the cell at SMALL size, with the update
    before the second of three steps: the march runs before it and after."""
    _, _, workload, config = load_cell(CELL)
    flags = {**config["flags"], **SMALL}
    workload = dict(workload, grid=dict(workload["grid"], occupied_share=occupied_share,
                                        phase=app.GRID_UPDATE_EVERY - 1))
    return flags, workload, inputs.make(flags, workload, SEED, "cpu", pool=STEPS)


def _program(flags, workload, feed, occ_cfg=None):
    """The app's GridStep over a copy of the inputs' field, as the app
    builds it, with its optimizer resumed from the inputs' state."""
    cfg, _, _ = configs(flags)
    tree, leaves = program_leaves({ref.FIELD: feed.params[ref.FIELD]})
    opt = optim.make_appinit_optimizer(
        tree, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch, decay_rate=cfg.lrate_decay_rate,
        decay_epochs=cfg.lrate_decay, decay_milestones=cfg.lrate_decay_steps)
    resume(opt, leaves, feed.resume)
    geo = ref.Geometry.from_flags(flags)
    ema, updates = ref.initial_grid(flags, workload, feed.batches[0])
    step = app.GridStep(tree[ref.FIELD], app.field_config(cfg), opt,
                        occ_cfg or app.occgrid_config(cfg), geo.near, geo.far,
                        {"density_ema": ema, "step": updates}, count=workload["grid"]["phase"])
    return step, leaves, geo


def _run_program(flags, workload, feed, occ_cfg=None):
    step, leaves, geo = _program(flags, workload, feed, occ_cfg)
    start = {n: t.detach().clone() for n, t in leaves.items()}
    losses, grads = [], None
    for i, b in enumerate(feed.batches[:STEPS]):
        draws = (ref.update_draws(b, geo.res) if step.count % app.GRID_UPDATE_EVERY == 0
                 else {})
        rays_o, rays_d = ref.rays(workload, b)
        loss, _ = step({"rays_o": rays_o, "rays_d": rays_d, "target": b["target"]},
                       u=b["u_strat"], **draws)
        losses.append(float(loss))
        if i == 0:
            grads = {n: t.grad.detach().clone() for n, t in leaves.items()}
    changes = {n: t.detach() - start[n] for n, t in leaves.items()}
    return {"losses": losses, "grads": grads, "changes": changes,
            "ema": step.grid["density_ema"]}


def _gaps(got, want):
    """Each compared quantity's largest gap over its scale (module
    docstring)."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))

    def leafwise(key):
        return max(float((got[key][n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                   for n, w in want[key].items())

    ema = float((got["ema"] - want["ema"]).abs().max()) / float(want["ema"].abs().max())
    return {"losses": losses, "grads": leafwise("grads"), "changes": leafwise("changes"),
            "ema": ema}


@pytest.fixture(scope="module")
def case():
    flags, workload, feed = _setup()
    assert workload["grid"]["phase"] % app.GRID_UPDATE_EVERY == app.GRID_UPDATE_EVERY - 1
    return flags, workload, feed, ref.run_steps(flags, workload, feed.params, feed.batches,
                                                STEPS, feed.resume)


def test_march_alone_bit_for_bit():
    flags, workload, feed = _setup()
    b = feed.batches[0]
    geo = ref.Geometry.from_flags(flags)
    ema, updates = ref.initial_grid(flags, workload, b)
    occ_cfg = app.occgrid_config(configs(flags)[0])
    rays_o, rays_d = ref.rays(workload, b)
    z, valid, n = occgrid.march_and_select({"density_ema": ema, "step": updates}, occ_cfg,
                                           rays_o, rays_d, geo.near, geo.far, u=b["u_strat"])
    z_r, valid_r, n_r = ref.march(ref.occupied(ema, geo), geo, rays_o, rays_d, b["u_strat"])
    assert torch.equal(valid, valid_r) and torch.equal(n, n_r) and torch.equal(z, z_r)
    # the case has empty rays, rays within the budget and rays over it
    assert (n == 0).any() and ((n > 0) & (n <= geo.budget)).any() and (n > geo.budget).any()


@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_update_alone_bit_for_bit(first):
    flags, workload, feed = _setup()
    geo = ref.Geometry.from_flags(flags)
    ema, _ = ref.initial_grid(flags, workload, feed.batches[0])
    occ_cfg = occgrid.OccGridConfig(resolution=geo.res, aabb_min=(-geo.far,) * 3,
                                    aabb_max=(geo.far,) * 3,
                                    render_step_size=geo.step_size)

    def blob(pts):
        return 6.0 * torch.exp(-((pts - 0.3) ** 2).sum(-1) / 0.05)

    draws = ref.update_draws(feed.batches[1], geo.res)
    got = occgrid.update_grid({"density_ema": ema, "step": 0 if first else 7}, blob, occ_cfg,
                              **draws)
    want = ref.update(ema, first, blob, geo, draws)
    assert got["step"] == (1 if first else 8)
    assert torch.equal(got["density_ema"], want)
    moved = got["density_ema"] != ema
    assert moved.any() and (first or not moved.all())


def test_three_steps_across_an_update(case):
    flags, workload, feed, want = case
    got = _run_program(flags, workload, feed)
    gaps = _gaps(got, want)
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    assert not torch.equal(got["ema"], ref.initial_grid(flags, workload, feed.batches[0])[0])


def _last_occupied_march(grid, cfg, rays_o, rays_d, near, far, u=None, generator=None):
    """march_and_select with a planted fault: each ray keeps its last
    n_selected occupied samples (in depth order) in place of its first."""
    R, n = rays_o.shape[0], cfg.n_march
    t = torch.cat([torch.arange(n - 1, dtype=torch.float32) / (n - 1), torch.ones(1)])
    z = (near * (1.0 - t) + far * t).expand(R, n) + u * ((far - near) / n)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    occ = occgrid._lookup(occgrid.occupancy(grid, cfg), pts, cfg)
    after = occ.flip(-1).to(torch.int64).cumsum(-1).flip(-1)  # occupied samples at or after
    kept = occ & (after <= cfg.n_selected)
    sel = torch.sort((~kept).to(torch.uint8), dim=-1, stable=True).indices[:, :cfg.n_selected]
    valid = torch.gather(kept, 1, sel)
    z_sel = torch.where(valid, torch.gather(z, 1, sel), torch.full_like(z[:, :1], far))
    return z_sel, valid, occ.sum(-1)


@pytest.mark.parametrize("fault", ["last_occupied", "no_decay"])
def test_planted_fault_fails(case, monkeypatch, fault):
    flags, workload, feed, want = case
    occ_cfg = None
    if fault == "last_occupied":
        monkeypatch.setattr(occgrid, "march_and_select", _last_occupied_march)
    else:
        cfg, _, _ = configs(flags)
        occ_cfg = dataclasses.replace(app.occgrid_config(cfg), ema_decay=1.0)
    gaps = _gaps(_run_program(flags, workload, feed, occ_cfg), want)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


def test_train_runs_the_step_function(tmp_path, monkeypatch):
    """train() on a tiny synthetic scene: its march and update calls in
    order, and occgrid.counts."""
    events = []
    update, march, step_call = occgrid.update_grid, occgrid.march_and_select, app.GridStep.__call__

    def logged(name, fn):
        def run(*args, **kw):
            events.append(name)
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(occgrid, "update_grid", logged("update", update))
    monkeypatch.setattr(occgrid, "march_and_select", logged("march", march))
    monkeypatch.setattr(app.GridStep, "__call__", logged("step", step_call))
    cfg = tconfig.Config(
        expname="cadence", dataset_type="synthetic", num_frames=4, num_vehicles=1, near=2.0,
        far=8.0, scale_factor=-1.0, netdepth=2, netwidth=16, N_samples=32, N_rand=16,
        steps_per_epoch=12, epochs_appearance=3, epoch_ckpt=3, mixed_precision=False,
        synth_height=16, synth_views=2, synth_val_views=1, num_workers=1, grid_resolution=8,
        render_step_size=0.05, appearance_init_thres=1e-9, basedir=str(tmp_path),
        synth_cache_dir=str(tmp_path / "cache"))
    occgrid.reset_counts()
    _, grid = app.train(cfg, device="cpu")
    steps = [i for i, e in enumerate(events) if e == "step"]
    assert len(steps) == 36 and events[:3] == ["step", "update", "march"]
    before = [sum(1 for e in events[:i] if e == "step") - 1 for i, e in enumerate(events)
              if e == "update"]
    assert before == [0, 16, 32] and grid["step"] == 3
    assert occgrid.counts == {"marches": 36, "updates": 3}
