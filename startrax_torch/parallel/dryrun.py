"""Runs of the port's training steps and apps over ranks (PyTorch).

- ``dryrun_multichip(n)``: the twin of ``__graft_entry__.dryrun_multichip``:
  one full online step of the tiny flagship config over ``n`` gloo ranks on
  the CPU, the batch's ray keys sharded, 16 rays a rank, depth loss on.
- ``replay(group, spec)``: a given sequence of online, gauge or app-init
  steps on a given tree, batches and draws, on this rank's shard of each
  batch (group None: the one-process steps). It records what a comparison
  of the N-rank run with the one-process run reads: losses, metrics, each
  step's local grads, the ranks' parameter spread, kernel launches and,
  when asked, step and collective times.
- ``run_app(group, app, entry, argv)``: an app's entry point on this rank.
- ``render(group, ...)``: an eval render, its tiles split over the ranks.
- ``stall(group, seconds, rank)``: one rank that joins no collective while
  the others all-reduce: what a hung peer looks like.
- ``run_jobs(group, jobs)``: several of these in one set of ranks.

The functions that run in the ranks live here, in the port, so that a
spawned rank imports nothing but torch, numpy and startrax_torch
(parallel.mesh.run_ranks pickles them by name).
"""

from __future__ import annotations

import importlib
import statistics
import time

import numpy as np
import torch

from .. import convert
from ..apps.online import _place_batch
from ..models.star import StarConfig
from ..train import loop, optim
from ..utils.tree import tree_leaves, tree_map
from .mesh import RAY_AXIS, params_spread, replicate_params, run_ranks, shard_batch


def _flagship_cfg(tiny: bool = False) -> StarConfig:
    """__graft_entry__._flagship_cfg's configs: the flagship multi-vehicle
    online model, or its tiny float32 twin."""
    if tiny:
        return StarConfig(num_vehicles=2, netdepth=4, netdepth_fine=4, netwidth=32,
                          netwidth_fine=32, n_samples=16, n_importance=16, near=2.0, far=6.0,
                          compute_dtype=torch.float32)
    return StarConfig(num_vehicles=2, netdepth=8, netdepth_fine=8, netwidth=256,
                      netwidth_fine=256, n_samples=256, n_importance=256, near=3.0, far=80.0,
                      compute_dtype=torch.bfloat16)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    rays_o = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o, rays_d


def _dryrun_rank(group):
    cfg = _flagship_cfg(tiny=True)
    n_rays = 16 * group.world
    gen = torch.Generator(device=group.device).manual_seed(0)
    params = loop.init_online_params(cfg, 4, gen, group.device)
    replicate_params(params, group)
    opt = optim.make_fused_star_optimizer(params, lrate_static=5e-4, lrate_dynamic=5e-4,
                                          lrate_pose=5e-4, grad_clip=1.0, ray_group=group)
    step = loop.make_online_train_step(
        cfg, loop.LossConfig(lambda_alpha_entropy=1e-3, lambda_ray_reg=1e-5, use_depth_loss=True,
                             depth_lambda=0.1), opt)
    rng1 = np.random.default_rng(1)
    rays_o, rays_d = _rays(n_rays)
    batch = {"rays_o": rays_o, "rays_d": rays_d,
             "target": rng1.uniform(size=(n_rays, 3)).astype(np.float32),
             "target_depth": rng1.uniform(cfg.near + 0.5, cfg.far - 0.5,
                                          size=(n_rays,)).astype(np.float32),
             "frame": np.int32(2)}
    local = shard_batch(batch, group)
    # the per-ray arrays are this rank's rows; the scalar frame stays whole
    lo = group.rank * 16
    if not (np.array_equal(local["rays_o"], rays_o[lo:lo + 16]) and local["frame"] == 2):
        raise AssertionError(f"batch not sharded over the {RAY_AXIS} axis")
    loss, metrics = step(params, _place_batch(local, group.device), epoch=0,
                         generator=torch.Generator(device=group.device).manual_seed(3))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"loss {float(loss)}")
    return {"loss": float(loss), "fine": float(metrics["fine_loss"]),
            "spread": params_spread(params, group)}


def dryrun_multichip(n_devices: int):
    """One full online step of the tiny flagship config over n_devices gloo
    ranks on the CPU; prints startrax's line and returns the ranks'
    {"loss", "fine", "spread"}."""
    out = run_ranks(_dryrun_rank, n_devices, "gloo", device="cpu", timeout=120.0)
    if len({r["loss"] for r in out}) != 1 or any(r["spread"] != 0.0 for r in out):
        raise AssertionError(f"the ranks disagree: {out}")
    print(f"dryrun_multichip OK: {n_devices} ranks, loss={out[0]['loss']:.5f}, "
          f"fine={out[0]['fine']:.5f}")
    return out


def _launches():
    from ..kernels import fused_mlp as fm

    return dict(fm.launches) | dict(fm.part_launches)


def _median_ms(fn, device, reps=15):
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def replay(group, spec: dict) -> dict:
    """Run spec's steps on this rank (group None: one process on
    spec["device"], default the CPU).

    spec: "kind" ("online", "gauge" or "appinit"); "star_cfg"; "loss_cfg"
    (online, appinit); "params" (a numpy tree: {"nerf", "poses"}, or the
    field tree for appinit), carried onto rank 0 and broadcast from it by
    replicate_params (the other ranks start from zeros); "opt" (the
    optimizer builder's keyword arguments; for "gauge" {"lrate"});
    "step_kw" (the step builder's further keyword arguments); "batches" (a
    global numpy batch a step; each rank steps on its shard); "draws"
    (optional, per step (u_strat, u_pdf) for the whole batch, or None to
    draw from a generator seeded "seed"); "epoch" (default 0); "time"
    (optional: time each step, synced, and the step's collectives alone).

    Returns {"losses", "metrics" (floats a step), "grads" (each step's
    local grads, numpy, in tree order), "spread" (parameter spread over
    the ranks after each step, parallel.mesh.params_spread; 0 without a
    group), "launches" (kernel launches a step), "params" (the final tree,
    numpy), and with "time" "step_ms" and "collective_ms"}."""
    device = group.device if group is not None else torch.device(spec.get("device", "cpu"))
    kind = spec["kind"]
    tree = convert.params_from_numpy(spec["params"], device=device, requires_grad=True)
    if group is not None:
        if group.rank != 0:
            with torch.no_grad():
                for leaf in tree_leaves(tree):
                    leaf.zero_()
        replicate_params(tree, group)
    step_kw = spec.get("step_kw", {})
    if kind == "gauge":
        gauge = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]] * spec["star_cfg"].num_vehicles,
                             device=device, requires_grad=True)
        opt = optim.make_gauge_optimizer(gauge, spec["opt"]["lrate"], ray_group=group)
        step = loop.make_gauge_train_step(spec["star_cfg"], opt, **step_kw)
        watched = [gauge]
    elif kind == "online":
        opt = optim.make_fused_star_optimizer(tree, **spec["opt"], ray_group=group)
        step = loop.make_online_train_step(spec["star_cfg"], spec["loss_cfg"], opt, **step_kw)
        watched = tree_leaves(tree)
    elif kind == "appinit":
        opt = optim.make_appinit_optimizer(tree, **spec["opt"], ray_group=group)
        step = loop.make_appinit_train_step(spec["star_cfg"], spec["loss_cfg"], opt)
        watched = tree_leaves(tree)
    else:
        raise ValueError(f"kind must be online, gauge or appinit, got {kind}")
    gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    draws = spec.get("draws") or [None] * len(spec["batches"])
    out = {"losses": [], "metrics": [], "grads": [], "spread": [], "launches": [],
           "step_ms": []}

    def one_step(batch, draw):
        local = _place_batch(batch, device, group)
        u = {}
        if draw is not None:
            rows = local["rays_o"].shape[0]
            lo = 0 if group is None else group.rank * rows
            u = {k: torch.tensor(v[lo:lo + rows], device=device)
                 for k, v in zip(("u_strat", "u_pdf"), draw)}
        if kind == "gauge":
            loss = step(gauge, tree["nerf"], tree["poses"], local, generator=gen, **u)
            return loss, {"loss": loss}
        if kind == "online":
            return step(tree, local, epoch=spec.get("epoch", 0), generator=gen, **u)
        return step(tree, local, generator=gen, **u)

    for batch, draw in zip(spec["batches"], draws):
        before = _launches()
        t0 = time.perf_counter()
        loss, metrics = one_step(batch, draw)
        if spec.get("time"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        after = _launches()
        out["launches"].append({k: after[k] - before[k] for k in after})
        out["losses"].append(float(loss))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["grads"].append([np.zeros(tuple(p.shape), np.float32) if p.grad is None
                             else p.grad.detach().cpu().numpy() for p in watched])
        out["spread"].append(0.0 if group is None else params_spread(tree, group))
    if spec.get("time") and group is not None:
        # the collectives of one step, alone: the grad vector's all-reduce,
        # the metrics' and one a masked loss's mask count
        g = torch.zeros(opt.m.numel(), device=device)
        small = torch.zeros(len(out["metrics"][-1]), device=device)
        masked = sum(bool(getattr(spec.get("loss_cfg"), k, False))
                     for k in ("use_depth_loss", "use_sigma_loss"))

        def collectives():
            group.all_reduce(g)
            group.all_reduce(small)
            for _ in range(masked):
                group.all_reduce(small[:1].clone())

        out["collective_ms"] = _median_ms(collectives, device)
    out["params"] = tree_map(lambda t: t.detach().cpu().numpy(), tree)
    if kind == "gauge":
        out["params"] = {"gauge": gauge.detach().cpu().numpy(), **out["params"]}
    return out


def run_app(group, app: str, entry: str, argv, device="cpu") -> dict:
    """startrax_torch.apps.<app>.<entry>(load_config(argv), device) on this
    rank (the group's device; with no group the CPU, or the card with
    device="cuda"); returns {"params": the returned tree as numpy, or None,
    "spread": the ranks' parameter spread (0 without a group), "launches":
    the kernel launches of the run}."""
    from ..utils.config import load_config

    fn = getattr(importlib.import_module(f"startrax_torch.apps.{app}"), entry)
    before = _launches()
    out = fn(load_config(list(argv)), device=group.device if group is not None else device)
    after = _launches()
    res = {"params": None, "spread": 0.0, "launches": {k: after[k] - before[k] for k in after}}
    if out is not None:
        res.update(params=tree_map(lambda t: t.detach().cpu().numpy(), out),
                   spread=0.0 if group is None else params_spread(out, group))
    return res


def render(group, params, star_cfg, rays_o, rays_d, pose, tile: int) -> dict:
    """eval.render.render_image of the numpy tree ``params`` (the "nerf"
    fields) at pose [K, 7] (numpy), with the test outputs, its tiles split
    over the group's ranks (group None: one process on the CPU)."""
    from ..eval.render import render_image

    device = group.device if group is not None else torch.device("cpu")
    nerf = convert.params_from_numpy(params, device=device)
    pose = None if pose is None else torch.as_tensor(pose, device=device)
    return render_image(nerf, star_cfg, rays_o, rays_d, pose=pose, tile=tile,
                        with_test_outputs=True, device=device, group=group)


def stall(group, seconds: float, rank: int = 1) -> dict:
    """Rank ``rank`` sleeps ``seconds`` and joins nothing; every other rank
    all-reduces a tensor, which fails once the group's timeout passes.
    Returns whether this rank's collective raised, and after how long."""
    if group.rank == rank:
        time.sleep(seconds)
        return {"raised": None, "after_s": seconds}
    t0 = time.monotonic()
    try:
        group.all_reduce(torch.ones(4, device=group.device))
    except RuntimeError as exc:  # the timeout this function exists to show
        return {"raised": True, "after_s": time.monotonic() - t0, "error": str(exc)[:200]}
    return {"raised": False, "after_s": time.monotonic() - t0}


def run_jobs(group, jobs) -> list:
    """[fn(group, *args) for (fn, args) in jobs], in order, on this rank:
    several runs in one set of ranks (each fn importable by name)."""
    return [fn(group, *args) for fn, args in jobs]
