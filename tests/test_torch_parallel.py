"""Ray-axis data parallelism in the port (startrax_torch.parallel) on the CPU.

Two gloo ranks in spawned processes (parallel.mesh.run_ranks), one set of
ranks for the steps, renders and apps of this file (one module fixture),
one for the dry run and one for the hang guard. What the ranks run lives in
the port (parallel/dryrun.py), so no rank imports JAX.

The meaning held: an N-rank step is the one-process step on the global
batch, so the 2-rank online step is held against startrax's single-device
step (its draws fed to both from one JAX key a step), in both layouts, with
accumulation 2, the clip, the regularizers, and depth and sigma losses on a
batch whose two halves hold 2 and 7 rays inside [near, far]. Tolerances:
the losses within 1e-4 relative while both sides hold the same parameters
(the first update comes at the second step) and 2e-3 after; the parameters
after 2 updates within 2 x lr x updates (tests/test_torch_train.py's
bounds, for Adam's sign steps). Against the port's one-process step on the
same inputs: losses and metrics within 1e-6 relative, the ranks' summed
grads within 1e-5 of the largest grad (float32 summation order), and the
ranks' parameters equal after every step (spread 0).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from startrax.parallel import mesh as jmesh
from startrax.train import loop as jloop
from startrax.train import optim as joptim
from startrax_torch.apps import common as tcommon
from startrax_torch.models.star import StarConfig
from startrax_torch.parallel import dryrun, mesh
from startrax_torch.train import loop as tloop
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves

N_RAYS = 16
LR = 5e-4
N_STEPS = 4
ACCUMULATE = 2
LOSS = dict(lambda_alpha_entropy=1e-3, lambda_dynamic_vs_static_reg=1e-3, lambda_ray_reg=1e-5,
            lambda_static_reg=1e-3, lambda_dynamic_reg=1e-3, use_depth_loss=True,
            depth_lambda=0.1, use_sigma_loss=True, sigma_lambda=1e-3)
OPT = dict(lrate_static=LR, lrate_dynamic=LR, lrate_pose=LR, steps_per_epoch=100,
           grad_clip=1.0, accumulate_steps=ACCUMULATE)
# the apps: the tiny synthetic scene of the app tests; the online run keeps
# one sampling state (window, ratios) through every phase, so that its one
# prefetch thread delivers the same batches whatever the timing
APP = dict(expname="dp", dataset_type="synthetic", num_frames=6, num_vehicles=2, near=2.0,
           far=8.0, scale_factor=-1.0, netdepth=4, netdepth_fine=4, netwidth=32,
           netwidth_fine=32, N_samples=12, N_importance=12, N_rand=128, mixed_precision=False,
           synth_height=24, synth_views=4, synth_val_views=2, num_workers=1, perturb=1.0)
APP_INIT = dict(APP, num_vehicles=1, steps_per_epoch=10, epochs_appearance=2, epoch_val=1,
                raw_noise_std=0.5, appearance_init_thres=1e-9, car_sample_ratio=0.25)
ONLINE = dict(APP, noisy_pose_init=True, initial_num_frames=6, online_thres=1e9,
              online_thres_tightened=1e9, epochs_between_frames=0, selection="photometric",
              selection_patience=0, epochs_online=7, steps_per_epoch=4, pose_delay_epochs=1,
              end_barf=2, barf_freeze_rot=True, polish_epochs=4, polish_mode="alternate",
              alt_field_epochs=1, alt_pose_epochs=1, ghost_sample_ratio=0.0,
              frame0_sample_ratio=0.0, epoch_val=4, mixed_frames=True, depth_loss=True,
              depth_lambda=0.1, accumulate_grad_batches=2, save_video_frames=True)
# the apps at 2 ranks against 1: measured, app init's rows 1.2e-6 relative
# (density noise on) but its near-zero SSIM 3.1e-6 absolute, and the online
# app's fine losses up to 1.5e-4 relative in its last polish epoch (Adam
# amplifies the grads' summation order); ten times those
APP_RTOL, APP_ATOL, ONLINE_RTOL = 1e-5, 3e-5, 2e-3


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return StarConfig(**dict(kw, compute_dtype=torch.float32))


def _batch(layout, seed=2):
    rng = np.random.default_rng(seed)
    rays_o = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    # [near, far] = [2, 6]: 2 rays of the first half and 7 of the second
    # inside, so the shards' mask counts differ
    depth = np.full(N_RAYS, 7.5, np.float32)
    depth[[1, 5]] = 3.0
    depth[8:15] = rng.uniform(2.5, 5.5, 7)
    frame = np.int32(2) if layout == "shared" else rng.integers(0, 4, N_RAYS).astype(np.int32)
    return {"rays_o": rays_o, "rays_d": rays_d,
            "target": rng.uniform(size=(N_RAYS, 3)).astype(np.float32),
            "target_depth": depth, "frame": frame}


def _uniforms(key, cfg):
    k_strat, k_pdf, _ = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(k_strat, (N_RAYS, cfg.n_samples))),
            np.asarray(jax.random.uniform(k_pdf, (N_RAYS, cfg.n_importance))))


def _online_case(layout):
    """startrax's single-device steps and the replay spec of the same
    weights, batch and draws."""
    jcfg = _flagship_cfg(tiny=True)
    jparams = jloop.init_online_params(jax.random.PRNGKey(0), jcfg, num_frames=4)
    poses = np.asarray(jparams["poses"]).copy()
    poses[..., :3] = 0.05 * np.random.default_rng(1).normal(size=poses[..., :3].shape)
    jparams["poses"] = jnp.asarray(poses)
    params = jax.tree.map(np.asarray, jparams)
    batch = _batch(layout)
    jtx = joptim.make_fused_star_optimizer(jparams, **OPT)
    jstate = jtx.init(jparams)
    jstep = jloop.make_online_train_step(jcfg, jloop.LossConfig(**LOSS), jtx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key, losses, draws = jax.random.PRNGKey(3), [], []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        draws.append(_uniforms(sub, jcfg))
        jparams, jstate, jl, _ = jstep(jparams, jstate, jbatch, sub, jnp.asarray(0))
        losses.append(float(jl))
    spec = {"kind": "online", "star_cfg": _tcfg(jcfg), "loss_cfg": tloop.LossConfig(**LOSS),
            "params": params, "opt": OPT, "batches": [batch] * N_STEPS, "draws": draws}
    return spec, losses, jax.tree.map(np.asarray, jparams)


def _gauge_spec():
    cfg = _tcfg(_flagship_cfg(tiny=True))
    gen = torch.Generator().manual_seed(4)
    params = tloop.init_online_params(cfg, 4, gen, "cpu")
    with torch.no_grad():
        params["poses"][..., :3] += 0.05 * torch.randn(params["poses"][..., :3].shape,
                                                       generator=gen)
    rng = np.random.default_rng(5)
    draws = [(rng.uniform(size=(N_RAYS, cfg.n_samples)).astype(np.float32),
              rng.uniform(size=(N_RAYS, cfg.n_importance)).astype(np.float32))
             for _ in range(3)]
    return {"kind": "gauge", "star_cfg": cfg, "params": tree_map_np(params),
            "opt": {"lrate": 1e-2}, "step_kw": {"freeze_rot": True, "depth_lambda": 2.0},
            "batches": [_batch("per_ray", seed=6)] * 3, "draws": draws}


def _appinit_spec():
    """App-init steps with density noise and jitter drawn from the
    generator: the ranks' draws are the one-process step's only if each is
    made at the whole batch's shape."""
    cfg = dataclasses.replace(_tcfg(_flagship_cfg(tiny=True)), raw_noise_std=1.0)
    from startrax_torch.models.star import init_star

    params = init_star(cfg, torch.Generator().manual_seed(7), "cpu")
    return {"kind": "appinit", "star_cfg": cfg,
            "loss_cfg": tloop.LossConfig(use_depth_loss=True, depth_lambda=0.1),
            "params": tree_map_np(params), "opt": {"lrate": LR}, "seed": 8,
            "batches": [_batch("shared", seed=s) for s in (9, 10, 11)]}


def tree_map_np(tree):
    from startrax_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().numpy(), tree)


def _argv(cfg):
    return [a for k, v in cfg.items() for a in (f"--{k}", str(v))]


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything this file holds: the references (startrax's steps, the
    port's one-process steps and apps) and one set of 2 gloo ranks running
    the same steps, renders and apps."""
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("dp")
    cache = str(base / "cache")
    specs, ref = {}, {}
    for layout in ("shared", "per_ray"):
        specs[layout], ref[f"jax_{layout}"], ref[f"jax_params_{layout}"] = _online_case(layout)
    specs["gauge"], specs["appinit"] = _gauge_spec(), _appinit_spec()
    for name, spec in specs.items():
        ref[name] = dryrun.replay(None, spec)
    cfg = _tcfg(_flagship_cfg(tiny=True))
    render_args = (specs["shared"]["params"]["nerf"], cfg,
                   *(np.random.default_rng(12).normal(size=(5, 7, 3)).astype(np.float32)
                     for _ in range(2)),
                   np.asarray(tloop.gather_frame_pose(torch.tensor(
                       specs["shared"]["params"]["poses"]), 2, 2)), 16)
    ref["render"] = dryrun.render(None, *render_args)
    one, two = str(base / "one"), str(base / "two")
    app_init = dict(APP_INIT, synth_cache_dir=cache)
    online = dict(ONLINE, synth_cache_dir=cache)
    ckpts = os.path.join(one, "dp", "online", "ckpts")
    ref["app_init"] = dryrun.run_app(None, "app_init", "train",
                                     _argv(dict(app_init, basedir=one, data_parallel="off")))
    ref["online"] = dryrun.run_app(None, "online", "train",
                                   _argv(dict(online, basedir=one, data_parallel="off")))
    dryrun.run_app(None, "online", "test",
                   _argv(dict(online, basedir=one, data_parallel="off", online_ckpt_path=ckpts)))
    jobs = [(dryrun.replay, (spec,)) for spec in specs.values()]
    jobs += [(dryrun.render, render_args),
             (dryrun.run_app, ("app_init", "train",
                               _argv(dict(app_init, basedir=two, data_parallel="on")))),
             (dryrun.run_app, ("online", "train",
                               _argv(dict(online, basedir=two, data_parallel="on")))),
             (dryrun.run_app, ("online", "test",
                               _argv(dict(online, basedir=two, data_parallel="auto",
                                          online_ckpt_path=ckpts))))]
    ranks = mesh.run_ranks(dryrun.run_jobs, 2, "gloo", args=(jobs,), device="cpu",
                           timeout=120.0, join_timeout=300.0)
    names = list(specs) + ["render", "app_init", "online", "online_test"]
    got = {name: [r[i] for r in ranks] for i, name in enumerate(names)}
    return {"ref": ref, "got": got, "one": one, "two": two}


def test_ray_sharded_keys_match_startrax():
    assert mesh.RAY_SHARDED_KEYS == jmesh.RAY_SHARDED_KEYS
    assert mesh.RAY_AXIS == jmesh.RAY_AXIS


@pytest.mark.parametrize("n_rays", [1, 7, 8, 1000, 1001, 4096])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_pad_rays_to_multiple_matches_startrax(n_rays, n_devices):
    for tile in (1, 8, 16):
        assert (mesh.pad_rays_to_multiple(n_rays, n_devices, tile)
                == jmesh.pad_rays_to_multiple(n_rays, n_devices, tile))


def _group(rank, world=8):
    return mesh.RayGroup(rank=rank, world=world, device=torch.device("cpu"), backend="gloo")


def test_shard_batch_layout():
    """tests/test_parallel.py's layout: ray keys give each rank its
    contiguous rows, a scalar frame stays whole; the ranks' parts put back
    together are the batch."""
    batch = _batch("shared")
    batch["rays_o"] = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    batch = {k: batch[k] for k in ("rays_o", "frame")}
    parts = [mesh.shard_batch(batch, _group(r)) for r in range(8)]
    assert all(p["rays_o"].shape == (8, 3) and p["frame"] == 2 for p in parts)
    np.testing.assert_array_equal(np.concatenate([p["rays_o"] for p in parts]), batch["rays_o"])
    t = mesh.shard_batch({"rays_d": torch.ones(64, 3)}, _group(3))["rays_d"]
    assert isinstance(t, torch.Tensor) and t.shape == (8, 3)


def test_shard_batch_is_explicit_per_key():
    """Sharding is by key, not shape (tests/test_parallel.py): an aux table
    whose leading dim equals the world size stays whole, per-ray frames are
    sharded, a ray key that does not divide raises, extra_ray_keys extends
    the registry."""
    b = {"rays_o": np.ones((64, 3), np.float32), "poses": np.ones((8, 7), np.float32),
         "aux_table": np.ones((16, 3), np.float32), "frame": np.zeros(64, np.int32)}
    out = mesh.shard_batch(b, _group(1))
    assert out["poses"].shape == (8, 7) and out["aux_table"].shape == (16, 3)
    assert out["frame"].shape == (8,)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch({"rays_o": np.ones((63, 3), np.float32)}, _group(0))
    out = mesh.shard_batch({"my_weights": np.ones(64, np.float32)}, _group(0),
                           extra_ray_keys=("my_weights",))
    assert out["my_weights"].shape == (8,)


@pytest.mark.parametrize("layout", ["shared", "per_ray"])
def test_online_step_over_ranks_matches_startrax(runs, layout):
    got, jl = runs["got"][layout], runs["ref"][f"jax_{layout}"]
    for rank in got:
        for i, (a, b) in enumerate(zip(rank["losses"], jl)):
            np.testing.assert_allclose(a, b, rtol=1e-4 if i < ACCUMULATE else 2e-3)
        for a, b in zip(tree_leaves(rank["params"]),
                        jax.tree.leaves(runs["ref"][f"jax_params_{layout}"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * N_STEPS / ACCUMULATE)


@pytest.mark.parametrize("case", ["shared", "per_ray", "gauge", "appinit"])
def test_steps_over_ranks_match_the_one_process_step(runs, case):
    """The same steps, weights, batches and draws in one process. While both
    sides hold the same parameters (before the first update) the 2-rank
    losses and metrics are within 1e-6 relative and the grads summed over
    the ranks within 1e-5 of the largest grad; after it, losses and metrics
    within 1e-4 (Adam's sign steps). The ranks' parameters are equal after
    every step: the tree is carried onto rank 0 (convert.params_from_numpy)
    and broadcast by replicate_params to the other ranks, which start from
    zeros."""
    ref, got = runs["ref"][case], runs["got"][case]
    before_update = ACCUMULATE if case in ("shared", "per_ray") else 1
    for rank in got:
        for step, (m, r) in enumerate(zip(rank["metrics"], ref["metrics"])):
            rtol = 1e-6 if step < before_update else 1e-4
            np.testing.assert_allclose(rank["losses"][step], ref["losses"][step], rtol=rtol)
            assert m.keys() == r.keys()
            np.testing.assert_allclose([m[k] for k in r], list(r.values()), rtol=rtol, atol=1e-9)
        assert rank["spread"] == [0.0] * len(ref["losses"])
        for a, b in zip(tree_leaves(rank["params"]), tree_leaves(got[0]["params"])):
            np.testing.assert_array_equal(a, b)
    for step, one in enumerate(ref["grads"][:before_update]):
        summed = [sum(rank["grads"][step][i] for rank in got) for i in range(len(one))]
        scale = max(float(np.abs(g).max()) for g in one)
        assert scale > 0
        err = max(float(np.abs(a - b).max()) for a, b in zip(summed, one))
        assert err <= 1e-5 * scale, (step, err, scale)


class _TwoShards:
    """A ray group of 2 ranks seen from one of them: its all-reduce adds
    the other shard's value."""

    world = 2

    def __init__(self, other):
        self.other = other

    def all_reduce(self, t):
        return t.add_(self.other)


def test_masked_losses_divide_by_the_global_mask_count(runs):
    """With 2 and 7 rays inside [near, far] in the halves, each half's
    depth and sigma loss divides by the whole batch's count (9), so the
    shares sum to the one-process loss; a mean of the halves' own means
    (a DDP-style average) reads otherwise. In the steps above the ranks'
    depth and sigma metrics equal the one-process ones."""
    from startrax_torch.ops import losses

    b = _batch("shared")
    gt = torch.tensor(b["target_depth"])
    depth = torch.tensor(np.random.default_rng(13).uniform(2.0, 6.0, N_RAYS).astype(np.float32))
    inside = ((gt > 2.0) & (gt < 6.0)).float()
    counts = [inside[:8].sum(), inside[8:].sum()]
    assert [float(c) for c in counts] == [2.0, 7.0]
    halves = [losses.depth_loss(depth[s], gt[s], 2.0, 6.0, group=_TwoShards(counts[1 - i]))
              for i, s in enumerate((slice(0, 8), slice(8, 16)))]
    whole = losses.depth_loss(depth, gt, 2.0, 6.0)
    torch.testing.assert_close(halves[0] + halves[1], whole, rtol=1e-6, atol=0)
    own = [losses.depth_loss(depth[s], gt[s], 2.0, 6.0) for s in (slice(0, 8), slice(8, 16))]
    assert abs(float(0.5 * (own[0] + own[1]) - whole)) > 1e-2 * float(whole)
    for case in ("shared", "per_ray"):
        for rank in runs["got"][case]:
            for m, r in zip(rank["metrics"], runs["ref"][case]["metrics"]):
                np.testing.assert_allclose([m["depth_loss"], m["sigma_loss"]],
                                           [r["depth_loss"], r["sigma_loss"]], rtol=1e-6)


def test_sharded_eval_render_equals_the_unsharded_render(runs):
    """35 rays in tiles of 16: two even tiles and a tile of 3 rays, its last
    ray repeated to 4 for the 2 ranks; every rank returns the whole image,
    within 1e-6 of the one-process render."""
    ref = runs["ref"]["render"]
    for rank in runs["got"]["render"]:
        assert rank.keys() == ref.keys() and ref["rgb"].shape == (5, 7, 3)
        for k in ref:
            np.testing.assert_allclose(rank[k], ref[k], rtol=0, atol=1e-6)


def test_app_init_app_over_ranks_against_one_rank(runs):
    """Density noise and jitter on: rank 0's metrics.jsonl against the
    one-process app's within APP_RTOL; one run directory and one set of
    checkpoints, written by rank 0; the ranks' final trees equal."""
    one = _rows(os.path.join(runs["one"], "dp", "app_init"))
    two = _rows(os.path.join(runs["two"], "dp", "app_init"))
    assert [r.keys() for r in one] == [r.keys() for r in two]
    for a, b in zip(one, two):
        for k, v in a.items():
            np.testing.assert_allclose(b[k], v, rtol=APP_RTOL, atol=APP_ATOL)
    assert sorted(os.listdir(os.path.join(runs["two"], "dp"))) == ["app_init", "online",
                                                                   "online_test"]
    assert sorted(os.listdir(os.path.join(runs["two"], "dp", "app_init", "ckpts"))) == [
        "0", "1", "2"]
    got = runs["got"]["app_init"]
    assert [r["spread"] for r in got] == [0.0, 0.0]
    for a, b in zip(tree_leaves(got[0]["params"]), tree_leaves(got[1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_online_app_over_ranks_against_one_rank(runs):
    """Per-ray batches, depth loss, accumulation 2, the phase machine
    (fieldform, BARF, the curriculum, the alternate polish with selection
    and checkpoints): the phases equal, the fine losses and selection
    scores within ONLINE_RTOL, the ranks' parameters equal."""
    hist = [json.load(open(os.path.join(d, "dp", "online", "history.json")))
            for d in (runs["one"], runs["two"])]
    assert [h["phase"] for h in hist[0]] == [h["phase"] for h in hist[1]]
    assert {"fieldform", "barf", "polish_field", "polish_pose"} <= {h["phase"] for h in hist[0]}
    for a, b in zip(*hist):
        np.testing.assert_allclose(b["fine"], a["fine"], rtol=ONLINE_RTOL)
        if "score" in a:
            np.testing.assert_allclose(b["score"], a["score"], rtol=ONLINE_RTOL)
    assert [r["spread"] for r in runs["got"]["online"]] == [0.0, 0.0]
    assert (sorted(os.listdir(os.path.join(runs["two"], "dp", "online")))
            == sorted(os.listdir(os.path.join(runs["one"], "dp", "online"))))


def test_online_test_rows_over_ranks_equal_one_rank(runs):
    """test() on one checkpoint, its eval tiles split over 2 ranks: every
    test row within 1e-6 of the one-process rows, the pose files and the
    per-view GIFs written once."""
    one = _rows(os.path.join(runs["one"], "dp", "online_test"))
    two = _rows(os.path.join(runs["two"], "dp", "online_test"))
    assert len(one) == len(two) > 0
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k, v in a.items():
            np.testing.assert_allclose(b[k], v, rtol=1e-6, atol=1e-6)
    files = sorted(os.listdir(os.path.join(runs["two"], "dp", "online_test")))
    assert {"view0.gif", "view1.gif", "poses_vehicle0.txt", "poses_vehicle1.txt"} <= set(files)
    assert files == sorted(os.listdir(os.path.join(runs["one"], "dp", "online_test")))


def test_dryrun_multichip_two_ranks(capsys):
    out = dryrun.dryrun_multichip(2)
    assert len(out) == 2 and np.isfinite(out[0]["loss"])
    assert "dryrun_multichip OK: 2 ranks" in capsys.readouterr().out


def test_a_hung_collective_fails_by_the_timeout():
    """Rank 1 joins nothing for 4 s; rank 0's all-reduce raises after the
    group's 1.5 s timeout, not when rank 1 comes back."""
    out = mesh.run_ranks(dryrun.stall, 2, "gloo", args=(4.0,), device="cpu", timeout=1.5,
                         join_timeout=60.0)
    assert out[0]["raised"] is True and 1.0 < out[0]["after_s"] < 3.5, out[0]


def test_a_failing_rank_raises_in_the_caller():
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
        mesh.run_ranks(dryrun.replay, 2, "gloo", args=({"kind": "sideways", "params": {},
                                                        "batches": []},), device="cpu",
                       timeout=30.0)


@pytest.mark.parametrize("setting, world, expect", [
    ("off", 1, None), ("auto", 1, None), ("off", 2, None), ("on", 1, RuntimeError),
    ("sideways", 1, ValueError), ("sideways", 2, ValueError)])
def test_make_run_mesh_rule(setting, world, expect, monkeypatch):
    """startrax's rule: off, or auto on one rank, runs one process; on with
    one rank raises startrax's RuntimeError; another value ValueError. The
    world size is the launcher's WORLD_SIZE where no process group exists."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    cfg = tconfig.Config(data_parallel=setting)
    if expect is None:
        assert tcommon.make_run_mesh(cfg, "cpu") is None
    else:
        with pytest.raises(expect, match="only one device is visible" if expect is RuntimeError
                           else "auto/on/off"):
            tcommon.make_run_mesh(cfg, "cpu")


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """nccl takes a card a rank: a node with fewer cards than local ranks
    raises before it makes a process group (no fallback to gloo)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="nccl needs a card a rank"):
        mesh.init_ray_group("nccl", rank=0, world=2, init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()
