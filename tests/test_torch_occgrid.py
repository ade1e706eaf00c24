"""The port's occupancy-grid path against startrax's, on the CPU.

- kernels/occgrid: update_grid, occupancy, _lookup and march_and_select
  given JAX's draws (the update's jitter and refresh uniforms and the
  march's jitter, each drawn from a key as startrax draws it): masks,
  selection order and occupied counts exactly, positions and the density
  EMA within 1e-6 (float32 rounding of the same arithmetic).
- models/star_occgrid: render_star_occgrid and joint_density_fn with K = 1
  and 2, with and without a pose, weights from one JAX init (perturbed so
  that every path carries gradient) carried over with convert, float32 on
  both plain paths: outputs within 1e-5 and gradients within 1e-4 of each
  gradient's largest magnitude (measured: 1.2e-6 and 3.6e-6).
- apps/occgrid_init: both apps on one tiny synthetic scene from one field
  init, on the same batches (FullQueuePrefetcher, one scene cache that the
  JAX app writes and the port reads) and the same draws (every grid update
  and march of the port's app fed the uniforms the JAX app draws from its
  one key). Adam amplifies float32 rounding (tests/test_torch_app_init.py),
  so the epochs are held to the measured differences times ten: fine
  losses (measured 5.9e-5 relative) within 6e-4, dropped_frac (measured
  3.0e-8) within 3e-7 absolute, the final density EMA (measured 9.0e-5 of
  its largest value) within 9e-4 of it; mean_samples (measured equal)
  within 1e-6 relative. The budget doubles at the same epoch, and the
  metric keys, steps and checkpoints are equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.apps import occgrid_init as japp
from startrax.kernels import occgrid as jocc
from startrax.models import fields as jfields
from startrax.models import star_occgrid as jso
from startrax.models.star import StarConfig as JStarConfig
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import occgrid_init as tapp
from startrax_torch.kernels import occgrid as tocc
from startrax_torch.models import star_occgrid as tso
from startrax_torch.models.star import StarConfig as TStarConfig
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves
from test_torch_online import _fresh_scene_memo, _one_torch_thread  # noqa: F401
from test_torch_online_gauge import FullQueuePrefetcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR, FAR = 2.0, 8.0
OCC = dict(resolution=8, aabb_min=(-FAR,) * 3, aabb_max=(FAR,) * 3, render_step_size=0.05,
           n_march=48, n_selected=16)


def _occ_cfgs(**kw):
    return jocc.OccGridConfig(**{**OCC, **kw}), tocc.OccGridConfig(**{**OCC, **kw})


def _density(xp):
    """A blob of density around (1, 0, -1), in numpy-like module xp."""
    def fn(pts):
        d2 = ((pts - xp.asarray([1.0, 0.0, -1.0], dtype=pts.dtype)) ** 2).sum(-1)
        return 3.0 * xp.exp(-d2 / 8.0)

    return fn


def _rays(n, seed):
    """Rays from a shell of radius 5 towards points near the origin."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(scale=0.5, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grids(steps, seed=0, **kw):
    """A JAX grid after `steps` updates from _density, and the port's grid
    after the same updates given the same uniforms."""
    jcfg, tcfg = _occ_cfgs(**kw)
    jgrid, tgrid = jocc.init_grid(jcfg), tocc.init_grid(tcfg, "cpu")
    r = jcfg.resolution
    key = jax.random.PRNGKey(seed)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        jgrid = jocc.update_grid(jgrid, _density(jnp), sub, jcfg)
        k1, k2 = jax.random.split(sub)
        tgrid = tocc.update_grid(tgrid, _density(torch), tcfg,
                                 u_jitter=np.array(jax.random.uniform(k1, (r, r, r, 3))),
                                 u_refresh=np.array(jax.random.uniform(k2, (r, r, r))))
    return jcfg, tcfg, jgrid, tgrid


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_update_grid_and_occupancy_match_startrax(steps):
    jcfg, tcfg, jgrid, tgrid = _grids(steps)
    assert tgrid["step"] == int(jgrid["step"]) == steps
    np.testing.assert_allclose(tgrid["density_ema"].numpy(), np.asarray(jgrid["density_ema"]),
                               rtol=1e-6, atol=1e-7)
    occ = tocc.occupancy(tgrid, tcfg)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc.occupancy(jgrid, jcfg)))
    if steps == 0:
        assert bool(occ.all())  # an un-updated grid skips nothing
    else:
        assert 0 < int(occ.sum()) < occ.numel()  # the blob is occupied, the corners are not


def test_update_grid_draws_from_its_generator_and_keeps_no_graph():
    _, tcfg = _occ_cfgs()
    w = torch.ones(3, requires_grad=True)
    grid = tocc.update_grid(tocc.init_grid(tcfg, "cpu"), lambda p: (p * w).sum(-1).exp(), tcfg,
                            generator=torch.Generator().manual_seed(1))
    again = tocc.update_grid(tocc.init_grid(tcfg, "cpu"), lambda p: (p * w).sum(-1).exp(), tcfg,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(grid["density_ema"], again["density_ema"])
    assert not grid["density_ema"].requires_grad
    with pytest.raises(ValueError, match="torch.Generator"):
        tocc.update_grid(grid, _density(torch), tcfg)


def test_lookup_matches_startrax():
    jcfg, tcfg, jgrid, tgrid = _grids(2)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.2 * FAR, 1.2 * FAR, size=(500, 3)).astype(np.float32)
    pts[:8] = [[-FAR] * 3, [FAR] * 3, [FAR - 1e-3] * 3, [0, 0, 0], [-FAR, 0, FAR],
               [2.0, 2.0, 2.0], [-2.0, 4.0, -6.0], [FAR + 1, 0, 0]]  # edges and cell borders
    want = np.asarray(jocc._lookup(jocc.occupancy(jgrid, jcfg), jnp.asarray(pts), jcfg))
    got = tocc._lookup(tocc.occupancy(tgrid, tcfg), torch.tensor(pts), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("jitter", [True, False], ids=["jittered", "fixed"])
@pytest.mark.parametrize("steps", [0, 2])
def test_march_and_select_matches_startrax(jitter, steps):
    jcfg, tcfg, jgrid, tgrid = _grids(steps)
    o, d = _rays(24, seed=steps)
    key = jax.random.PRNGKey(7) if jitter else None
    zj, vj, nj = jocc.march_and_select(jgrid, jcfg, jnp.asarray(o), jnp.asarray(d), NEAR, FAR,
                                       key=key)
    u = np.array(jax.random.uniform(key, (24, jcfg.n_march))) if jitter else None
    zt, vt, nt = tocc.march_and_select(tgrid, tcfg, torch.tensor(o), torch.tensor(d), NEAR, FAR,
                                       u=u)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6, atol=0)
    assert vt.dtype == torch.bool and tuple(zt.shape) == (24, jcfg.n_selected)
    # each ray: its occupied samples first, ascending; the rest at far
    for z, v, n in zip(zt.numpy(), vt.numpy(), nt.numpy()):
        k = min(int(n), jcfg.n_selected)
        assert v[:k].all() and not v[k:].any()
        assert (np.diff(z[:k]) > 0).all() and (z[k:] == FAR).all()
    if steps:
        assert 0 < int(nt.min()) and int(nt.max()) > jcfg.n_selected and int(nt.min()) < 48


def test_march_jitter_may_pass_far_and_masked_alpha_stays_f32():
    _, tcfg = _occ_cfgs(n_march=8, n_selected=8)
    o, d = _rays(4, seed=1)
    grid = tocc.init_grid(tcfg, "cpu")
    z, valid, n = tocc.march_and_select(grid, tcfg, torch.tensor(o), torch.tensor(d), NEAR, FAR,
                                        u=np.full((4, 8), 0.999, np.float32))
    assert float(z[:, -1].min()) > FAR  # kept, as startrax keeps it
    raw = torch.zeros(4, 8)
    masked = tocc.masked_raw_alpha(raw, valid & (torch.arange(8) < 4))
    assert masked.dtype == torch.float32 and float(masked[:, 4:].max()) == -1e9


def _perturbed(tree, seed):
    key = jax.random.PRNGKey(seed)
    return jax.tree.map(lambda x: np.asarray(x + 0.05 * jax.random.normal(key, x.shape)), tree)


def _star_cfgs(K):
    kw = dict(num_vehicles=K, netdepth=2, netwidth=32, multires=4, multires_views=2,
              n_samples=16, n_importance=0, near=NEAR, far=FAR, use_fused=False)
    return (JStarConfig(**kw, compute_dtype=jnp.float32),
            TStarConfig(**kw, compute_dtype=torch.float32))


def _pose(K, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(K, 4)) * [0.2, 0.2, 0.2, 1.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([0.3 * rng.normal(size=(K, 3)), q], -1).astype(np.float32)


def _grad_close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("with_pose", [False, True], ids=["static", "pose"])
@pytest.mark.parametrize("K", [1, 2])
def test_render_star_occgrid_matches_startrax(K, with_pose):
    jcfg, tcfg = _star_cfgs(K)
    tree = _perturbed(jso.init_star_occgrid(jax.random.PRNGKey(K), jcfg), K + 10)
    jocfg, tocfg = _occ_cfgs()
    r = jocfg.resolution
    pose = _pose(K, K) if with_pose else None
    # a grid updated from the model's own joint density
    key = jax.random.PRNGKey(3)
    jparams = jax.tree.map(jnp.asarray, tree)
    jgrid = jax.jit(lambda p, q: jocc.update_grid(jocc.init_grid(jocfg), jso.joint_density_fn(
        p, jcfg, q), key, jocfg))(jparams, None if pose is None else jnp.asarray(pose))
    tparams = convert.params_from_numpy(tree, device="cpu", requires_grad=True)
    tpose = None if pose is None else torch.tensor(pose, requires_grad=True)
    k1, k2 = jax.random.split(key)
    tgrid = tocc.update_grid(tocc.init_grid(tocfg, "cpu"), tso.joint_density_fn(
        tparams, tcfg, tpose), tocfg,
        u_jitter=np.array(jax.random.uniform(k1, (r, r, r, 3))),
        u_refresh=np.array(jax.random.uniform(k2, (r, r, r))))
    np.testing.assert_allclose(tgrid["density_ema"].numpy(), np.asarray(jgrid["density_ema"]),
                               rtol=1e-5, atol=1e-6)
    assert not tgrid["density_ema"].requires_grad

    o, d = _rays(20, seed=K)
    mkey = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(mkey, (20, jocfg.n_march)))
    w = np.random.default_rng(K).normal(size=(20, 3)).astype(np.float32)

    def jloss(params, pose_):
        out = jso.render_star_occgrid(params, jcfg, jgrid, jocfg, jnp.asarray(o), jnp.asarray(d),
                                      pose=pose_, key=mkey, with_test_outputs=True)
        return jnp.sum(out["rgb"] * w), out

    if pose is None:
        (_, jout), jg = jax.jit(jax.value_and_grad(lambda p: jloss(p, None), has_aux=True))(
            jparams)
        jgp = None
    else:
        (_, jout), (jg, jgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            jparams, jnp.asarray(pose))
    tout = tso.render_star_occgrid(tparams, tcfg, tgrid, tocfg, torch.tensor(o), torch.tensor(d),
                                   pose=tpose, u=u, with_test_outputs=True)
    (tout["rgb"] * torch.tensor(w)).sum().backward()

    np.testing.assert_array_equal(tout["valid"].numpy(), np.asarray(jout["valid"]))
    np.testing.assert_array_equal(tout["n_occupied"].numpy(), np.asarray(jout["n_occupied"]))
    keys = ["rgb", "depth", "acc", "weights"] + (
        ["rgb_static", "rgb_dynamic", "dynamic_transmittance", "rgb_dynamic_all"] if with_pose
        else [])
    for k in keys:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    held = ("static", "dynamic") if with_pose else ("static",)
    for name in held:
        for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg[name]),
                                     tree_leaves(tparams[name])):
            _grad_close(got.grad.numpy(), want, 1e-4, name + jax.tree_util.keystr(path))
    if with_pose:
        _grad_close(tpose.grad.numpy(), jgp, 1e-4, "pose")
    else:  # the dynamic fields take no part
        assert all(t.grad is None for t in tree_leaves(tparams["dynamic"]))
        assert not any(np.asarray(g).any() for g in jax.tree.leaves(jg["dynamic"]))


@pytest.mark.parametrize("K", [1, 2])
def test_joint_density_fn_matches_startrax(K):
    jcfg, tcfg = _star_cfgs(K)
    tree = _perturbed(jso.init_star_occgrid(jax.random.PRNGKey(20 + K), jcfg), 30 + K)
    pts = np.random.default_rng(K).uniform(-4, 4, size=(64, 3)).astype(np.float32)
    params = convert.params_from_numpy(tree, device="cpu")
    pose = _pose(K, 40 + K)
    for p in (None, pose):
        want = np.asarray(jax.jit(lambda q, x: jso.joint_density_fn(
            jax.tree.map(jnp.asarray, tree), jcfg, q)(x))(
            None if p is None else jnp.asarray(p), jnp.asarray(pts)))
        got = tso.joint_density_fn(params, tcfg, None if p is None else torch.tensor(p))(
            torch.tensor(pts))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    static = tso.joint_density_fn(params, tcfg)(torch.tensor(pts))
    assert bool((got > static).all())  # the dynamic fields add density


def test_init_star_occgrid_shapes():
    _, tcfg = _star_cfgs(2)
    jcfg, _ = _star_cfgs(2)
    t = tso.init_star_occgrid(tcfg, torch.Generator().manual_seed(0), "cpu")
    j = jso.init_star_occgrid(jax.random.PRNGKey(0), jcfg)
    assert [tuple(a.shape) for a in tree_leaves(t)] == [a.shape for a in jax.tree.leaves(j)]
    # the pair is equal-depth: the dynamic stack has the static field's blocks
    assert len(t["dynamic"]["blocks"]) == len(t["static"]["blocks"]) == 1


APP = dict(
    expname="smoke", dataset_type="synthetic", num_frames=4, num_vehicles=1, near=NEAR, far=FAR,
    scale_factor=-1.0, netdepth=4, netwidth=32, N_samples=64, N_rand=96, steps_per_epoch=12,
    epochs_appearance=3, epoch_ckpt=1, mixed_precision=False, synth_height=24, synth_views=4,
    synth_val_views=2, num_workers=1, grid_resolution=16, render_step_size=0.05,
    appearance_init_thres=1e-9)


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _budget_lines(run_dir):
    with open(os.path.join(run_dir, "run.log")) as f:
        return [line.split(" INFO ", 1)[1].strip() for line in f if "sample budget" in line]


def _feed_draws(monkeypatch, seed):
    """Give the port's app the JAX app's draws: it splits its one key once
    before each grid update (then into the jitter and refresh keys) and once
    before each step (the march's jitter)."""
    state = {"key": jax.random.PRNGKey(seed), "updates": 0}
    update, march = tocc.update_grid, tocc.march_and_select

    def fed_update(grid, density_fn, cfg, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        k1, k2 = jax.random.split(sub)
        r = cfg.resolution
        state["updates"] += 1
        return update(grid, density_fn, cfg,
                      u_jitter=np.array(jax.random.uniform(k1, (r, r, r, 3))),
                      u_refresh=np.array(jax.random.uniform(k2, (r, r, r))))

    def fed_march(grid, cfg, rays_o, rays_d, near, far, generator=None):
        state["key"], sub = jax.random.split(state["key"])
        u = np.array(jax.random.uniform(sub, (rays_o.shape[0], cfg.n_march)))
        return march(grid, cfg, rays_o, rays_d, near, far, u=u)

    monkeypatch.setattr(tocc, "update_grid", fed_update)
    monkeypatch.setattr(tocc, "march_and_select", fed_march)
    return state


def test_occgrid_app_matches_startrax(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    jcfg = jconfig.Config(**APP, basedir=str(tmp_path / "jax"), synth_cache_dir=cache)
    tcfg = tconfig.Config(**APP, basedir=str(tmp_path / "torch"), synth_cache_dir=cache)
    fcfg = jfields.FieldConfig(depth=4, width=32, compute_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jfields.init_field(jax.random.PRNGKey(0), fcfg))
    monkeypatch.setattr(japp, "init_field", lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tapp, "init_field",
                        lambda cfg, gen, dev: convert.params_from_numpy(tree, device=dev))
    for app in (japp, tapp):
        monkeypatch.setattr(app, "BatchPrefetcher", FullQueuePrefetcher)
    fed = _feed_draws(monkeypatch, jcfg.seed)

    jparams, jgrid = japp.train(jcfg)
    tparams, tgrid = tapp.train(tcfg, device="cpu")

    dirs = [str(tmp_path / p / "smoke" / "occgrid_init") for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows] and len(trows) == 3
    assert [r["step"] for r in trows] == [12, 24, 36] == [r["step"] for r in jrows]
    for key, rtol, atol in (("train/fine_loss", 6e-4, 0), ("train/mean_samples", 1e-6, 0),
                            ("train/dropped_frac", 0, 3e-7)):
        np.testing.assert_allclose([r[key] for r in trows], [r[key] for r in jrows], rtol=rtol,
                                   atol=atol, err_msg=key)
    assert trows[-1]["train/fine_loss"] < trows[0]["train/fine_loss"]
    # the budget doubled once, after epoch 0 (32 -> 64 = N_samples)
    assert _budget_lines(dirs[1]) == _budget_lines(dirs[0]) and len(_budget_lines(dirs[1])) == 1
    assert "to 64" in _budget_lines(dirs[1])[0]
    assert trows[0]["train/mean_samples"] <= 32 < trows[1]["train/mean_samples"]
    assert trows[0]["train/dropped_frac"] > 0.01
    # grid updates before steps 0, 16 and 32
    assert fed["updates"] == 3 and tgrid["step"] == int(jgrid["step"]) == 3
    want = np.asarray(jgrid["density_ema"])
    err = float(np.abs(tgrid["density_ema"].numpy() - want).max())
    assert err <= 9e-4 * float(np.abs(want).max()), err
    # a {"params"} checkpoint an epoch, the last holding the returned params
    ckpts = os.path.join(dirs[1], "ckpts")
    assert sorted(os.listdir(ckpts)) == sorted(os.listdir(os.path.join(dirs[0], "ckpts")))
    restored = tckpt.restore_checkpoint(ckpts, device="cpu")
    assert list(restored) == ["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]),
                                                  tree_leaves(tparams)))


def test_occgrid_app_defaults_to_the_card(tmp_path, monkeypatch):
    """Through main's argv parser: without a CUDA device the app raises and
    names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "startrax", "configs", "carla_star_app_init_nerfacc.txt")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapp.main(["--config", config, "--basedir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_occgrid_config_follows_startrax():
    """The AABB [-far, far]^3 in scaled units and the budget
    max(N_samples // 4, 32), from the shipped config."""
    config = os.path.join(ROOT, "startrax", "configs", "carla_star_app_init_nerfacc.txt")
    cfg = tconfig.load_config(["--config", config])
    occ = tapp.occgrid_config(cfg)
    assert occ.aabb_max == pytest.approx((0.8,) * 3) and occ.aabb_min == pytest.approx((-0.8,) * 3)
    assert (occ.resolution, occ.n_march, occ.n_selected, occ.render_step_size) == (
        128, 512, 128, 5e-3)
    small = tapp.occgrid_config(tconfig.Config(N_samples=64))
    assert small.n_selected == 32 and tapp.GRID_UPDATE_EVERY == japp.GRID_UPDATE_EVERY == 16


def test_parity_compare_masked_cotangent_and_plain_slices():
    """parity.compare's two options for the occgrid shapes, on the CPU where
    both of its sides run the plain version: the plain version in row
    slices agrees with one call to float32 summation order (measured: the
    outputs equal, the weight grads 3.1e-7 apart; held to 1e-5), and the cotangent mask zeroes the masked rows'
    cotangent."""
    from startrax_torch.kernels import parity
    from startrax_torch.models import fields as tfields

    cfg = tfields.FieldConfig(depth=2, width=32, multires=4, multires_views=2,
                              compute_dtype=torch.float32)
    params = tfields.init_field(cfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(50, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(50, 3)).astype(np.float32)),
                                      dim=-1)
    mask = torch.tensor((rng.uniform(size=50) < 0.6).astype(np.float32))
    errs, run = parity.compare(params, x, d, cfg.n_blocks, (4, 2), cot_mask=mask)
    assert not run["cot"][mask == 0].any() and run["cot"][mask == 1].abs().min() > 0
    assert errs["w"] == 0 and not parity.failures(errs)
    errs, _ = parity.compare(params, x, d, cfg.n_blocks, (4, 2), cot_mask=mask, plain_rows=16)
    assert errs["fwd"] == 0 and errs["w"] <= 1e-5 and not parity.failures(errs)
    with pytest.raises(ValueError, match="weight grads only"):
        parity.compare(params, x.requires_grad_(True), d, cfg.n_blocks, (4, 2), plain_rows=16)
