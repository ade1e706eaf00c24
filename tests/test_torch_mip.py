"""The port's mip variant (models/mip.py, the IPE, render_image_mip and
apps/mip.py) against startrax's, on the CPU.

Weights come from startrax's own init (init_star_mip, perturbed so that
every bias carries a value and every path a gradient) and reach the port
through startrax_torch.convert; inputs are numpy arrays from a seed; the
renders' bin jitter and PDF uniforms are the ones startrax draws from its
key, fed to the port. Tolerances, each tied to a reading on this box:

- IPE and the frustum Gaussian, float32: within 1e-6 absolute (measured
  equal frustums and 6.0e-8 in the encodings).
- apply_mip_field in float32: outputs and gradients within 1e-5 of each
  one's largest magnitude (measured 1.6e-7 and 2.9e-7). In bf16 both round
  the matmul operands to bf16 and accumulate in f32 in another order, and
  their backward rounds at other places (the port rounds the cotangent,
  XLA the product), so a relu input or an operand near a bf16 rounding
  boundary may go the other way: outputs within 1e-2 (measured 7.8e-8)
  and gradients within 3e-2 (measured 4.4e-3) of the largest magnitude.
- Composites: outputs and gradients within 1e-5 of the largest magnitude
  (measured 1.9e-7 and 3.6e-7).
- render_star_mip in float32: outputs and gradients within 1e-4 of the
  largest magnitude (measured 2.2e-6 and 6.0e-6; the fine bins inherit
  the coarse weights' float32 differences through the CDF inverse);
  render_image_mip's maps within 1e-4 (measured 1.8e-5).
- The apps on one tiny synthetic scene (one scene cache that the first JAX
  app writes and the rest read, the same batches through
  FullQueuePrefetcher, the same init, the same draws, float32): Adam
  amplifies float32 rounding (tests/test_torch_app_init.py), so the rows
  are held to about ten times the measured differences: app init's fine
  losses (measured 2.7e-6 relative) within 3e-5; online's fine losses
  (measured 8.3e-7) within 1e-5, pose errors (measured 1.5e-8) within 2e-7
  absolute, val PSNR (measured 9.5e-7 dB) within 1e-5 and SSIM (measured
  7.7e-7) within 8e-6; the test protocol's rows from one checkpoint within
  2e-5 relative plus 6e-5 absolute (measured PSNR 2.1e-6 relative, SSIM
  5.9e-6 absolute). The keys, steps, checkpoints and pose files are the
  same.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.apps import mip as japp
from startrax.eval import render as jrender
from startrax.models import mip as jmip
from startrax.ops import encoding as jenc
from startrax.train import checkpoint as jckpt
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import mip as tapp
from startrax_torch.eval import render as trender
from startrax_torch.models import mip as tmip
from startrax_torch.ops import encoding as tenc
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves
from test_torch_online import _fresh_scene_memo, _one_torch_thread  # noqa: F401
from test_torch_online_gauge import FullQueuePrefetcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR, FAR = 2.0, 8.0


def _cfgs(dtype="f32", **kw):
    base = dict(num_vehicles=2, depth=4, width=32, num_freqs_pos=8, num_freqs_dir=2,
                n_samples=8, n_importance=8, near=NEAR, far=FAR, base_radius=0.01)
    base.update(kw)
    return (jmip.MipConfig(**base, compute_dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16),
            tmip.MipConfig(**base, compute_dtype=torch.float32 if dtype == "f32"
                           else torch.bfloat16))


def _tree(jcfg, seed):
    """startrax's init_star_mip (jitted: eagerly it takes seconds), each leaf
    perturbed by numpy normals, as a numpy tree."""
    params = jax.jit(lambda key: jmip.init_star_mip(key, jcfg))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32), params)


def _rays(n, seed):
    """Rays from a shell of radius 5 towards points near the origin."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(scale=0.5, size=(n, 3)) - o
    return o.astype(np.float32), d.astype(np.float32)


def _pose(K, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(K, 4)) * [0.1, 0.1, 0.1, 1.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([0.2 * rng.normal(size=(K, 3)), q], -1).astype(np.float32)


def _scaled_close(t_leaves, j_leaves, tol, what=""):
    assert len(t_leaves) == len(j_leaves), what
    for i, (a, b) in enumerate(zip(t_leaves, j_leaves)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        scale = np.abs(b).max() + 1e-12
        err = np.abs(a - b).max() / scale
        assert err <= tol, (what, i, err)


def test_ipe_and_frustum_gaussian_match_startrax():
    rng = np.random.default_rng(0)
    o, d = _rays(6, 0)
    edges = np.sort(rng.uniform(NEAR, FAR, (6, 9)), -1).astype(np.float32)
    t0, t1 = edges[:, :-1], edges[:, 1:]
    jm, jc = jenc.conical_frustum_to_gaussian(o[:, None], d[:, None], t0, t1, 0.01)
    tm, tc = tenc.conical_frustum_to_gaussian(torch.tensor(o)[:, None], torch.tensor(d)[:, None],
                                              torch.tensor(t0), torch.tensor(t1), 0.01)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    for freqs, min_deg in ((24, 0), (4, 2)):
        je = jenc.integrated_positional_encoding(jm, jc, freqs, min_deg)
        te = tenc.integrated_positional_encoding(tm, tc, freqs, min_deg)
        assert te.shape == (6, 8, 6 * freqs)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-6)


def _field_inputs(seed, R=6, S=8):
    o, d = _rays(R, seed)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    edges = np.sort(np.random.default_rng(seed).uniform(NEAR, FAR, (R, S + 1)), -1)
    mean, cov = jenc.conical_frustum_to_gaussian(o[:, None], v[:, None], edges[:, :-1],
                                                 edges[:, 1:], 0.01)
    return np.asarray(mean, np.float32), np.asarray(cov, np.float32), v.astype(np.float32)


@pytest.mark.parametrize("dtype,fwd_tol,grad_tol", [("f32", 1e-5, 1e-5), ("bf16", 1e-2, 3e-2)])
def test_apply_mip_field_matches_startrax(dtype, fwd_tol, grad_tol):
    jcfg, tcfg = _cfgs(dtype)
    tree = _tree(jcfg, 1)["static"]
    mean, cov, v = _field_inputs(1)

    def jloss(p, m):
        dens, rgb = jmip.apply_mip_field(p, jcfg, m, jnp.asarray(cov), jnp.asarray(v))
        return jnp.sum(jnp.sin(dens)) + jnp.sum(rgb ** 2), (dens, rgb)

    (_, (jd, jr)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(mean))
    tp = convert.params_from_numpy(tree, device="cpu", requires_grad=True)
    tm = torch.tensor(mean, requires_grad=True)
    td, tr = tmip.apply_mip_field(tp, tcfg, tm, torch.tensor(cov), torch.tensor(v))
    assert td.shape == (6, 8) and tr.shape == (6, 8, 3)
    _scaled_close([td, tr], [jd, jr], fwd_tol, "forward")
    grads = torch.autograd.grad(torch.sum(torch.sin(td)) + torch.sum(tr ** 2),
                                tree_leaves(tp) + [tm])
    _scaled_close(grads, jax.tree.leaves(jg[0]) + [jg[1]], grad_tol, "grads")


@pytest.mark.parametrize("star", [False, True], ids=["static", "star"])
def test_mip_composites_match_startrax(star):
    rng = np.random.default_rng(2)
    R, K, S = 5, 2, 7
    bins = np.sort(rng.uniform(NEAR, FAR, (R, S + 1)), -1).astype(np.float32)
    z_mids = 0.5 * (bins[:, 1:] + bins[:, :-1])
    ins = [rng.uniform(0, 2, (R, S)), rng.uniform(0, 1, (R, S, 3))]
    if star:
        ins += [rng.uniform(0, 2, (R, K, S)), rng.uniform(0, 1, (R, K, S, 3))]
    ins = [a.astype(np.float32) for a in ins]

    def jfn(*xs):
        if star:
            return jmip.mip_composite_star(*xs, jnp.asarray(bins), jnp.asarray(z_mids),
                                           with_test_outputs=True)
        return jmip.mip_composite(*xs, jnp.asarray(bins), jnp.asarray(z_mids))

    jout = jax.jit(jfn)(*map(jnp.asarray, ins))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    tfn = tmip.mip_composite_star if star else tmip.mip_composite
    kw = {"with_test_outputs": True} if star else {}
    tout = tfn(*tins, torch.tensor(bins), torch.tensor(z_mids), **kw)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        _scaled_close([tout[k]], [jout[k]], 1e-5, k)

    def jloss(*xs):
        out = jfn(*xs)
        return sum(jnp.sum(jnp.sin(v)) for v in out.values())

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(len(ins)))))(*map(jnp.asarray, ins))
    tg = torch.autograd.grad(sum(torch.sum(torch.sin(v)) for v in tout.values()), tins)
    _scaled_close(tg, jg, 1e-5, "grads")


def _jax_draws(key, R, mcfg):
    """The uniforms startrax's render_star_mip draws from its key."""
    k_uni, k_pdf = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k_uni, (R, mcfg.n_samples + 1)))),
            torch.tensor(np.asarray(jax.random.uniform(k_pdf, (R, mcfg.n_importance + 1)))))


@pytest.mark.parametrize("with_pose", [False, True], ids=["appinit", "online"])
def test_render_star_mip_matches_startrax(with_pose):
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg, 3)
    o, d = _rays(10, 3)
    pose = _pose(2, 3) if with_pose else None
    key = jax.random.PRNGKey(7)

    def jloss(p, ps):
        out = jmip.render_star_mip(p, jcfg, jnp.asarray(o), jnp.asarray(d), key=key, pose=ps,
                                   train=True)
        return jnp.sum(out["rgb"] ** 2) + jnp.sum(out["rgb0"] ** 2) + jnp.sum(out["depth"]), out

    args = (jax.tree.map(jnp.asarray, tree), None if pose is None else jnp.asarray(pose))
    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1) if with_pose else 0,
                                               has_aux=True))(*args)
    tp = convert.params_from_numpy(tree, device="cpu", requires_grad=True)
    tpose = None if pose is None else torch.tensor(pose, requires_grad=True)
    u_uni, u_pdf = _jax_draws(key, 10, jcfg)
    tout = tmip.render_star_mip(tp, tcfg, torch.tensor(o), torch.tensor(d), pose=tpose,
                                train=True, u_uni=u_uni, u_pdf=u_pdf)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        _scaled_close([tout[k]], [jout[k]], 1e-4, k)
    loss = torch.sum(tout["rgb"] ** 2) + torch.sum(tout["rgb0"] ** 2) + torch.sum(tout["depth"])
    leaves = tree_leaves(tp) + ([tpose] if with_pose else [])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree.leaves(jg[0]) + [jg[1]] if with_pose else jax.tree.leaves(jg)
    if not with_pose:  # the dynamic fields take no part in app init
        n_static = len(tree_leaves(tp["dynamic"]))
        grads, want = grads[n_static:], want[n_static:]
    _scaled_close(grads, want, 1e-4, "grads")


def test_render_star_mip_draws_from_its_generator():
    """Without uniforms, training draws them from the generator (the same
    seed gives the same render); eval is deterministic and keeps no graph."""
    _, tcfg = _cfgs()
    tp = convert.params_from_numpy(_tree(_cfgs()[0], 4), device="cpu", requires_grad=True)
    o, d = map(torch.tensor, _rays(4, 4))
    a, b = (tmip.render_star_mip(tp, tcfg, o, d, generator=torch.Generator().manual_seed(2))
            for _ in range(2))
    assert torch.equal(a["rgb"], b["rgb"])
    with torch.no_grad():
        e = tmip.render_star_mip(tp, tcfg, o, d, train=False)
    assert not torch.equal(a["rgb"], e["rgb"]) and not e["rgb"].requires_grad


@pytest.mark.parametrize("with_pose", [False, True], ids=["appinit", "online"])
def test_render_image_mip_matches_startrax(with_pose):
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg, 5)
    o, d = _rays(30, 5)
    o, d = o.reshape(5, 6, 3), d.reshape(5, 6, 3)
    pose = _pose(2, 5) if with_pose else None
    jout = jrender.render_image_mip(jax.tree.map(jnp.asarray, tree), jcfg, o, d, pose=pose,
                                    tile=8, with_test_outputs=with_pose)
    tout = trender.render_image_mip(convert.params_from_numpy(tree, device="cpu"), tcfg, o, d,
                                    pose=None if pose is None else torch.tensor(pose), tile=8,
                                    with_test_outputs=with_pose, device="cpu")
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].shape == jout[k].shape, k
        _scaled_close([tout[k]], [jout[k]], 1e-4, k)


def test_mip_params_convert_from_startrax():
    """convert carries startrax's init_star_mip tree, the layers list and
    the stacked dynamic fields, leaf for leaf; the port's own init has the
    same structure and shapes."""
    jcfg, tcfg = _cfgs(num_vehicles=3)
    tree = jax.tree.map(np.asarray, jax.jit(lambda key: jmip.init_star_mip(key, jcfg))(
        jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(tree, device="cpu")
    assert isinstance(params["static"]["layers"], list) and len(params["static"]["layers"]) == 4
    assert params["dynamic"]["layers"][2]["w"].shape == (3, 32 + 48, 32)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    own = tmip.init_star_mip(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(convert.params_to_numpy(own)) == jax.tree.structure(tree)
    assert [tuple(t.shape) for t in tree_leaves(own)] == [b.shape for b in jax.tree.leaves(tree)]


APP = dict(expname="smoke", dataset_type="synthetic", num_frames=4, num_vehicles=2, near=NEAR,
           far=FAR, scale_factor=-1.0, netdepth=2, netwidth=16, N_samples=8, N_importance=8,
           N_rand=64, mixed_precision=False, synth_height=24, synth_views=4, synth_val_views=2,
           num_workers=1, num_freqs_pos=6, num_freqs_dir=2, mip_base_radius=0.01,
           steps_per_epoch=6, epoch_ckpt=1)
ONLINE = dict(epochs_online=4, initial_num_frames=2, online_thres=1e9, online_thres_tightened=1e9,
              epochs_between_frames=0, noisy_pose_init=True, accumulate_grad_batches=2,
              epoch_val=2, lambda_alpha_entropy=1e-3, lambda_dynamic_vs_static_reg=1e-3,
              lambda_ray_reg=1e-5, lambda_static_reg=1e-4, lambda_dynamic_reg=1e-4)


@pytest.fixture(scope="module")
def scene_cache(tmp_path_factory):
    """One scene cache for the app tests: the first JAX app writes the scene,
    every later app of either package reads it."""
    return str(tmp_path_factory.mktemp("mip_scene"))


def _app_cfgs(tmp_path, cache, **kw):
    return tuple(mod.Config(**{**APP, **kw}, basedir=str(tmp_path / name), synth_cache_dir=cache)
                 for mod, name in ((jconfig, "jax"), (tconfig, "torch")))


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def _shared_app(monkeypatch, jcfg, seed=0):
    """One init tree for both apps, one prefetch order, and the port's steps
    fed the draws the JAX app's steps make: it splits its one key once a
    step (key, sub = split(key)), the render splits sub into the bins' and
    the PDF's keys."""
    tree = _tree(japp.mip_config_from(jcfg), seed)
    monkeypatch.setattr(jmip, "init_star_mip", lambda key, cfg: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(tmip, "init_star_mip",
                        lambda cfg, gen, dev: convert.params_from_numpy(tree, device=dev))
    for app in (japp, tapp):
        monkeypatch.setattr(app, "BatchPrefetcher", FullQueuePrefetcher)
    make = tapp.make_train_step
    state = {"key": jax.random.PRNGKey(jcfg.seed), "steps": 0}

    def patched(mcfg, loss_cfg, opt, online):
        step = make(mcfg, loss_cfg, opt, online)

        def fed(params, batch, generator=None):
            state["key"], sub = jax.random.split(state["key"])
            state["steps"] += 1
            u_uni, u_pdf = _jax_draws(sub, batch["rays_o"].shape[0], mcfg)
            return step(params, batch, u_uni=u_uni, u_pdf=u_pdf)

        return fed

    monkeypatch.setattr(tapp, "make_train_step", patched)
    return tree, state


def test_mip_app_init_matches_startrax(tmp_path, monkeypatch, scene_cache):
    jcfg, tcfg = _app_cfgs(tmp_path, scene_cache, epochs_appearance=2,
                           appearance_init_thres=1e-9, lrate=5e-3)
    _, state = _shared_app(monkeypatch, jcfg)
    jparams = japp.train_app_init(jcfg)
    tparams = tapp.train_app_init(tcfg, device="cpu")
    dirs = [str(tmp_path / p / "smoke" / "mip_app_init") for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows] and len(trows) == 2
    assert [r["step"] for r in trows] == [6, 12] == [r["step"] for r in jrows]
    np.testing.assert_allclose([r["train/fine_loss"] for r in trows],
                               [r["train/fine_loss"] for r in jrows], rtol=3e-5)
    assert trows[1]["train/fine_loss"] < trows[0]["train/fine_loss"] and state["steps"] == 12
    ckpts = os.path.join(dirs[1], "ckpts")
    assert sorted(os.listdir(ckpts)) == ["0", "1"]
    restored = tckpt.restore_checkpoint(ckpts, device="cpu")
    assert list(restored) == ["params"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]),
                                                  tree_leaves(tparams)))
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * jcfg.lrate * 12)


def test_mip_online_matches_startrax(tmp_path, monkeypatch, scene_cache):
    """Warm-started from one app-init checkpoint (a perturbed static field,
    saved in each package's format), with noisy poses, K = 2, the
    curriculum over 4 frames, accumulation 2 and every regularizer."""
    jcfg, tcfg = _app_cfgs(tmp_path, scene_cache, **ONLINE,
                           appearance_ckpt_path=str(tmp_path / "app"))
    tree, state = _shared_app(monkeypatch, jcfg)
    warm = _tree(japp.mip_config_from(jcfg), 9)
    jckpt.save_checkpoint(str(tmp_path / "app" / "jax"), {"params": warm}, step=0)
    tckpt.save_checkpoint(str(tmp_path / "app" / "torch"),
                          {"params": convert.params_from_numpy(warm, device="cpu")}, step=0)
    jcfg.appearance_ckpt_path = str(tmp_path / "app" / "jax")
    tcfg.appearance_ckpt_path = str(tmp_path / "app" / "torch")

    jparams = japp.train_online(jcfg)
    tparams = tapp.train_online(tcfg, device="cpu")
    dirs = [str(tmp_path / p / "smoke" / "mip_online") for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    train = [(t, j) for t, j in zip(trows, jrows) if "train/fine_loss" in j]
    vals = [(t, j) for t, j in zip(trows, jrows) if "val/psnr" in j]
    assert len(train) == 3 and len(vals) == 1  # the curriculum is done after epoch 2
    assert [t["train/current_frame_num"] for t, _ in train] == [3, 4, 5]
    for key, rtol, atol in (("train/fine_loss", 1e-5, 0), ("train/trans_error_0", 0, 2e-7),
                            ("train/trans_error_1", 0, 2e-7), ("train/rot_error_0", 0, 2e-7),
                            ("train/rot_error_1", 0, 2e-7)):
        np.testing.assert_allclose([t[key] for t, _ in train], [j[key] for _, j in train],
                                   rtol=rtol, atol=atol, err_msg=key)
    for t, j in vals:
        assert abs(t["val/psnr"] - j["val/psnr"]) < 1e-5
        assert abs(t["val/ssim"] - j["val/ssim"]) < 8e-6
    q = tparams["poses"][..., 3:7].detach()
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tparams["poses"].detach().numpy(), np.asarray(jparams["poses"]),
                               rtol=0, atol=2 * jcfg.lrate_pose * state["steps"])
    # the warm start took the checkpoint's static field, not the init's
    assert not np.allclose(np.asarray(warm["static"]["rgb"]["w"]), tree["static"]["rgb"]["w"])
    for a, b in zip(tree_leaves(tparams["nerf"]["static"]),
                    jax.tree.leaves(jparams["nerf"]["static"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * jcfg.lrate_static * state["steps"])
    ckpts = os.path.join(dirs[1], "ckpts")
    assert sorted(os.listdir(ckpts)) == sorted(os.listdir(os.path.join(dirs[0], "ckpts")))
    restored = tckpt.restore_checkpoint(ckpts, device="cpu")
    assert sorted(restored) == ["curriculum", "params"] and restored["curriculum"]["done"]


def test_mip_test_matches_startrax(tmp_path, monkeypatch, scene_cache):
    """test() on one checkpoint (saved in each package's format): the same
    rows and pose files. (startrax's test() inits a tree and then replaces
    it with the checkpoint's; its init is patched to the checkpoint's tree,
    which spares seconds of eager init.)"""
    jcfg, tcfg = _app_cfgs(tmp_path, scene_cache, test=True, eval_last_frame=2)
    mcfg = japp.mip_config_from(jcfg)
    tree = {"nerf": _tree(mcfg, 11), "poses": _pose(2 * 3, 11).reshape(3, 2, 7)}
    monkeypatch.setattr(jmip, "init_star_mip", lambda key, cfg: tree["nerf"])
    jckpt.save_checkpoint(str(tmp_path / "ck" / "jax"), {"params": tree}, step=0)
    tckpt.save_checkpoint(str(tmp_path / "ck" / "torch"),
                          {"params": convert.params_from_numpy(tree, device="cpu")}, step=0)
    jcfg.online_ckpt_path = str(tmp_path / "ck" / "jax")
    tcfg.online_ckpt_path = str(tmp_path / "ck" / "torch")
    japp.test(jcfg)
    tapp.test(tcfg, device="cpu")
    dirs = [tmp_path / p / "smoke" / "mip_test" for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows] and len(trows) > 6
    for t, j in zip(trows, jrows):
        assert t["step"] == j["step"]
        for k, v in j.items():
            if k.startswith("test/"):
                np.testing.assert_allclose(t[k], v, rtol=2e-5, atol=6e-5, err_msg=k)
    for k in range(2):
        name = f"poses_vehicle{k}.txt"
        np.testing.assert_allclose(np.loadtxt(dirs[1] / name), np.loadtxt(dirs[0] / name),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["app_init", "online", "test"])
def test_mip_app_defaults_to_the_card(entry, tmp_path, monkeypatch):
    """Through main's argv parser: without a CUDA device each entry point
    raises and names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "startrax", "configs", "carla_star_app_init_mip.txt")
    extra = {"app_init": [], "online": ["--skip_appearance_init", "true"],
             "test": ["--test", "true"]}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapp.main(["--config", config, "--basedir", str(tmp_path), *extra])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["carla_star_app_init_mip.txt", "carla_star_online_mip.txt"])
def test_mip_config_from_follows_startrax(name):
    path = os.path.join(ROOT, "startrax", "configs", name)
    j = japp.mip_config_from(jconfig.load_config(["--config", path]))
    t = tapp.mip_config_from(tconfig.load_config(["--config", path]))
    for field in ("num_vehicles", "depth", "width", "num_freqs_pos", "num_freqs_dir", "n_samples",
                  "n_importance", "near", "far", "base_radius"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.compute_dtype == torch.bfloat16 and j.compute_dtype == jnp.bfloat16
    assert (t.input_ch, t.input_ch_views) == (j.input_ch, j.input_ch_views) == (144, 27)
