"""Parity of the port's time-conditioned baseline (nerf_time) with startrax on
the CPU: the field with time, its pre-encoded fused-MLP mode, the render, the
training step, the tiled eval render, rays and the image metrics.

Fields are 2 blocks of width 32 with input_dims 4 (84 encoded point
columns), weights from one JAX init (perturbed so that fc1 is nonzero and
every path carries gradient) carried over with startrax_torch.convert;
inputs are numpy arrays from a seed; the render draws 8 rays x (8 + 8)
samples. Tolerances:

- float32 against JAX's XLA field (use_fused=False): outputs within 1e-5,
  gradients of the params, points and directions within 1e-4 of each
  gradient's largest magnitude (the points' grads pass the encoding's top
  frequency, 2^9).
- bf16: the port's fused wrapper on CPU tensors (the kernels' plain
  version) against the Pallas kernel in its pre-encoded mode (pe=None),
  interpret mode, tile 32 on 80 ragged points; and the stacked wrapper
  (fused_stacked_apply, pe=None) on K = 2 fields against the stacked Pallas
  kernel likewise. Both round matmul operands to
  bf16 and accumulate in f32 in different orders, so forward within 1e-2 and
  gradients (params and the encoded inputs) within 2e-2 of the largest
  magnitude, as tests/test_torch_fields.py.
- Renders (f32): outputs within 1e-4; gradients within 1e-2 of the largest
  magnitude (the fine samples inherit the coarse weights' float32
  differences through the CDF inverse, as tests/test_torch_star.py says).
- Steps: test_torch_train.py's bounds (first loss 1e-4 relative, later 2e-3;
  parameters within 2 x lr x steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from startrax.eval import image as jimage
from startrax.eval import render as jrender
from startrax.kernels import fused_mlp as jfused
from startrax.models import fields as jfields
from startrax.models import nerf_time as jnt
from startrax.ops import encoding as jenc
from startrax.ops import rays as jrays
from startrax.train import optim as joptim
from startrax.train.loop import LossConfig as JLossConfig
from startrax.train.loop import compute_losses as jcompute_losses
from startrax_torch import convert
from startrax_torch.eval import image as timage
from startrax_torch.eval import render as trender
from startrax_torch.kernels import fused_mlp as tfused
from startrax_torch.models import fields as tfields
from startrax_torch.models import nerf_time as tnt
from startrax_torch.models.star import StarConfig
from startrax_torch.ops import rays as trays
from startrax_torch.ops.encoding import positional_encoding
from startrax_torch.train import loop as tloop
from startrax_torch.train import optim as toptim
from startrax_torch.utils.tree import tree_leaves

JCFG = jfields.FieldConfig(depth=4, width=32, input_dims=4, compute_dtype=jnp.float32,
                           use_fused=False)
TCFG = tfields.FieldConfig(depth=4, width=32, input_dims=4, compute_dtype=torch.float32,
                           use_fused=False)
N_RAYS = 8
NUM_FRAMES = 16
LR = 5e-4


def _perturbed(params, seed):
    return jax.tree.map(
        lambda x: np.asarray(x + 0.01 * jax.random.normal(jax.random.PRNGKey(seed), x.shape)),
        params)


def _field_setup(seed, n_samples=8):
    params = _perturbed(jfields.init_field(jax.random.PRNGKey(seed), JCFG), seed + 1)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N_RAYS, n_samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return params, pts, dirs


def _loss(mod, a, r):
    return mod.sum(mod.sin(a)) + mod.sum(r ** 2)


def _assert_scaled(t_leaves, j_leaves, atol):
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        a, b = a.detach().numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)


def test_apply_field_with_time_f32_matches_xla():
    params_np, pts, dirs = _field_setup(seed=0)
    time = 6.0 / (NUM_FRAMES - 1)

    def jloss(p, x, v):
        a, r = jfields.apply_field(p, JCFG, x, v, time=jnp.float32(time))
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pts), jnp.asarray(dirs))
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpts, tdirs = torch.tensor(pts, requires_grad=True), torch.tensor(dirs, requires_grad=True)
    a, r = tfields.apply_field(tp, TCFG, tpts, tdirs, time=torch.tensor(time))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(_loss(torch, a, r), tree_leaves(tp) + [tpts, tdirs])
    _assert_scaled(grads, jax.tree.leaves(gj[0]) + [gj[1], gj[2]], atol=1e-4)


def test_fused_pre_encoded_bf16_matches_pallas_interpret():
    """The pre-encoded mode (the field with time, encoded outside) against
    the Pallas kernel with pe=None in interpret mode, on 80 points (tile 32,
    ragged): forward, weight grads and the grads of the encoded inputs."""
    params_np, pts, dirs = _field_setup(seed=1, n_samples=10)
    x = np.concatenate([pts.reshape(-1, 3), np.full((pts.shape[0] * pts.shape[1], 1), 0.4,
                                                    np.float32)], -1)
    d = np.broadcast_to(dirs[:, None, :], pts.shape).reshape(-1, 3)
    x_emb = np.asarray(jenc.positional_encoding(jnp.asarray(x), JCFG.multires))
    d_emb = np.asarray(jenc.positional_encoding(jnp.asarray(d), JCFG.multires_views))
    assert x_emb.shape == (80, 84) and d_emb.shape == (80, 27)

    def jloss(p, xe, de):
        a, r = jfused.fused_field_apply(p, xe, de, JCFG.n_blocks, tile=32, interpret=True)
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x_emb), jnp.asarray(d_emb))
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    txe = positional_encoding(torch.tensor(x), TCFG.multires).requires_grad_(True)
    tde = positional_encoding(torch.tensor(d.copy()), TCFG.multires_views).requires_grad_(True)
    tfused.reset_launch_counts()
    a, r = tfused.fused_field_apply(tp, txe, tde, TCFG.n_blocks)
    assert set(tfused.launches.values()) == {0}
    scale = max(np.abs(np.asarray(aj)).max(), np.abs(np.asarray(rj)).max())
    np.testing.assert_allclose(a.detach().numpy() / scale, np.asarray(aj) / scale, atol=1e-2)
    np.testing.assert_allclose(r.detach().numpy() / scale, np.asarray(rj) / scale, atol=1e-2)
    grads = torch.autograd.grad(_loss(torch, a, r), tree_leaves(tp) + [txe, tde])
    _assert_scaled(grads, jax.tree.leaves(gj[0]) + [gj[1], gj[2]], atol=2e-2)


def test_fused_stacked_pre_encoded_bf16_matches_pallas_interpret():
    """The stacked pre-encoded mode (fused_stacked_apply with pe=None, K = 2
    fields) against the stacked Pallas kernel with pe=None in interpret
    mode, on 80 ragged points a field (tile 32): forward, every field's
    weight grads and dx_emb, dd_emb. No launch is counted on the CPU."""
    trees = [_field_setup(seed=s, n_samples=10)[0] for s in (3, 4)]
    params_np = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=(2, 80, 3)), np.full((2, 80, 1), 0.4)], -1)
    d = rng.normal(size=(2, 80, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x_emb = np.asarray(jenc.positional_encoding(jnp.asarray(x, jnp.float32), JCFG.multires))
    d_emb = np.asarray(jenc.positional_encoding(jnp.asarray(d, jnp.float32), JCFG.multires_views))
    assert x_emb.shape == (2, 80, 84) and d_emb.shape == (2, 80, 27)

    def jloss(p, xe, de):
        a, r = jfused.fused_stacked_apply(p, xe, de, JCFG.n_blocks, tile=32, interpret=True)
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x_emb), jnp.asarray(d_emb))
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    txe = torch.tensor(x_emb, requires_grad=True)
    tde = torch.tensor(d_emb, requires_grad=True)
    tfused.reset_launch_counts()
    a, r = tfused.fused_stacked_apply(tp, txe, tde, TCFG.n_blocks)
    assert set(tfused.launches.values()) == {0}
    assert a.shape == (2, 80) and r.shape == (2, 80, 3)
    scale = max(np.abs(np.asarray(aj)).max(), np.abs(np.asarray(rj)).max())
    np.testing.assert_allclose(a.detach().numpy() / scale, np.asarray(aj) / scale, atol=1e-2)
    np.testing.assert_allclose(r.detach().numpy() / scale, np.asarray(rj) / scale, atol=1e-2)
    grads = torch.autograd.grad(_loss(torch, a, r), tree_leaves(tp) + [txe, tde])
    want = jax.tree.leaves(gj[0]) + [gj[1], gj[2]]
    for k in range(2):  # each field against its own scale
        _assert_scaled([g[k] for g in grads], [np.asarray(w)[k] for w in want], atol=2e-2)


def test_fused_stacked_pre_encoded_one_field_is_the_per_field_mode():
    """K = 1 through fused_stacked_apply(pe=None) gives fused_field_apply's
    pre-encoded result and grads on the CPU, bit for bit."""
    params_np, pts, dirs = _field_setup(seed=6)
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    ts = convert.params_from_numpy(jax.tree.map(lambda v: v[None], params_np), device="cpu",
                                   requires_grad=True)
    rng = np.random.default_rng(6)
    xe = torch.tensor(rng.normal(size=(30, 84)).astype(np.float32))
    de = torch.tensor(rng.normal(size=(30, 27)).astype(np.float32))
    a1, r1 = tfused.fused_field_apply(tp, xe, de, TCFG.n_blocks)
    a2, r2 = tfused.fused_stacked_apply(ts, xe[None], de[None], TCFG.n_blocks)
    assert torch.equal(a1, a2[0]) and torch.equal(r1, r2[0])
    g1 = torch.autograd.grad(_loss(torch, a1, r1), tree_leaves(tp))
    g2 = torch.autograd.grad(_loss(torch, a2, r2), tree_leaves(ts))
    assert all(torch.equal(u, v[0]) for u, v in zip(g1, g2))


def test_pre_encoded_mode_refuses_warp_masks_and_field_axis():
    params_np, pts, dirs = _field_setup(seed=2)
    tp = convert.params_from_numpy(params_np, device="cpu")
    xe = torch.zeros(4, 84)
    de = torch.zeros(4, 27)
    with pytest.raises(ValueError, match="warp or BARF masks"):
        tfused.fused_field_apply(tp, xe, de, TCFG.n_blocks, warp=torch.zeros(16))
    with pytest.raises(ValueError, match="only supported for 3-d"):
        tfields.apply_field(tp, TCFG, torch.tensor(pts), torch.tensor(dirs), time=0.5,
                            warp=torch.zeros(16))
    with pytest.raises(ValueError, match="needs time"):
        tfields.apply_field(tp, TCFG, torch.tensor(pts), torch.tensor(dirs))


def _star_cfgs():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), n_samples=8, n_importance=8)
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["compute_dtype"] = torch.float32
    return jcfg, StarConfig(**kw)


def _model_setup(seed):
    jcfg, tcfg = _star_cfgs()
    params = _perturbed(jnt.init_nerf_time(jax.random.PRNGKey(seed), jcfg), seed + 1)
    rng = np.random.default_rng(seed)
    rays_o = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return jcfg, tcfg, params, rays_o, rays_d


def _uniforms(key, cfg, n_rays=N_RAYS):
    """The stratified jitter and importance-sampling uniforms that JAX's
    render_nerf_time draws from key."""
    k_strat, k_pdf = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k_strat, (n_rays, cfg.n_samples)))),
            torch.tensor(np.asarray(jax.random.uniform(k_pdf, (n_rays, cfg.n_importance)))))


def _render_loss(mod, out):
    return mod.sum(out["rgb"] ** 2) + mod.sum(out["rgb0"] ** 2) + 0.1 * mod.sum(out["depth"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_render_nerf_time_matches_startrax(train):
    jcfg, tcfg, params_np, rays_o, rays_d = _model_setup(seed=3)
    key = jax.random.PRNGKey(4)
    frame = 5

    def jloss(p):
        out = jnt.render_nerf_time(p, jcfg, jnp.asarray(rays_o), jnp.asarray(rays_d),
                                   frame=frame, num_frames=NUM_FRAMES,
                                   key=key if train else None, train=train)
        return _render_loss(jnp, out), out

    (_, out_j), gj = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    u_strat, u_pdf = _uniforms(key, jcfg) if train else (None, None)
    out_t = tnt.render_nerf_time(tp, tcfg, torch.tensor(rays_o), torch.tensor(rays_d),
                                 torch.tensor(frame), NUM_FRAMES, train=train, u_strat=u_strat,
                                 u_pdf=u_pdf)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    grads = torch.autograd.grad(_render_loss(torch, out_t), tree_leaves(tp))
    _assert_scaled(grads, jax.tree.leaves(gj), atol=1e-2)


def test_nerf_time_steps_match_startrax():
    """Three steps against the JAX step_fn rebuilt as apps/nerf_time.py
    builds it (its optimizer, compute_losses with online=False), on one
    batch at frame 9, with depth supervision."""
    import optax

    n_steps = 3
    jcfg, tcfg, params_np, rays_o, rays_d = _model_setup(seed=5)
    rng = np.random.default_rng(6)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    depth = rng.uniform(jcfg.near, jcfg.far, size=N_RAYS).astype(np.float32)
    loss_kw = dict(use_depth_loss=True, depth_lambda=0.1)
    jloss_cfg = JLossConfig(**loss_kw)
    opt_kw = dict(steps_per_epoch=2, decay_rate=0.5, decay_milestones=[1])
    tx = joptim.make_appinit_optimizer(LR, **opt_kw)

    def loss_fn(params, batch, k):
        out = jnt.render_nerf_time(params, jcfg, batch["rays_o"], batch["rays_d"],
                                   frame=batch["frame"], num_frames=NUM_FRAMES, key=k, train=True)
        return jcompute_losses(out, batch, jcfg, jloss_cfg, online=False)

    @jax.jit
    def step_fn(params, opt_state, batch, k):
        (lossv, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, k)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, lossv, metrics

    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = tx.init(jparams)
    jbatch = {"rays_o": jnp.asarray(rays_o), "rays_d": jnp.asarray(rays_d),
              "target": jnp.asarray(target), "target_depth": jnp.asarray(depth),
              "frame": jnp.asarray(9, jnp.int32)}
    tparams = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    topt = toptim.make_appinit_optimizer(tparams, LR, **opt_kw)
    tstep = tloop.make_nerf_time_train_step(tcfg, tloop.LossConfig(**loss_kw), topt, NUM_FRAMES)
    tbatch = {"rays_o": torch.tensor(rays_o), "rays_d": torch.tensor(rays_d),
              "target": torch.tensor(target), "target_depth": torch.tensor(depth), "frame": 9}
    key = jax.random.PRNGKey(7)
    for i in range(n_steps):
        key, sub = jax.random.split(key)
        jparams, jstate, jl, jm = step_fn(jparams, jstate, jbatch, sub)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        tl, tm = tstep(tparams, tbatch, u_strat=u_strat, u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4 if i == 0 else 2e-3)
    assert sorted(tm) == sorted(jm)
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * LR * n_steps)


def test_render_image_nerf_time_matches_startrax():
    """An 8x8 frame from get_rays in tiles of 32 rays (two tiles): every key
    the JAX tiled render returns, each equal (1e-6) to the port's untiled
    eval render of the same rays. Against JAX's tiled render the coarse
    outputs hold within 1e-4 and the fine ones within 1e-2: the eval
    importance samples invert the CDF at u = 0 ... 1, where a last-ulp
    difference in the cumulative sum moves a sample by a bin, and JAX's own
    jitted tiles and its eager render differ by 4.6e-3 in depth here."""
    jcfg, tcfg, params_np, _, _ = _model_setup(seed=8)
    K = jrays.intrinsics_matrix(8, 8, jrays.focal_from_fov(8, 60.0))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 4.0]
    ro, rd = jrays.get_rays_np(8, 8, K, c2w)
    out_j = jrender.render_image_nerf_time(jax.tree.map(jnp.asarray, params_np), jcfg, ro, rd,
                                           frame=3, num_frames=NUM_FRAMES, tile=32)
    tp = convert.params_from_numpy(params_np, device="cpu")
    tro, trd = trays.get_rays(8, 8, K, c2w, device="cpu")
    out_t = trender.render_image_nerf_time(tp, tcfg, tro, trd, 3, NUM_FRAMES, tile=32,
                                           device="cpu")
    with torch.no_grad():
        whole = tnt.render_nerf_time(tp, tcfg, tro.reshape(-1, 3), trd.reshape(-1, 3), 3,
                                     NUM_FRAMES, train=False)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape == (8, 8) + out_j[k].shape[2:]
        np.testing.assert_allclose(out_t[k], whole[k].reshape(out_t[k].shape).numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        tol = 1e-4 if k.endswith("0") else 1e-2
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=tol, atol=tol, err_msg=k)


def test_rays_match_startrax():
    K = jrays.intrinsics_matrix(6, 10, jrays.focal_from_fov(10, 50.0))
    assert np.array_equal(trays.intrinsics_matrix(6, 10, trays.focal_from_fov(10, 50.0)), K)
    rng = np.random.default_rng(9)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=(3, 1))],
                         1).astype(np.float32)
    jo, jd = jrays.get_rays(6, 10, jnp.asarray(K), jnp.asarray(c2w))
    to, td = trays.get_rays(6, 10, K, c2w, device="cpu")
    no, nd = trays.get_rays_np(6, 10, K, c2w)
    for a, b in ((to, jo), (td, jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in ((no, jo), (nd, jd)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_image_metrics_match_startrax():
    """mse, psnr (with and without a mask), ssim with its full map, and
    masked_ssim on 24x20 images, within 1e-5."""
    rng = np.random.default_rng(10)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(24, 20)) > 0.5
    ta, tb, tmask = torch.tensor(a), torch.tensor(b), torch.tensor(mask)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [(timage.mse(ta, tb), jimage.mse(ja, jb)),
             (timage.psnr(ta, tb), jimage.psnr(ja, jb)),
             (timage.psnr(ta, tb, tmask), jimage.psnr(ja, jb, jnp.asarray(mask))),
             (timage.ssim(ta, tb), jimage.ssim(ja, jb)),
             (timage.masked_ssim(ta, tb, tmask), jimage.masked_ssim(ja, jb, mask))]
    for t, j in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-5)
    _, tmap = timage.ssim(ta, tb, return_full=True)
    _, jmap = jimage.ssim(ja, jb, return_full=True)
    assert tmap.shape == (14, 10, 3)
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), atol=1e-5)
