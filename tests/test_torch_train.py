"""Parity of the port's training steps and optimizer with startrax.train.

Tiny flagship shapes in float32 on the plain field path; weights from one
JAX init through startrax_torch.convert; each step's uniforms rebuilt from
the JAX key the reference step receives. Adam's first update is lr * sign(g)
for every gradient far above eps, however small, so a rounding-level
gradient difference on a near-zero gradient flips a whole lr-sized step
(fc1 starts at zero and many of its grads are ~0). Hence: the first step's
loss (same parameters on both sides) is held within 1e-4 relative; later
losses within 2e-3 relative; parameters after the steps within
2 x lr x steps absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from startrax.ops import lie as jlie
from startrax.train import loop as jloop
from startrax.train import optim as joptim
from startrax_torch import convert
from startrax_torch.models.star import StarConfig
from startrax_torch.train import loop as tloop
from startrax_torch.train import optim as toptim
from startrax_torch.utils.tree import tree_leaves
from test_torch_cuda import adam_matches_its_formula

N_RAYS = 8
LR = 5e-4
LOSS_CFG = dict(lambda_alpha_entropy=1e-3, lambda_dynamic_vs_static_reg=1e-3, lambda_ray_reg=1e-5)


def _tcfg(jcfg):
    import dataclasses

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["compute_dtype"] = torch.float32
    return StarConfig(**kw)


def _batch(seed, frame):
    rng = np.random.default_rng(seed)
    rays_o = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return ({"rays_o": jnp.asarray(rays_o), "rays_d": jnp.asarray(rays_d),
             "target": jnp.asarray(target), "frame": jnp.asarray(frame, jnp.int32)},
            {"rays_o": torch.tensor(rays_o), "rays_d": torch.tensor(rays_d),
             "target": torch.tensor(target), "frame": frame})


def _uniforms(key, cfg):
    k_strat, k_pdf, _ = jax.random.split(key, 3)
    return (torch.tensor(np.asarray(jax.random.uniform(k_strat, (N_RAYS, cfg.n_samples)))),
            torch.tensor(np.asarray(jax.random.uniform(k_pdf, (N_RAYS, cfg.n_importance)))))


def _assert_params_close(tparams, jparams, n_steps):
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * LR * n_steps)


@pytest.mark.parametrize("variant", ["full", "trans_only", "freeze_rot"])
def test_online_steps_match_startrax(variant):
    n_steps = 3
    jcfg = _flagship_cfg(tiny=True)
    jparams = jloop.init_online_params(jax.random.PRNGKey(0), jcfg, num_frames=4)
    # a non-identity pose table, so rotations matter from the first step
    poses = np.asarray(jparams["poses"]).copy()
    poses[..., :3] = 0.05 * np.random.default_rng(1).normal(size=poses[..., :3].shape)
    jparams["poses"] = jnp.asarray(poses)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                                        requires_grad=True)

    opt_kw = dict(lrate_static=LR, lrate_dynamic=LR, lrate_pose=LR, steps_per_epoch=100,
                  decay_milestones=[60], grad_clip=1.0)
    jtx = joptim.make_fused_star_optimizer(jparams, **opt_kw)
    jstate = jtx.init(jparams)
    flags = dict(trans_only=variant == "trans_only", freeze_rot=variant == "freeze_rot")
    jstep = jloop.make_online_train_step(jcfg, jloop.LossConfig(**LOSS_CFG), jtx, **flags)
    topt = toptim.make_fused_star_optimizer(tparams, **opt_kw)
    tstep = tloop.make_online_train_step(_tcfg(jcfg), tloop.LossConfig(**LOSS_CFG), topt,
                                         **flags)
    jbatch, tbatch = _batch(2, frame=2)
    key = jax.random.PRNGKey(3)
    for i in range(n_steps):
        key, sub = jax.random.split(key)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        jparams, jstate, jl, _ = jstep(jparams, jstate, jbatch, sub, jnp.asarray(0))
        tl, tm = tstep(tparams, tbatch, epoch=0, u_strat=u_strat, u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4 if i == 0 else 2e-3)
    assert np.isfinite(float(tm["psnr"]))
    _assert_params_close(tparams, jparams, n_steps)
    q = tparams["poses"].detach()[..., 3:7]
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-6)


def test_appinit_steps_match_startrax():
    n_steps = 2
    jcfg = _flagship_cfg(tiny=True)
    from startrax.models.star import init_star

    jparams = init_star(jax.random.PRNGKey(4), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                                        requires_grad=True)
    jtx = joptim.make_appinit_optimizer(LR, params=jparams)
    jstate = jtx.init(jparams)
    jstep = jloop.make_appinit_train_step(jcfg, jloop.LossConfig(), jtx)
    topt = toptim.make_appinit_optimizer(tparams, LR)
    tstep = tloop.make_appinit_train_step(_tcfg(jcfg), tloop.LossConfig(), topt)
    jbatch, tbatch = _batch(5, frame=0)
    key = jax.random.PRNGKey(6)
    for i in range(n_steps):
        key, sub = jax.random.split(key)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        jparams, jstate, jl, _ = jstep(jparams, jstate, jbatch, sub)
        tl, _ = tstep(tparams, tbatch, u_strat=u_strat, u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4 if i == 0 else 2e-3)
    _assert_params_close(tparams, jparams, n_steps)


@pytest.mark.parametrize("kind", ["milestones", "staircase", "cosine"])
def test_schedules_match_startrax(kind):
    kw = {"milestones": dict(decay_milestones=[2, 5], steps_per_epoch=10),
          "staircase": dict(decay_epochs=3, steps_per_epoch=10, decay_rate=0.3),
          "cosine": dict(cosine_t_max=50)}[kind]
    js, ts = joptim.make_schedule(LR, **kw), toptim.make_schedule(LR, **kw)
    for count in (0, 1, 19, 20, 21, 49, 50, 51, 75, 100):
        np.testing.assert_allclose(ts(count), float(js(jnp.asarray(count))), rtol=1e-6)


def test_fused_group_adam_matches_startrax():
    """Three groups, clipping, and the schedule read at the pre-increment
    count with post-increment bias correction, on fixed gradients."""
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    scheds = [joptim.make_schedule(1e-2, decay_milestones=[2]),
              joptim.make_schedule(3e-2, decay_epochs=1, decay_rate=0.5)]
    group = jnp.concatenate([jnp.zeros(12, jnp.int32), jnp.ones(5, jnp.int32)])
    jtx = joptim.fused_group_adam(p0, scheds, group, grad_clip=1.0)
    jp, js = jax.tree.map(jnp.asarray, p0), jtx.init(p0)
    tp = convert.params_from_numpy(p0, device="cpu")
    topt = toptim.FusedGroupAdam(
        [tp["a"], tp["b"]], [0, 1],
        [toptim.make_schedule(1e-2, decay_milestones=[2]),
         toptim.make_schedule(3e-2, decay_epochs=1, decay_rate=0.5)], grad_clip=1.0)
    for g in grads:
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        tp["a"].grad, tp["b"].grad = torch.tensor(g["a"]), torch.tensor(g["b"])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accumulate_steps", [1, 3])
@pytest.mark.parametrize("groups", [1, 3])
def test_fused_group_adam_matches_its_formula(groups, accumulate_steps):
    """Leaves and moments bit for bit equal to the update written out, on
    CPU leaves (the card's twin is in tests/test_torch_cuda.py)."""
    adam_matches_its_formula("cpu", groups, accumulate_steps)


def test_gather_frame_pose_pins_frame0():
    poses = torch.randn(3, 2, 7)
    np.testing.assert_array_equal(tloop.gather_frame_pose(poses, 0, 2).numpy(),
                                  np.asarray(jloop.gather_frame_pose(jnp.asarray(poses.numpy()),
                                                                     0, 2)))
    np.testing.assert_array_equal(tloop.gather_frame_pose(poses, 2, 2).numpy(), poses[1].numpy())


def test_gather_frame_pose_per_ray_frames_and_grad_scatter():
    """[R] frames give [R, K, 7] poses (frame 0 pinned to identity); the
    per-ray grads scatter-add back into each frame's row, as in JAX."""
    rng = np.random.default_rng(8)
    poses = rng.normal(size=(3, 2, 7)).astype(np.float32)
    frames = np.array([0, 2, 1, 2, 3, 0, 2], np.int32)
    w = rng.normal(size=(len(frames), 2, 7)).astype(np.float32)
    jpose = jloop.gather_frame_pose(jnp.asarray(poses), jnp.asarray(frames), 2)
    jgrad = jax.grad(lambda p: jnp.sum(w * jloop.gather_frame_pose(p, jnp.asarray(frames), 2)))(
        jnp.asarray(poses))
    tposes = torch.tensor(poses, requires_grad=True)
    tpose = tloop.gather_frame_pose(tposes, torch.tensor(frames), 2)
    assert tpose.shape == (len(frames), 2, 7)
    np.testing.assert_array_equal(tpose.detach().numpy(), np.asarray(jpose))
    (tgrad,) = torch.autograd.grad((torch.tensor(w) * tpose).sum(), tposes)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgrad[1].numpy(), w[1] + w[3] + w[6], rtol=1e-6)


def _mixed_batch(seed, frames, near, far):
    jbatch, tbatch = _batch(seed, frame=0)
    depth = np.random.default_rng(seed + 100).uniform(near, far, size=N_RAYS).astype(np.float32)
    jbatch.update(frame=jnp.asarray(frames, jnp.int32), target_depth=jnp.asarray(depth))
    tbatch.update(frame=torch.tensor(frames), target_depth=torch.tensor(depth))
    return jbatch, tbatch


def _noisy_online_params(jcfg, seed):
    jparams = jloop.init_online_params(jax.random.PRNGKey(seed), jcfg, num_frames=4)
    poses = np.asarray(jparams["poses"]).copy()
    poses[..., :3] = 0.05 * np.random.default_rng(seed + 1).normal(size=poses[..., :3].shape)
    jparams["poses"] = jnp.asarray(poses)
    return jparams, convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                              device="cpu", requires_grad=True)


@pytest.mark.parametrize("variant", ["joint", "freeze_rot_barf"])
def test_mixed_frame_online_steps_with_accumulation_match_startrax(variant):
    """Three steps on a mixed-frame batch (per-ray frames, depth loss) with
    accumulate_steps=2: the update comes on step 2 only, step 1 leaves the
    parameters bit for bit. freeze_rot_barf is the BARF warmup (end_barf 12,
    epoch 5, rotations frozen). Bounds as the module docstring says, with
    one update behind the parameters."""
    import dataclasses

    jcfg = _flagship_cfg(tiny=True)
    barf = variant == "freeze_rot_barf"
    if barf:
        jcfg = dataclasses.replace(jcfg, end_barf=12)
    epoch = 5 if barf else 12
    jparams, tparams = _noisy_online_params(jcfg, seed=9)
    loss_cfg = dict(LOSS_CFG, use_depth_loss=True, depth_lambda=0.1)
    opt_kw = dict(lrate_static=LR, lrate_dynamic=LR, lrate_pose=LR, steps_per_epoch=100,
                  decay_milestones=[60], grad_clip=1.0, accumulate_steps=2)
    jtx = joptim.make_fused_star_optimizer(jparams, **opt_kw)
    jstate = jtx.init(jparams)
    jstep = jloop.make_online_train_step(jcfg, jloop.LossConfig(**loss_cfg), jtx, freeze_rot=barf)
    topt = toptim.make_fused_star_optimizer(tparams, **opt_kw)
    tstep = tloop.make_online_train_step(_tcfg(jcfg), tloop.LossConfig(**loss_cfg), topt,
                                         freeze_rot=barf)
    frames = np.array([0, 1, 2, 3, 3, 1, 2, 0], np.int32)
    jbatch, tbatch = _mixed_batch(10, frames, jcfg.near, jcfg.far)
    before = [t.detach().clone() for t in tree_leaves(tparams)]
    key = jax.random.PRNGKey(11)
    for i in range(3):
        key, sub = jax.random.split(key)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        jparams, jstate, jl, _ = jstep(jparams, jstate, jbatch, sub, jnp.asarray(epoch))
        tl, _ = tstep(tparams, tbatch, epoch=epoch, u_strat=u_strat, u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4 if i < 2 else 2e-3)
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tparams), before))
            g = tparams["poses"].grad
            assert all(bool(g[f - 1].abs().sum() > 0) for f in (1, 2, 3))
    assert not torch.equal(tparams["poses"].detach(), before[-1])
    _assert_params_close(tparams, jparams, 1)


def test_gauge_steps_match_startrax():
    """Gauge steps with the depth term at 2.0 on a mixed-frame batch. First
    the whole gauge gradient, rotation included, against the one the JAX
    step hands its optimizer (through se3_multiply and the per-ray render),
    within 1e-4 of its largest entry. Then three steps (optax.adam against
    make_gauge_optimizer) with the rotation frozen: the losses within the
    module's bounds, the gauge within 2 x lr x steps, its quaternion exactly
    identity, and no grad formed for fields or poses."""
    import optax

    jcfg = _flagship_cfg(tiny=True)
    jparams, tparams = _noisy_online_params(jcfg, seed=12)
    jgauge = jlie.se3_identity(jcfg.num_vehicles)
    frames = np.array([1, 2, 3, 0, 3, 2, 1, 1], np.int32)
    jbatch, tbatch = _mixed_batch(13, frames, jcfg.near, jcfg.far)
    key = jax.random.PRNGKey(14)

    # an optax transformation that keeps the gradient as its state and moves nothing
    capture = optax.GradientTransformation(jnp.zeros_like,
                                           lambda g, s, p=None: (jnp.zeros_like(g), g))
    jcap = jloop.make_gauge_train_step(jcfg, capture, depth_lambda=2.0)
    _, jgrad, _ = jcap(jgauge, capture.init(jgauge), jparams["nerf"], jparams["poses"], jbatch,
                       key)
    tprobe = torch.tensor(np.asarray(jgauge), requires_grad=True)
    tcap = tloop.make_gauge_train_step(_tcfg(jcfg), toptim.make_gauge_optimizer(tprobe, LR),
                                       depth_lambda=2.0)
    tcap(tprobe, tparams["nerf"], tparams["poses"], tbatch, *_uniforms(key, jcfg))
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad[:, :3]).min() > 0 and np.abs(jgrad[:, 3:6]).min() > 0
    np.testing.assert_allclose(tprobe.grad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())

    jtx = optax.adam(LR)
    jopt = jtx.init(jgauge)
    jstep = jloop.make_gauge_train_step(jcfg, jtx, freeze_rot=True, depth_lambda=2.0)
    tgauge = torch.tensor(np.asarray(jgauge), requires_grad=True)
    tstep = tloop.make_gauge_train_step(_tcfg(jcfg), toptim.make_gauge_optimizer(tgauge, LR),
                                        freeze_rot=True, depth_lambda=2.0)
    for i in range(3):
        key, sub = jax.random.split(key)
        u_strat, u_pdf = _uniforms(sub, jcfg)
        jgauge, jopt, jl = jstep(jgauge, jopt, jparams["nerf"], jparams["poses"], jbatch, sub)
        tl = tstep(tgauge, tparams["nerf"], tparams["poses"], tbatch, u_strat=u_strat,
                   u_pdf=u_pdf)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4 if i == 0 else 2e-3)
    np.testing.assert_allclose(tgauge.detach().numpy(), np.asarray(jgauge), rtol=0,
                               atol=2 * LR * 3)
    assert bool(tgauge.detach()[:, :3].abs().sum() > 0)
    np.testing.assert_array_equal(tgauge.detach()[:, 3:].numpy(), [[0, 0, 0, 1]] * 2)
    assert all(t.grad is None for t in tree_leaves(tparams))


@pytest.mark.parametrize("kind", ["star", "appinit"])
def test_gradient_accumulation_matches_multisteps(kind):
    """Six steps of fixed gradients with accumulate_steps=3 against
    optax.MultiSteps around the JAX optimizer: the parameters after every
    step (left bit for bit between updates), and a milestone that halves
    the learning rate after the first update (steps_per_epoch 3 -> one
    update an epoch)."""
    rng = np.random.default_rng(15)
    if kind == "star":
        p0 = {"nerf": {"static_coarse": {"w": rng.normal(size=(3, 4))},
                       "dynamic_coarse": {"w": rng.normal(size=(2, 2, 3))}},
              "poses": rng.normal(size=(2, 2, 7))}
    else:
        p0 = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=5)}
    p0 = jax.tree.map(lambda a: a.astype(np.float32), p0)
    kw = dict(steps_per_epoch=3, decay_milestones=[1], grad_clip=1.0, accumulate_steps=3)
    if kind == "star":
        jtx = joptim.make_fused_star_optimizer(p0, 1e-2, 2e-2, 3e-2, **kw)
    else:
        jtx = joptim.make_appinit_optimizer(1e-2, params=p0, **kw)
    jp, js = jax.tree.map(jnp.asarray, p0), jtx.init(p0)
    tp = convert.params_from_numpy(p0, device="cpu", requires_grad=True)
    if kind == "star":
        topt = toptim.make_fused_star_optimizer(tp, 1e-2, 2e-2, 3e-2, **kw)
    else:
        topt = toptim.make_appinit_optimizer(tp, 1e-2, **kw)
    for i in range(6):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p0)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        before = [t.detach().clone() for t in tree_leaves(tp)]
        for t, gg in zip(tree_leaves(tp), jax.tree.leaves(g)):
            t.grad = torch.tensor(gg)
        assert topt.step() == (i % 3 == 2)
        if i % 3 != 2:
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), before))
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert topt.count == 2
