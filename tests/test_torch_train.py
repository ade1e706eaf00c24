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
from startrax.train import loop as jloop
from startrax.train import optim as joptim
from startrax_torch import convert
from startrax_torch.models.star import StarConfig
from startrax_torch.train import loop as tloop
from startrax_torch.train import optim as toptim
from startrax_torch.utils.tree import tree_leaves

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
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), requires_grad=True)

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
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), requires_grad=True)
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
    tp = convert.params_from_numpy(p0)
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


def test_gather_frame_pose_pins_frame0():
    poses = torch.randn(3, 2, 7)
    np.testing.assert_array_equal(tloop.gather_frame_pose(poses, 0, 2).numpy(),
                                  np.asarray(jloop.gather_frame_pose(jnp.asarray(poses.numpy()),
                                                                     0, 2)))
    np.testing.assert_array_equal(tloop.gather_frame_pose(poses, 2, 2).numpy(), poses[1].numpy())


def test_gradient_accumulation_not_ported():
    params = tloop.init_online_params(_tcfg(_flagship_cfg(tiny=True)), 3,
                                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        toptim.make_fused_star_optimizer(params, LR, LR, LR, accumulate_steps=50)
