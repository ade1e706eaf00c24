"""Parity of the port's STaR renderer with startrax.models.star on the CPU.

Tiny flagship shapes (``__graft_entry__._flagship_cfg(tiny=True)``: K=2,
depth 4, width 32, 16 + 16 samples) in float32 on the plain field path.
Weights come from one JAX init through startrax_torch.convert. JAX's own
uniforms are rebuilt exactly as ``render_star`` draws them (split the key in
three; the stratified jitter and the importance-sampling uniforms) and
passed to the port. Outputs are held within 1e-4 (relative and absolute).
Gradients are held within 1e-2 of each gradient's largest magnitude: the
fine pass's sample depths come from the coarse weights through a CDF
inverse and so inherit their float32 differences (~1e-5 in z here), and
the encoding's top frequency (2^9) turns that into ~5e-3 on the gradients of
the layers that read the encoding and on the pose.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from startrax.models import star as jstar
from startrax_torch import convert
from startrax_torch.models import star as tstar
from startrax_torch.utils.tree import tree_leaves

N_RAYS = 6


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["compute_dtype"] = torch.float32
    return tstar.StarConfig(**kw)


def _jax_uniforms(key, cfg):
    k_strat, k_pdf, _ = jax.random.split(key, 3)
    u_strat = np.asarray(jax.random.uniform(k_strat, (N_RAYS, cfg.n_samples)))
    u_pdf = np.asarray(jax.random.uniform(k_pdf, (N_RAYS, cfg.n_importance)))
    return torch.tensor(u_strat), torch.tensor(u_pdf)


def _setup(seed):
    jcfg = _flagship_cfg(tiny=True)
    params = jstar.init_star(jax.random.PRNGKey(seed), jcfg)
    # nonzero fc1 everywhere so every block carries gradient
    params = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), params)
    rng = np.random.default_rng(seed)
    rays_o = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    q = rng.normal(size=(jcfg.num_vehicles, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pose = np.concatenate([0.2 * rng.normal(size=(jcfg.num_vehicles, 3)).astype(np.float32), q],
                          -1)
    return jcfg, jax.tree.map(np.asarray, params), rays_o, rays_d, pose


def _loss(mod, out, online):
    total = mod.sum(out["rgb"] ** 2) + mod.sum(out["rgb0"] ** 2) + 0.1 * mod.sum(out["depth"])
    if online:
        total = total + out["loss_alpha_entropy"] + out["loss_ray_reg"]
    return total


@pytest.mark.parametrize("online", [True, False], ids=["online", "appinit"])
def test_render_star_matches_startrax(online):
    jcfg, params_np, rays_o, rays_d, pose = _setup(seed=0)
    key = jax.random.PRNGKey(7)

    def jrender(p, pose):
        out = jstar.render_star(p, jcfg, jnp.asarray(rays_o), jnp.asarray(rays_d), key=key,
                                pose=pose if online else None, train=True,
                                with_test_outputs=online)
        return _loss(jnp, out, online), out

    (_, out_j), (gp_j, gpose_j) = jax.jit(
        jax.value_and_grad(jrender, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pose))

    tcfg = _tcfg(jcfg)
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpose = torch.tensor(pose, requires_grad=True)
    u_strat, u_pdf = _jax_uniforms(key, jcfg)
    out_t = tstar.render_star(tp, tcfg, torch.tensor(rays_o), torch.tensor(rays_d),
                              pose=tpose if online else None, train=True,
                              with_test_outputs=online, u_strat=u_strat, u_pdf=u_pdf)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)

    leaves = tree_leaves(tp) + ([tpose] if online else [])
    grads = torch.autograd.grad(_loss(torch, out_t, online), leaves, allow_unused=True)
    j_leaves = jax.tree.leaves(gp_j) + ([gpose_j] if online else [])
    assert len(grads) == len(j_leaves)
    for a, b in zip(grads, j_leaves):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)


@pytest.mark.parametrize("barf", [False, True], ids=["plain", "barf"])
def test_render_star_per_ray_pose_matches_startrax(barf):
    """A mixed-frame batch: every ray has its own pose [R, K, 7], which
    reaches the dynamic fields through warp_to_vehicle_frames, with BARF at
    step 5 of 12 or without. Same bounds as the shared-pose test."""
    jcfg, params_np, rays_o, rays_d, pose = _setup(seed=3)
    if barf:
        jcfg = dataclasses.replace(jcfg, end_barf=12)
    step = 5 if barf else None
    rng = np.random.default_rng(3)
    pose = np.broadcast_to(pose, (N_RAYS,) + pose.shape).copy()
    pose[..., :3] += 0.1 * rng.normal(size=pose[..., :3].shape).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def jrender(p, pose):
        out = jstar.render_star(p, jcfg, jnp.asarray(rays_o), jnp.asarray(rays_d), key=key,
                                pose=pose, train=True, step=step, with_test_outputs=True)
        return _loss(jnp, out, True), out

    (_, out_j), (gp_j, gpose_j) = jax.jit(
        jax.value_and_grad(jrender, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pose))

    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpose = torch.tensor(pose, requires_grad=True)
    u_strat, u_pdf = _jax_uniforms(key, jcfg)
    out_t = tstar.render_star(tp, _tcfg(jcfg), torch.tensor(rays_o), torch.tensor(rays_d),
                              pose=tpose, train=True, step=step, with_test_outputs=True,
                              u_strat=u_strat, u_pdf=u_pdf)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    grads = torch.autograd.grad(_loss(torch, out_t, True), tree_leaves(tp) + [tpose])
    for a, b in zip(grads, jax.tree.leaves(gp_j) + [gpose_j]):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-2)


def test_render_star_eval_is_deterministic_and_matches_startrax():
    jcfg, params_np, rays_o, rays_d, pose = _setup(seed=1)
    out_j = jax.jit(lambda p, o, d, pose: jstar.render_star(p, jcfg, o, d, pose=pose,
                                                            train=False))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(rays_o), jnp.asarray(rays_d),
        jnp.asarray(pose))
    out_t = tstar.render_star(convert.params_from_numpy(params_np, device="cpu"),
                              _tcfg(jcfg),
                              torch.tensor(rays_o), torch.tensor(rays_d),
                              pose=torch.tensor(pose), train=False)
    for k in ("rgb", "rgb0", "depth", "acc", "weights", "z_std"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_warp_to_vehicle_frames_and_pack_warp_match_startrax():
    rng = np.random.default_rng(2)
    pose = np.concatenate([rng.normal(size=(2, 3)), rng.normal(size=(2, 4))], -1)
    pose[:, 3:] /= np.linalg.norm(pose[:, 3:], axis=-1, keepdims=True)
    pose = pose.astype(np.float32)
    pts = rng.normal(size=(3, 4, 3)).astype(np.float32)
    dirs = rng.normal(size=(3, 3)).astype(np.float32)
    for p in (pose, np.broadcast_to(pose, (3, 2, 7)).copy()):
        pj, dj = jstar.warp_to_vehicle_frames(jnp.asarray(p), jnp.asarray(pts), jnp.asarray(dirs))
        pt, dt = tstar.warp_to_vehicle_frames(torch.tensor(p), torch.tensor(pts),
                                              torch.tensor(dirs))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tstar.pack_warp(torch.tensor(pose[0])).numpy(),
                               np.asarray(jstar.pack_warp(jnp.asarray(pose[0]))), atol=1e-6)
