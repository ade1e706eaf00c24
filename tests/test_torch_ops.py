"""Parity of the port's ops (startrax_torch.ops) with startrax.ops on the CPU.

Both sides get the same numpy inputs, made from a seed. Everything runs in
float32; unless a test says otherwise the tolerance is 1e-5 (absolute, and
relative where values are large).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.ops import compositing as jcomp
from startrax.ops import encoding as jenc
from startrax.ops import lie as jlie
from startrax.ops import losses as jloss
from startrax.ops import regularizers as jreg
from startrax.ops import sampling as jsamp
from startrax_torch.ops import compositing as tcomp
from startrax_torch.ops import encoding as tenc
from startrax_torch.ops import lie as tlie
from startrax_torch.ops import losses as tloss
from startrax_torch.ops import regularizers as treg
from startrax_torch.ops import sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n):
    return np.concatenate([rng.normal(size=(n, 3)).astype(np.float32), _quats(rng, n)], -1)


LIE_CASES = {
    "quat_normalize": lambda m, r: m.quat_normalize(r["q_raw"]),
    "quat_multiply": lambda m, r: m.quat_multiply(r["q"], r["q2"]),
    "quat_rotate": lambda m, r: m.quat_rotate(r["q"], r["v"]),
    "quat_to_matrix": lambda m, r: m.quat_to_matrix(r["q"]),
    "so3_act": lambda m, r: m.so3_act(r["q"], r["v"]),
    "se3_act": lambda m, r: m.se3_act(r["p"], r["v"]),
    "se3_multiply": lambda m, r: m.se3_multiply(r["p"], r["p2"]),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_startrax(name):
    rng = np.random.default_rng(0)
    inputs = {"q_raw": rng.normal(size=(5, 4)).astype(np.float32), "q": _quats(rng, 5),
              "q2": _quats(rng, 5), "v": rng.normal(size=(5, 3)).astype(np.float32),
              "p": _poses(rng, 5), "p2": _poses(rng, 5)}
    fn = LIE_CASES[name]
    out_t = fn(tlie, {k: torch.tensor(v) for k, v in inputs.items()})
    out_j = fn(jlie, {k: jnp.asarray(v) for k, v in inputs.items()})
    _close(out_t, out_j)


def test_se3_identity_matches_startrax():
    _close(tlie.se3_identity(3, 2), jlie.se3_identity(3, 2), rtol=0, atol=0)


@pytest.mark.parametrize("step", [None, 37.0])
def test_positional_encoding_matches_startrax(step):
    x = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    end_barf = 100 if step is not None else -1
    for F in (4, 10):
        out_t = tenc.positional_encoding(torch.tensor(x), F, step=step, end_barf=end_barf)
        out_j = jenc.positional_encoding(jnp.asarray(x), F, step=step, end_barf=end_barf)
        assert out_t.shape[-1] == tenc.encoding_dim(3, F) == jenc.encoding_dim(3, F)
        _close(out_t, out_j)
    _close(tenc.barf_weights(37.0, 100, 10), jenc.barf_weights(37.0, 100, 10))


def test_stratified_z_vals_matches_startrax():
    key = jax.random.PRNGKey(2)
    z_j = jsamp.stratified_z_vals(key, 4, 2.0, 6.0, 9)
    u = np.asarray(jax.random.uniform(key, (4, 9)))
    _close(tsamp.stratified_z_vals(4, 2.0, 6.0, 9, u=torch.tensor(u)), z_j)
    _close(tsamp.stratified_z_vals(4, 2.0, 6.0, 9, lindisp=True),
           jsamp.stratified_z_vals(None, 4, 2.0, 6.0, 9, lindisp=True))


@pytest.mark.parametrize("mode", ["det", "iid", "stratified"])
def test_sample_pdf_matches_startrax(mode):
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(2.0, 6.0, size=(6, 17)).astype(np.float32), axis=-1)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.uniform(size=(6, 15)).astype(np.float32)
    w[0] = 0.0  # an empty histogram
    key = jax.random.PRNGKey(4)
    u = None if mode == "det" else torch.tensor(np.asarray(jax.random.uniform(key, (6, 11))))
    out_j = jsamp.sample_pdf(None if mode == "det" else key, jnp.asarray(bins), jnp.asarray(w),
                             11, det=mode == "det", stratified=mode == "stratified")
    out_t = tsamp.sample_pdf(torch.tensor(bins), torch.tensor(w), 11, u=u,
                             stratified=mode == "stratified")
    _close(out_t, out_j, rtol=1e-5, atol=1e-4)


def test_hierarchical_z_vals_matches_startrax():
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(2.0, 6.0, size=(5, 16)).astype(np.float32), axis=-1)
    w = rng.uniform(size=(5, 16)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    zu_j, zs_j = jsamp.hierarchical_z_vals(key, jnp.asarray(z), jnp.asarray(w), 16, det=False)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (5, 16))))
    zu_t, zs_t = tsamp.hierarchical_z_vals(torch.tensor(z), torch.tensor(w), 16, u=u)
    _close(zs_t, zs_j, rtol=1e-5, atol=1e-4)
    _close(zu_t, zu_j, rtol=1e-5, atol=1e-4)


def _alphas(rng, R=6, K=2, S=12):
    a_s = rng.uniform(0.0, 1.0, size=(R, S)).astype(np.float32)
    a_d = rng.uniform(0.0, 1.0, size=(R, K, S)).astype(np.float32)
    s_s = rng.uniform(0.0, 2.0, size=(R, S)).astype(np.float32)
    s_d = rng.uniform(0.0, 2.0, size=(R, K, S)).astype(np.float32)
    return a_s, a_d, s_s, s_d


REG_CASES = {
    "alpha_entropy": lambda m, a_s, a_d, s_s, s_d: m.alpha_entropy(a_s, a_d),
    "dynamic_vs_static_reg": lambda m, a_s, a_d, s_s, s_d: m.dynamic_vs_static_reg(a_s, a_d),
    "ray_reg": lambda m, a_s, a_d, s_s, s_d: m.ray_reg(s_d, s_s + s_d.sum(1)),
    "static_reg": lambda m, a_s, a_d, s_s, s_d: m.static_reg(s_s, a_s),
    "dynamic_reg": lambda m, a_s, a_d, s_s, s_d: m.dynamic_reg(s_d),
}


@pytest.mark.parametrize("name", sorted(REG_CASES))
def test_regularizers_match_startrax(name):
    arrays = _alphas(np.random.default_rng(7))
    fn = REG_CASES[name]
    _close(fn(treg, *map(torch.tensor, arrays)), fn(jreg, *map(jnp.asarray, arrays)))


def _raw(rng, R=5, K=2, S=12):
    z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)).astype(np.float32), axis=-1)
    return dict(
        raw_alpha_static=rng.normal(size=(R, S)).astype(np.float32),
        raw_rgb_static=rng.normal(size=(R, S, 3)).astype(np.float32),
        raw_alpha_dynamic=rng.normal(size=(R, K, S)).astype(np.float32),
        raw_rgb_dynamic=rng.normal(size=(R, K, S, 3)).astype(np.float32),
        z_vals=z, rays_d=rng.normal(size=(R, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_matches_startrax(white_bkgd):
    r = _raw(np.random.default_rng(8))
    noise = np.random.default_rng(9).normal(size=r["z_vals"].shape).astype(np.float32)
    args = ("raw_alpha_static", "raw_rgb_static", "z_vals", "rays_d")
    out_t = tcomp.raw2outputs(*(torch.tensor(r[k]) for k in args), noise=torch.tensor(noise),
                              white_bkgd=white_bkgd)
    out_j = jcomp.raw2outputs(*(jnp.asarray(r[k]) for k in args), noise=jnp.asarray(noise),
                              white_bkgd=white_bkgd)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k])


@pytest.mark.parametrize("reference_numerics", [False, True])
def test_raw2outputs_star_matches_startrax(reference_numerics):
    r = _raw(np.random.default_rng(10))
    kw = dict(with_test_outputs=True, reference_numerics=reference_numerics)
    out_t = tcomp.raw2outputs_star(**{k: torch.tensor(v) for k, v in r.items()}, **kw)
    out_j = jcomp.raw2outputs_star(**{k: jnp.asarray(v) for k, v in r.items()}, **kw)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k])


def test_raw2outputs_star_grads_match_startrax():
    """Gradient of a mix of outputs wrt the raw field values (the path every
    parameter and pose gradient takes)."""
    r = _raw(np.random.default_rng(11))
    raw_keys = ("raw_alpha_static", "raw_rgb_static", "raw_alpha_dynamic", "raw_rgb_dynamic")

    def loss(mod, out):
        return (mod.sum(out["rgb"] ** 2) + mod.sum(out["depth"]) + out["loss_alpha_entropy"]
                + out["loss_ray_reg"] + out["loss_dynamic_vs_static_reg"])

    tin = {k: torch.tensor(v, requires_grad=k in raw_keys) for k, v in r.items()}
    g_t = torch.autograd.grad(loss(torch, tcomp.raw2outputs_star(**tin)),
                              [tin[k] for k in raw_keys])
    g_j = jax.grad(lambda raws: loss(jnp, jcomp.raw2outputs_star(
        **raws, z_vals=jnp.asarray(r["z_vals"]), rays_d=jnp.asarray(r["rays_d"]))))(
        {k: jnp.asarray(r[k]) for k in raw_keys})
    for a, k in zip(g_t, raw_keys):
        _close(a, g_j[k], rtol=1e-4, atol=1e-5)


def test_losses_match_startrax():
    rng = np.random.default_rng(12)
    pred, target = rng.uniform(size=(2, 8, 3)).astype(np.float32)
    _close(tloss.img2mse(torch.tensor(pred), torch.tensor(target)),
           jloss.img2mse(jnp.asarray(pred), jnp.asarray(target)))
    _close(tloss.mse2psnr(torch.tensor(0.013)), jloss.mse2psnr(jnp.float32(0.013)))
    depth = rng.uniform(1.0, 9.0, size=8).astype(np.float32)
    gt = rng.uniform(1.0, 9.0, size=8).astype(np.float32)
    gt[0] = 0.0
    _close(tloss.depth_loss(torch.tensor(depth), torch.tensor(gt), 2.0, 8.0),
           jloss.depth_loss(jnp.asarray(depth), jnp.asarray(gt), 2.0, 8.0))


@pytest.mark.parametrize("max_dist", [0.0, 5e9])
def test_sigma_loss_matches_startrax(max_dist):
    """max_dist > 0 masks the far_dist sentinel on each ray's last sample."""
    rng = np.random.default_rng(13)
    w = rng.uniform(size=(6, 10)).astype(np.float32)
    w[0, :3] = 0.0
    z = np.sort(rng.uniform(2.0, 8.0, size=(6, 10)).astype(np.float32), axis=-1)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((6, 1), 1e10, np.float32)], -1)
    gt = rng.uniform(2.5, 7.5, size=6).astype(np.float32)
    args = (w, z, dists, gt)
    out_t = tloss.sigma_loss(*map(torch.tensor, args), 2.0, 8.0, max_dist=max_dist)
    out_j = jloss.sigma_loss(*map(jnp.asarray, args), 2.0, 8.0, max_dist=max_dist)
    _close(out_t, out_j)


def test_config_adapter_matches_startrax():
    """The port's adapter maps the flagship config as the JAX package does,
    and parses use_fused strictly."""
    from startrax.utils import config as jcfg
    from startrax_torch.utils import config as tcfg

    path = os.path.join(REPO, "startrax", "configs", "carla_star_online_multi.txt")
    cfg = jcfg.Config(**jcfg.parse_config_file(path))
    sc_t, sc_j = tcfg.star_config_from(cfg), jcfg.star_config_from(cfg)
    for field in ("num_vehicles", "netdepth", "netwidth", "n_samples", "n_importance",
                  "near", "far", "far_dist", "perturb", "end_barf", "stratified_fine"):
        assert getattr(sc_t, field) == getattr(sc_j, field), field
    assert sc_t.compute_dtype == torch.bfloat16
    lc_t, lc_j = tcfg.loss_config_from(cfg), jcfg.loss_config_from(cfg)
    assert vars(lc_t) == vars(lc_j)
    assert tcfg.parse_bool("0") is False and tcfg.parse_bool("true") is True
    assert tcfg.parse_bool(None) is None
    with pytest.raises(ValueError):
        tcfg.parse_bool("maybe")


def test_port_imports_no_jax():
    """Importing the port (kernels included) leaves jax out of sys.modules."""
    code = ("import sys, startrax_torch, startrax_torch.kernels.fused_mlp, "
            "startrax_torch.models.star, startrax_torch.train.loop, startrax_torch.convert, "
            "startrax_torch.utils.config; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
