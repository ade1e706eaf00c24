"""Parity of the port's fields and fused-MLP module with startrax on the CPU.

Weights come from one JAX init (perturbed so that fc1 is nonzero and every
path carries gradient) and cross through startrax_torch.convert; inputs are
numpy arrays from a seed. Two comparisons:

- float32: the port's plain field body against startrax's XLA
  ``apply_field``. Forward within 1e-5, gradients within 1e-4 of each
  gradient's largest magnitude (2e-4 and 2e-3 with a warp, see the test).
- bf16: the port's fused-MLP wrapper on CPU tensors (the kernels' plain
  version) against startrax's Pallas kernel in interpret mode. Both round
  matmul operands to bf16 with f32 accumulation, in different orders, so a
  value near a bf16 rounding boundary may round the other way: forward
  within 1e-2 and gradients within 2e-2 of the largest magnitude (the JAX
  kernel tests' own bound, tests/test_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from startrax.kernels import fused_mlp as jfused
from startrax.models import fields as jfields
from startrax.ops import encoding as jenc
from startrax.ops import lie as jlie
from startrax_torch import convert
from startrax_torch.kernels import fused_mlp as tfused
from startrax_torch.models import fields as tfields
from startrax_torch.models.star import pack_warp
from startrax_torch.ops.encoding import barf_weights as tbarf_weights
from startrax_torch.utils.tree import tree_leaves, tree_map

JCFG = jfields.FieldConfig(depth=4, width=32, compute_dtype=jnp.float32, use_fused=False)
TCFG = tfields.FieldConfig(depth=4, width=32, compute_dtype=torch.float32, use_fused=False)
MODES = ["static", "warped", "masked"]


def _setup(seed, n_rays=4, n_samples=16):
    params = jfields.init_field(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), params)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_rays, n_samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    q = rng.normal(size=4).astype(np.float32)
    pose = np.concatenate([0.3 * rng.normal(size=3), q / np.linalg.norm(q)]).astype(np.float32)
    return jax.tree.map(np.asarray, params), pts, dirs, pose


def _jax_warp(pose):
    M = jlie.quat_to_matrix(pose[3:7])
    return jnp.concatenate([M.reshape(9), pose[:3], jnp.zeros(4, jnp.float32)])


def _loss(mod, a, r):
    return mod.sum(mod.sin(a)) + mod.sum(r ** 2)


def _assert_scaled(t_leaves, j_leaves, atol):
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        a, b = a.detach().numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)


@pytest.mark.parametrize("mode", MODES)
def test_field_f32_matches_xla(mode):
    params_np, pts, dirs, pose = _setup(seed=0)
    step = 37.0 if mode == "masked" else None
    jcfg = dataclasses.replace(JCFG, end_barf=100) if mode == "masked" else JCFG
    tcfg = dataclasses.replace(TCFG, end_barf=100) if mode == "masked" else TCFG
    warped = mode == "warped"

    def jloss(p, pose):
        warp = _jax_warp(pose) if warped else None
        a, r = jfields.apply_field(p, jcfg, jnp.asarray(pts), jnp.asarray(dirs), step=step,
                                   warp=warp)
        return _loss(jnp, a, r), (a, r)

    (lj, (aj, rj)), (gpj, gposej) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pose))

    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpose = torch.tensor(pose, requires_grad=True)
    a, r = tfields.apply_field(tp, tcfg, torch.tensor(pts), torch.tensor(dirs), step=step,
                               warp=pack_warp(tpose) if warped else None)
    # warped: the two 3-term products M p + t may differ by an ulp (FMA), and
    # the top encoding frequency 2^9 scales that to ~5e-5 in sin/cos
    tol = 2e-4 if warped else 1e-5
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(aj), rtol=1e-5, atol=tol)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(rj), rtol=1e-5, atol=tol)
    leaves = tree_leaves(tp) + ([tpose] if warped else [])
    grads = torch.autograd.grad(_loss(torch, a, r), leaves)
    j_leaves = jax.tree.leaves(gpj) + ([gposej] if warped else [])
    _assert_scaled(grads, j_leaves, atol=10 * tol)


@pytest.mark.parametrize("mode", MODES)
def test_fused_plain_bf16_matches_pallas_interpret(mode):
    params_np, pts, dirs, pose = _setup(seed=1, n_rays=8)
    x = pts.reshape(-1, 3)
    d = np.broadcast_to(dirs[:, None, :], pts.shape).reshape(-1, 3).copy()
    pe = (JCFG.multires, JCFG.multires_views)
    warped, masked = mode == "warped", mode == "masked"
    step, end_barf = 37.0, 100
    j_masks = t_masks = None
    if masked:
        j_masks = tuple(jfused.pe_mask_row(jenc.barf_weights(step, end_barf, f), f) for f in pe)
        t_masks = tuple(tfused.pe_mask_row(tbarf_weights(step, end_barf, f), f) for f in pe)

    def jloss(p, pose):
        a, r = jfused.fused_field_apply(
            p, jnp.asarray(x), jnp.asarray(d), JCFG.n_blocks, tile=32, interpret=True, pe=pe,
            pe_masks=j_masks, warp=_jax_warp(pose) if warped else None, input_grads=False)
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), (gpj, gposej) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pose))

    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpose = torch.tensor(pose, requires_grad=True)
    a, r = tfused.fused_field_apply(tp, torch.tensor(x), torch.tensor(d), JCFG.n_blocks, pe,
                                    pe_masks=t_masks, warp=pack_warp(tpose) if warped else None)
    scale = max(np.abs(np.asarray(aj)).max(), np.abs(np.asarray(rj)).max())
    np.testing.assert_allclose(a.detach().numpy() / scale, np.asarray(aj) / scale, atol=1e-2)
    np.testing.assert_allclose(r.detach().numpy() / scale, np.asarray(rj) / scale, atol=1e-2)
    leaves = tree_leaves(tp) + ([tpose] if warped else [])
    grads = torch.autograd.grad(_loss(torch, a, r), leaves)
    _assert_scaled(grads, jax.tree.leaves(gpj) + ([gposej] if warped else []), atol=2e-2)


def test_fused_plain_matches_plain_field_body_in_f32_layout():
    """The field's plain bf16 path and its fused path on CPU tensors run the
    same plain version (same weights, same encoding layout, same rounding)."""
    params_np, pts, dirs, _ = _setup(seed=2)
    tp = convert.params_from_numpy(params_np, device="cpu")
    cfg = dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)
    a0, r0 = tfields.apply_field(tp, cfg, torch.tensor(pts), torch.tensor(dirs))
    a1, r1 = tfields.apply_field(tp, dataclasses.replace(cfg, use_fused=True),
                                 torch.tensor(pts), torch.tensor(dirs))
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), atol=1e-5)
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), atol=1e-5)


def test_fused_wrapper_on_cpu_runs_plain_version():
    """A CPU tensor takes the plain version and counts no kernel launch, one
    field or a stack of them."""
    params_np, pts, dirs, _ = _setup(seed=2)
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    weights = tfused.flatten_params(tp, JCFG.n_blocks)
    x = torch.tensor(pts.reshape(-1, 3))
    d = torch.tensor(np.broadcast_to(dirs[:, None, :], pts.shape).reshape(-1, 3).copy())
    pe = (JCFG.multires, JCFG.multires_views)
    tfused.reset_launch_counts()
    a, r = tfused.fused_field_apply(tp, x, d, JCFG.n_blocks, pe)
    torch.autograd.grad(a.sum() + r.sum(), weights)
    stack = tree_map(lambda t: torch.stack([t, 2.0 * t]), tp)
    sa, sr = tfused.fused_stacked_apply(stack, torch.stack([x, -x]), torch.stack([d, d]),
                                        JCFG.n_blocks, pe)
    torch.autograd.grad(sa.sum() + sr.sum(), tfused.flatten_params(stack, JCFG.n_blocks))
    assert set(tfused.launches.values()) == {0}
    out = tfused.fused_mlp_plain(x, d, weights, JCFG.n_blocks, pe)
    assert torch.equal(torch.cat([a[:, None], r], -1), out)
    assert torch.equal(torch.cat([sa[0, :, None], sr[0]], -1), out)


def test_stacked_fields_match_startrax():
    jstack = jfields.init_stacked_fields(jax.random.PRNGKey(3), JCFG, 2)
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 3, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(2, 3, 3)).astype(np.float32)
    aj, rj = jfields.apply_stacked_fields(jstack, JCFG, jnp.asarray(pts), jnp.asarray(dirs))
    tstack = convert.params_from_numpy(jax.tree.map(np.asarray, jstack), device="cpu")
    at, rt = tfields.apply_stacked_fields(tstack, TCFG, torch.tensor(pts), torch.tensor(dirs))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)


def _stacked_setup(seed, n_points):
    jstack = jfields.init_stacked_fields(jax.random.PRNGKey(seed), JCFG, 2)
    jstack = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), jstack)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n_points, 3)).astype(np.float32)
    d = rng.normal(size=(2, n_points, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jax.tree.map(np.asarray, jstack), x, d


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_stacked_plain_bf16_matches_pallas_interpret(masked):
    """The stacked wrapper on CPU tensors (the field-axis kernel's plain
    version) against the Pallas kernels in interpret mode, in bf16: the
    stacked pair unmasked, K calls of the input_grads=True kernel with a BARF
    mask. Forward, weight grads and input grads, at the bf16 bounds of the
    module docstring; 100 points per field, so the tile of 32 is ragged."""
    params_np, x, d = _stacked_setup(seed=11, n_points=100)
    pe = (JCFG.multires, JCFG.multires_views)
    step, end_barf = 5.0, 12
    j_masks = t_masks = None
    if masked:
        j_masks = tuple(jfused.pe_mask_row(jenc.barf_weights(step, end_barf, f), f) for f in pe)
        t_masks = tuple(tfused.pe_mask_row(tbarf_weights(step, end_barf, f), f) for f in pe)

    def jloss(p, xx, dd):
        if masked:
            outs = [jfused.fused_field_apply(jax.tree.map(lambda t, k=k: t[k], p), xx[k], dd[k],
                                             JCFG.n_blocks, tile=32, interpret=True, pe=pe,
                                             pe_masks=j_masks, input_grads=True)
                    for k in range(2)]
            a, r = jnp.stack([o[0] for o in outs]), jnp.stack([o[1] for o in outs])
        else:
            a, r = jfused.fused_stacked_apply(p, xx, dd, JCFG.n_blocks, tile=32, interpret=True,
                                              pe=pe)
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x), jnp.asarray(d))

    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tx, td = torch.tensor(x, requires_grad=True), torch.tensor(d, requires_grad=True)
    a, r = tfused.fused_stacked_apply(tp, tx, td, JCFG.n_blocks, pe, pe_masks=t_masks)
    assert a.shape == (2, 100) and r.shape == (2, 100, 3)
    scale = max(np.abs(np.asarray(aj)).max(), np.abs(np.asarray(rj)).max())
    np.testing.assert_allclose(a.detach().numpy() / scale, np.asarray(aj) / scale, atol=1e-2)
    np.testing.assert_allclose(r.detach().numpy() / scale, np.asarray(rj) / scale, atol=1e-2)
    grads = torch.autograd.grad(_loss(torch, a, r), tree_leaves(tp) + [tx, td])
    _assert_scaled(grads, jax.tree.leaves(gj[0]) + [gj[1], gj[2]], atol=2e-2)


@pytest.mark.parametrize("barf", [False, True], ids=["plain", "barf"])
def test_apply_stacked_fields_grads_match_startrax(barf):
    """apply_stacked_fields in f32 against startrax's (XLA, vmapped) on
    per-field inputs, with BARF at step 5 of 12 or without: outputs within
    1e-5, grads of the params, points and directions within 1e-4 of each
    grad's largest magnitude."""
    params_np, x, d = _stacked_setup(seed=12, n_points=24)
    pts, dirs = x.reshape(2, 3, 8, 3), d[:, :3]
    jcfg = dataclasses.replace(JCFG, end_barf=12) if barf else JCFG
    tcfg = dataclasses.replace(TCFG, end_barf=12) if barf else TCFG
    step = 5.0 if barf else None

    def jloss(p, pp, dd):
        a, r = jfields.apply_stacked_fields(p, jcfg, pp, dd, step=step)
        return _loss(jnp, a, r), (a, r)

    (_, (aj, rj)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pts), jnp.asarray(dirs))
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    tpts, tdirs = torch.tensor(pts, requires_grad=True), torch.tensor(dirs, requires_grad=True)
    a, r = tfields.apply_stacked_fields(tp, tcfg, tpts, tdirs, step=step)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(_loss(torch, a, r), tree_leaves(tp) + [tpts, tdirs])
    _assert_scaled(grads, jax.tree.leaves(gj[0]) + [gj[1], gj[2]], atol=1e-4)


def test_init_field_shapes_match_startrax():
    jp = jfields.init_field(jax.random.PRNGKey(4), JCFG)
    tp = tfields.init_field(TCFG, torch.Generator().manual_seed(4), device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(tp)] == [x.shape for x in jax.tree.leaves(jp)]
    assert all(float(b["fc1"]["w"].abs().max()) == 0.0 for b in tp["blocks"])


def test_convert_round_trip():
    from startrax.models.star import init_star

    from __graft_entry__ import _flagship_cfg

    jp = jax.tree.map(np.asarray, {"nerf": init_star(jax.random.PRNGKey(5),
                                                     _flagship_cfg(tiny=True)),
                                   "poses": np.asarray(jlie.se3_identity(3, 2))})
    tp = convert.params_from_numpy(jp, device="cpu")
    assert tp["nerf"]["dynamic_fine"]["lin_in"]["w"].shape == (2, 63, 32)
    assert tp["poses"].shape == (3, 2, 7)
    back = convert.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_parity_check_reads_zero_on_cpu_and_flags_a_planted_fault(monkeypatch):
    """parity.compare on CPU tensors holds the plain version against itself
    (every reading 0), and flags a wrapper whose weight grads miss 2% of
    the points."""
    from startrax_torch.kernels import parity

    params_np, pts, dirs, pose = _setup(seed=3, n_rays=8)
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    x = torch.tensor(pts.reshape(-1, 3))
    d = torch.tensor(np.broadcast_to(dirs[:, None, :], pts.shape).reshape(-1, 3).copy())
    pe = (JCFG.multires, JCFG.multires_views)
    tpose = torch.tensor(pose, requires_grad=True)
    errs, _ = parity.compare(tp, x, d, JCFG.n_blocks, pe, warp=pack_warp(tpose), pose=tpose)
    assert parity.failures(errs) == []
    assert all(errs[k] == 0.0 for k in ("fwd", "fwd_rms", "w", "pose"))

    def drops_points(params, x, d, *args, **kw):
        a, r = tfused.fused_field_apply(params, x, d, *args, **kw)
        keep = torch.arange(x.shape[0]) >= x.shape[0] // 50
        return torch.where(keep, a, a.detach()), torch.where(keep[:, None], r, r.detach())

    monkeypatch.setattr(parity, "fused_field_apply", drops_points)
    errs, _ = parity.compare(tp, x, d, JCFG.n_blocks, pe)
    assert "w" in parity.failures(errs) and errs["fwd"] == 0.0


def test_parity_check_stacked_reads_zero_on_cpu_and_flags_a_planted_fault(monkeypatch):
    """parity.compare on a stack of two fields whose inputs come from a
    per-ray pose leaf [R, K, 7] through warp_to_vehicle_frames: on CPU
    tensors every reading is 0, and a wrapper that leaves dd at zero fails
    the input measure."""
    from startrax_torch.kernels import parity
    from startrax_torch.models.star import warp_to_vehicle_frames

    params_np, x, d = _stacked_setup(seed=13, n_points=8)
    tp = convert.params_from_numpy(params_np, device="cpu", requires_grad=True)
    rng = np.random.default_rng(13)
    q = rng.normal(size=(4, 2, 4))
    pose = np.concatenate([0.3 * rng.normal(size=(4, 2, 3)),
                           q / np.linalg.norm(q, axis=-1, keepdims=True)], -1)
    tpose = torch.tensor(pose.astype(np.float32), requires_grad=True)
    pts_dyn, dirs_dyn = warp_to_vehicle_frames(tpose, torch.tensor(x[0].reshape(4, 2, 3)),
                                               torch.tensor(d[0, :4]))
    xs = pts_dyn.reshape(2, 8, 3)
    ds = dirs_dyn[:, :, None, :].expand(2, 4, 2, 3).reshape(2, 8, 3)
    pe = (JCFG.multires, JCFG.multires_views)
    errs, _ = parity.compare(tp, xs, ds, JCFG.n_blocks, pe, pose=tpose, stacked=True)
    assert parity.failures(errs) == []
    assert all(errs[k] == 0.0 for k in ("fwd", "fwd_rms", "w", "input", "input_rms", "ray_pose"))

    def zero_dd(params, x, d, *args, **kw):
        return tfused.fused_stacked_apply(params, x, d.detach() + 0.0 * d, *args, **kw)

    monkeypatch.setattr(parity, "fused_stacked_apply", zero_dd)
    errs, _ = parity.compare(tp, xs, ds, JCFG.n_blocks, pe, pose=tpose, stacked=True)
    assert "input" in parity.failures(errs) and errs["w"] == 0.0 and errs["fwd"] == 0.0
