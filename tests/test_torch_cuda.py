"""The fused-MLP CUDA kernels against their plain PyTorch version, on the card;
and the card's side of the host modules: the synthetic scene's marcher
against its numpy version, a checkpoint round trip, the app's generator,
FusedGroupAdam on the card's leaves against its formula bit for bit
(adam_matches_its_formula, which tests/test_torch_train.py runs on CPU
leaves).

These tests need an NVIDIA GPU (sm_90a) and nvcc, and skip without a card.
They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(``--noconftest`` leaves out tests/conftest.py, which sets up JAX.) The
shapes are small fields of the flagship's and the scaled synthetic config's
widths, 4 x 256 and 4 x 128, on 3000 points per field, so the last point
tile is ragged; the field-axis cases stack K = 2 fields whose inputs come
from a per-ray pose leaf [R, K, 7] (50 rays of 60 samples) through
warp_to_vehicle_frames; the edge cases add depths 1 and 8, and 1, 63, 64
and 3,000 points. The
comparison and its limits are startrax_torch.kernels.parity's, the same that
chip_smoke.py applies at the step's shapes: forward within 1e-2 (max) and
1.5e-3 (rms) of the output's scale, weight grads within 2e-3 of each grad's
largest magnitude, the pose grad within 1.5e-2 of its largest component,
the input grads within 0.3 of their largest components (single-point
outliers) and 2e-2 in rms, the per-ray pose grads within 1e-2 in rms.
"""

import dataclasses
import json
import os

import pytest
import torch

from startrax_torch import convert
from startrax_torch.apps.common import host_prng
from startrax_torch.data.synthetic import SyntheticScene
from startrax_torch.kernels import fused_mlp as tfused
from startrax_torch.kernels import parity
from startrax_torch.models import fields as tfields
from startrax_torch.models.star import StarConfig, init_star, pack_warp, warp_to_vehicle_frames
from startrax_torch.ops.encoding import barf_weights
from startrax_torch.train import checkpoint as ckpt
from startrax_torch.train import optim
from startrax_torch.utils.tree import tree_leaves, tree_map

N = 3000
PE = (10, 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(seed, width=256, depth=4, n=N):
    cfg = tfields.FieldConfig(depth=depth, width=width)
    g = torch.Generator().manual_seed(seed)
    params = tfields.init_field(cfg, g, device="cpu")
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    x = torch.randn(n, 3, generator=g).cuda()
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1).cuda()
    return cfg, params, x, d


def _unit_pose(device):
    """A 7-vector pose leaf (translation, unit quaternion) with grad."""
    pose = torch.tensor([0.1, -0.2, 0.05, 0.1, 0.2, -0.1, 0.97], device=device)
    pose = pose / torch.cat([torch.ones(3, device=device), pose[3:].norm().expand(4)])
    return pose.requires_grad_(True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["static", "warped", "masked", "warped_input_grads"])
def test_fused_kernels_match_plain(card, mode):
    cfg, params, x, d = _setup(seed=6)
    if mode == "warped_input_grads":  # per-point dx, dd; the pose grad from them
        x.requires_grad_(True)
        d.requires_grad_(True)
    pose = _unit_pose(card)
    warp = pack_warp(pose) if mode != "static" else None
    masks = None
    if mode == "masked":
        masks = tuple(tfused.pe_mask_row(barf_weights(37, 100, f, device=card), f) for f in PE)

    tfused.reset_launch_counts()
    errs, _ = parity.compare(params, x, d, cfg.n_blocks, PE, pe_masks=masks, warp=warp,
                             pose=pose if warp is not None else None)
    assert tfused.launches == dict.fromkeys(tfused.launches, 0) | {"fwd": 1, "bwd": 1}
    assert ("pose" in errs) == (warp is not None)
    assert ("input" in errs) == (mode == "warped_input_grads")
    assert not parity.failures(errs), errs


def _stacked_setup(width, seed, n_rays=50, n_samples=60, depth=4):
    cfg = tfields.FieldConfig(depth=depth, width=width)
    g = torch.Generator().manual_seed(seed)
    params = tfields.init_stacked_fields(cfg, 2, g, device="cpu")
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    pts = torch.randn(n_rays, n_samples, 3, generator=g).cuda()
    dirs = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g), dim=-1).cuda()
    q = torch.nn.functional.normalize(torch.randn(n_rays, 2, 4, generator=g), dim=-1)
    pose = torch.cat([0.1 * torch.randn(n_rays, 2, 3, generator=g), q], -1).cuda()
    pose.requires_grad_(True)
    pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, pts, dirs)
    n = n_rays * n_samples
    x = pts_dyn.reshape(2, n, 3).contiguous()
    d = dirs_dyn[:, :, None, :].expand(2, n_rays, n_samples, 3).reshape(2, n, 3).contiguous()
    return cfg, params, x, d, pose


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_field_axis_kernels_match_plain(card, width, masked):
    cfg, params, x, d, pose = _stacked_setup(width, seed=7)
    masks = None
    if masked:  # BARF at step 5 of 12
        masks = tuple(tfused.pe_mask_row(barf_weights(5, 12, f, device=card), f) for f in PE)
    tfused.reset_launch_counts()
    errs, _ = parity.compare(params, x, d, cfg.n_blocks, PE, pe_masks=masks, pose=pose,
                             stacked=True)
    assert tfused.launches == dict.fromkeys(tfused.launches, 0) | {"stacked_fwd": 1,
                                                                    "stacked_bwd": 1}
    assert {"input", "input_rms", "ray_pose"} <= set(errs)
    assert not parity.failures(errs), errs


@pytest.mark.cuda
def test_field_axis_input_grads_without_weight_grads(card):
    """Frozen weights (the gauge step): the backward skips the weight-grad
    GEMMs and gives the same dx, dd, bit for bit."""
    cfg, params, x, d, pose = _stacked_setup(128, seed=8)
    frozen = tree_map(torch.Tensor.detach, params)
    grads = []
    for p in (params, frozen):
        a, r = tfused.fused_stacked_apply(p, x, d, cfg.n_blocks, PE)
        grads.append(torch.autograd.grad(a.sum() + (r ** 2).sum(), pose, retain_graph=True))
    assert torch.equal(grads[0][0], grads[1][0])
    assert bool(grads[0][0].abs().sum() > 0)


def _enc_setup(width, seed, dims, depth=4, n=N):
    """One field on pre-encoded features: `dims` point dimensions encoded
    (21 columns each) and the 27 direction columns, n points."""
    from startrax_torch.ops.encoding import positional_encoding

    cfg = tfields.FieldConfig(depth=depth, width=width, input_dims=dims)
    g = torch.Generator().manual_seed(seed)
    params = tfields.init_field(cfg, g, device="cpu")
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    x = positional_encoding(torch.randn(n, dims, generator=g), PE[0]).cuda()
    d = positional_encoding(torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1),
                            PE[1]).cuda()
    return cfg, params, x, d


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("in_ch", [84, 63])
@pytest.mark.parametrize("input_grads", [False, True], ids=["weights", "input_grads"])
def test_pre_encoded_kernels_match_plain(card, width, in_ch, input_grads):
    """The pre-encoded mode (nerf_time's 84 = 4 x 21 point columns, or 63)
    with 27 direction columns, on 3,000 ragged points: one launch of each
    kernel, the "enc_" counters only, within parity.ENC_LIMITS."""
    cfg, params, x, d = _enc_setup(width, 9, in_ch // 21)
    assert x.shape == (N, in_ch) and d.shape == (N, 27)
    x.requires_grad_(input_grads)
    d.requires_grad_(input_grads)
    tfused.reset_launch_counts()
    errs, _ = parity.compare(params, x, d, cfg.n_blocks)
    assert tfused.launches == dict.fromkeys(tfused.launches, 0) | {"enc_fwd": 1, "enc_bwd": 1}
    assert errs["encoded"] and ("input" in errs) == input_grads
    assert not parity.failures(errs), errs


def _stacked_enc_setup(width, seed, K=2, depth=4, n=N):
    """K time-conditioned fields (84 encoded point columns, 27 direction
    columns) on n points a field (3,000 ragged ones by default), as
    parity.compare takes them."""
    from startrax_torch.ops.encoding import positional_encoding

    cfg = tfields.FieldConfig(depth=depth, width=width, input_dims=4)
    g = torch.Generator().manual_seed(seed)
    params = tfields.init_stacked_fields(cfg, K, g, device="cpu")
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    x = positional_encoding(torch.randn(K, n, 4, generator=g), PE[0]).cuda()
    d = positional_encoding(torch.nn.functional.normalize(torch.randn(K, n, 3, generator=g),
                                                          dim=-1), PE[1]).cuda()
    return cfg, params, x, d


def _assert_fields_are_the_per_field_kernel(cfg, params, x, d, run, input_grads):
    """Each field of a field-axis pre-encoded run: its outputs, dx_emb,
    dd_emb and weight grads bit for bit those of the per-field pre-encoded
    launch on that field's inputs."""
    g_k = torch.autograd.grad(run["out_k"], run["leaves"], run["cot"], retain_graph=True)
    for k in range(x.shape[0]):
        one = tree_map(lambda t: t[k].detach().requires_grad_(True), params)
        xk = x[k].detach().requires_grad_(input_grads)
        dk = d[k].detach().requires_grad_(input_grads)
        a, r = tfused.fused_field_apply(one, xk, dk, cfg.n_blocks)
        out = torch.cat([a[..., None], r], -1)
        assert torch.equal(out, run["out_k"][k].detach())
        leaves = list(tfused.flatten_params(one, cfg.n_blocks)) + ([xk, dk] if input_grads else [])
        g_one = torch.autograd.grad(out, leaves, run["cot"][k])  # in compare's leaf order
        assert all(torch.equal(u[k], v) for u, v in zip(g_k, g_one))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("input_grads", [False, True], ids=["weights", "input_grads"])
def test_stacked_pre_encoded_kernels_match_plain(card, width, input_grads):
    """The field-axis launch on pre-encoded features (fused_stacked_apply
    with pe=None, K = 2) on 3,000 ragged points a field: one launch of each
    kernel, the "stacked_enc_" counters only; each field's outputs, dx_emb,
    dd_emb and weight grads bit for bit those of the per-field pre-encoded
    launch on that field's inputs; the forward and the input grads against
    the plain version within parity.ENC_LIMITS.

    The weight grads are held to the plain version through a float32
    reference: their largest error against the plain version run in
    float32 within 1.5 times the bf16 plain version's own. ENC_LIMITS' w
    (2e-3, kernel against bf16 plain) does not bound bf16 rounding at
    3,000 points on a 4x256 field: here the per-field pre-encoded kernel
    reads 5.2e-3 from the bf16 plain version while both read 1.4e-2 from
    float32 (H100, scripts/torch_enc_w_reading.py). At the path's shapes
    chip_smoke.py phase 3e holds the same launches to ENC_LIMITS."""
    cfg, params, x, d = _stacked_enc_setup(width, seed=10)
    x.requires_grad_(input_grads)
    d.requires_grad_(input_grads)
    tfused.reset_launch_counts()
    errs, run = parity.compare(params, x, d, cfg.n_blocks, stacked=True)
    assert tfused.launches == dict.fromkeys(tfused.launches, 0) | {"stacked_enc_fwd": 1,
                                                                    "stacked_enc_bwd": 1}
    assert errs["encoded"] and errs["finite"] and ("input" in errs) == input_grads
    bad = [k for k in parity.failures(errs) if k != "w"]
    assert not bad, errs

    weights = tfused.flatten_params(params, cfg.n_blocks)
    n_w = len(weights)
    g_k = torch.autograd.grad(run["out_k"], run["leaves"], run["cot"], retain_graph=True)
    g_b = torch.autograd.grad(run["out_p"], weights, run["cot"], retain_graph=True)
    out_f = tfused.fused_stacked_plain(x, d, weights, cfg.n_blocks, compute_dtype=torch.float32)
    g_f = torch.autograd.grad(out_f, weights, run["cot"])

    def worst(gs):
        return max(float((u[k] - f[k]).abs().max() / f[k].abs().max())
                   for k in range(2) for u, f in zip(gs, g_f))

    assert worst(g_k[:n_w]) <= 1.5 * worst(g_b), (worst(g_k[:n_w]), worst(g_b))
    _assert_fields_are_the_per_field_kernel(cfg, params, x, d, run, input_grads)


@pytest.mark.cuda
def test_stacked_pre_encoded_one_field_is_the_per_field_kernel(card):
    """K = 1 through fused_stacked_apply(pe=None) runs the per-field
    pre-encoded instance: the same outputs and grads as fused_field_apply,
    bit for bit."""
    cfg, params, x, d = _stacked_enc_setup(256, seed=11, K=1)
    x.requires_grad_(True)
    d.requires_grad_(True)
    one = tree_map(lambda t: t[0].detach().requires_grad_(True), params)
    a1, r1 = tfused.fused_stacked_apply(params, x, d, cfg.n_blocks)
    a2, r2 = tfused.fused_field_apply(one, x[0], d[0], cfg.n_blocks)
    assert torch.equal(a1[0], a2) and torch.equal(r1[0], r2)
    g1 = torch.autograd.grad(a1.sum() + (r1 ** 2).sum(), tree_leaves(params) + [x, d])
    g2 = torch.autograd.grad(a2.sum() + (r2 ** 2).sum(), tree_leaves(one) + [x, d])
    n_w = len(tree_leaves(params))
    assert all(torch.equal(u[0], v) for u, v in zip(g1[:n_w], g2[:n_w]))
    assert all(torch.equal(u, v) for u, v in zip(g1[n_w:], g2[n_w:]))


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [1, 2])
@pytest.mark.parametrize("n_out", [64, 128, 256])
@pytest.mark.parametrize("k_in", [64, 96, 128, 256])
def test_weight_gradient_gemm_and_sums_match_plain(card, k_in, n_out, fields):
    """wgrad_kernel on `fields` fields of 3,000 ragged points, one grouped
    launch over two layers of this shape (relu on the first one's X, not on
    the second's) and a 64 x 128 one, then sum_rows_kernel over the splits
    and over random per-CTA partials, each against its plain version: f32
    sums of exact bf16 products in another order, within 1e-4 and 1e-5 of
    the largest magnitude (chip_smoke.PART_TOL)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(k_in, True, n_out), (k_in, False, n_out), (64, False, 128)]

    def bf(cols):
        return torch.randn((fields, N, cols), generator=g, device="cuda").to(torch.bfloat16)

    xs, dys, relus = [bf(k) for k, _, _ in shapes], [bf(m) for _, _, m in shapes], [True, False, False]
    lay = tfused.wgrad_layout(shapes, N, fields)
    tfused.reset_launch_counts()
    got = tfused.wgrad(xs, dys, relus)
    want = tfused.wgrad_grouped_plain(xs, dys, relus, lay["splits"])
    assert got.shape == (fields, lay["splits"], lay["wtotal"])
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    part = torch.randn((fields, 47, 2576), generator=g, device="cuda")
    for src in (got, part):
        sums = tfused.sum_rows(src)
        want_sums = tfused.sum_rows_plain(src)
        assert sums.shape == (fields, src.shape[2])
        assert float((sums - want_sums).abs().max()) <= 1e-5 * float(want_sums.abs().max())
    assert tfused.part_launches == {"wgrad": 1, "sum_rows": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["one_field", "field_axis", "warped"])
def test_backward_weight_grads_are_bitwise_reproducible(card, mode, monkeypatch):
    """Two backward calls on the same inputs give the same weight and bias
    grads (and, with a warp, the same pose grad), bit for bit, and the same
    per-CTA partials that the backward kernel writes (the bias grads' column
    sums, dW_a, dW_r, the pose sums): the GEMM's split partials, the sums'
    chunks and the kernel's reductions are added in an order fixed by the
    shapes alone."""
    parts = []
    sum_rows = tfused.sum_rows

    def spy(src):
        parts.append(src.clone())
        return sum_rows(src)

    monkeypatch.setattr(tfused, "sum_rows", spy)
    pose = None
    if mode == "field_axis":
        cfg, params, x, d, _ = _stacked_setup(256, seed=10, n_rays=200, n_samples=64)
        out = tfused.fused_stacked_apply(params, x, d, cfg.n_blocks, PE)
    else:
        cfg, params, x, d = _setup(seed=10)
        if mode == "warped":
            pose = _unit_pose(card)
        out = tfused.fused_field_apply(params, x, d, cfg.n_blocks, PE,
                                       warp=pack_warp(pose) if pose is not None else None)
    loss = torch.sin(out[0]).sum() + (out[1] ** 2).sum()
    leaves = list(tfused.flatten_params(params, cfg.n_blocks)) + ([pose] if pose is not None else [])
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    n_parts = len(parts)
    second = torch.autograd.grad(loss, leaves)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(bool(a.abs().sum() > 0) for a in first)
    assert n_parts == 2 and len(parts) == 4  # each call: the CTAs' partials, the GEMM's splits
    assert all(torch.equal(a, b) for a, b in zip(parts[:2], parts[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_backward_encodings_match_plain_bitwise(card, masked, monkeypatch):
    """The encodings that the backward kernel writes for the weight-gradient
    GEMM (x_emb, d_emb: bf16 [N, 64]) are, bit for bit, the plain version's
    positional encoding of the warped points, times the BARF masks, rounded
    to bf16 and zero-padded: one sincosf a (frequency, dim) gives both
    columns as sinf and cosf give them (the forward encodes with the same
    function)."""
    from startrax_torch.ops.encoding import positional_encoding

    cfg, params, x, d = _setup(seed=12)
    warp = pack_warp(_unit_pose(card)).detach()
    masks = None
    if masked:
        masks = tuple(tfused.pe_mask_row(barf_weights(37, 100, f, device=card), f) for f in PE)
    seen = {}
    wgrad = tfused.wgrad

    def spy(xs, dys, relus):
        seen["xe"], seen["de"] = xs[0].clone(), xs[-1].clone()
        return wgrad(xs, dys, relus)

    monkeypatch.setattr(tfused, "wgrad", spy)
    a, r = tfused.fused_field_apply(params, x, d, cfg.n_blocks, PE, pe_masks=masks, warp=warp)
    torch.autograd.grad(a.sum() + (r ** 2).sum(), list(tfused.flatten_params(params, cfg.n_blocks)))
    views = (tfused.warp_points(x, warp, True), tfused.warp_points(d, warp, False))
    for i, (name, v) in enumerate(zip(("xe", "de"), views)):
        enc = positional_encoding(v, PE[i])
        if masks is not None:
            enc = enc * masks[i][:enc.shape[-1]]
        want = torch.zeros((N, tfused.EW), device=card)
        want[:, :enc.shape[-1]] = enc
        assert seen[name].shape == (1, N, tfused.EW)
        assert torch.equal(seen[name][0], want.to(torch.bfloat16)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 3000])
@pytest.mark.parametrize("depth", [1, 8], ids=["no_blocks", "flagship_depth"])
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("instance", ["per_field", "field_axis", "pre_encoded",
                                      "field_axis_pre_encoded"])
def test_kernels_match_plain_at_the_epilogues_edges(card, instance, width, depth, n):
    """Kernel against plain where the epilogues change shape: no residual
    block (depth 1: lin_in's bias reaches h_last directly) and the
    flagship's 4 blocks (depth 8); widths 128 and 256; one point, a partial
    tile, one whole tile and a ragged end. Per-field raw points with a warp,
    BARF masks and the pose sums; the field axis (K = 2) on points made from
    per-ray poses, with input grads; pre-encoded features with input grads,
    per field and on the field axis; each field of the last bit for bit the
    per-field pre-encoded launch on its inputs.

    Without blocks every reading is held to parity's limits (the field-axis
    pre-encoded weight grads by the per-field launch, as in
    test_stacked_pre_encoded_kernels_match_plain). At the flagship's depth
    parity's limits, set on 4-layer fields, do not bound the bf16 rounding of
    kernel and plain version against each other on small tiles (kernels
    that pass every other test exceed them in 8 of these 32 cases on an
    H100), so each group of readings is held through a float32 reference
    instead: the kernel no further from the plain version run in float32
    than 1.5 times the bf16 plain version's own distance
    (_assert_as_close_to_f32)."""
    seed = 30 + n % 7
    kw = {}
    if instance == "per_field":
        cfg, params, x, d = _setup(seed, width, depth, n)
        kw["pose"] = _unit_pose(card)
        kw.update(pe=PE, warp=pack_warp(kw["pose"]),
                  pe_masks=tuple(tfused.pe_mask_row(barf_weights(37, 100, f, device=card), f)
                                 for f in PE))
        counters = {"fwd": 1, "bwd": 1}

        def plain_f32(w):
            return tfused.fused_mlp_plain(x, d, w, cfg.n_blocks, PE, warp=kw["warp"],
                                          masks=kw["pe_masks"], compute_dtype=torch.float32)
    elif instance == "field_axis":
        cfg, params, x, d, kw["pose"] = _stacked_setup(width, seed, n_rays=n, n_samples=1,
                                                       depth=depth)
        kw.update(pe=PE, stacked=True)
        counters = {"stacked_fwd": 1, "stacked_bwd": 1}

        def plain_f32(w):
            return tfused.fused_stacked_plain(x, d, w, cfg.n_blocks, PE,
                                              compute_dtype=torch.float32)
    elif instance == "pre_encoded":
        cfg, params, x, d = _enc_setup(width, seed, 4, depth, n)
        counters = {"enc_fwd": 1, "enc_bwd": 1}

        def plain_f32(w):
            return tfused.fused_mlp_plain(x, d, w, cfg.n_blocks, compute_dtype=torch.float32)
    else:
        cfg, params, x, d = _stacked_enc_setup(width, seed, depth=depth, n=n)
        kw["stacked"] = True
        counters = {"stacked_enc_fwd": 1, "stacked_enc_bwd": 1}

        def plain_f32(w):
            return tfused.fused_stacked_plain(x, d, w, cfg.n_blocks, compute_dtype=torch.float32)
    if instance != "per_field":
        x.requires_grad_(True)
        d.requires_grad_(True)
    assert cfg.n_blocks == depth // 2
    tfused.reset_launch_counts()
    errs, run = parity.compare(params, x, d, cfg.n_blocks, **kw)
    assert tfused.launches == dict.fromkeys(tfused.launches, 0) | counters
    assert ("pose" in errs) == (instance == "per_field")
    assert ("input" in errs) == (instance != "per_field")
    if instance == "field_axis_pre_encoded":
        _assert_fields_are_the_per_field_kernel(cfg, params, x, d, run, True)
    if cfg.n_blocks:
        weights = tfused.flatten_params(params, cfg.n_blocks)
        _assert_as_close_to_f32(run, plain_f32(weights), len(weights))
        assert errs["finite"], errs
    else:
        bad = parity.failures(errs)
        if instance == "field_axis_pre_encoded":
            bad = [k for k in bad if k != "w"]
        assert not bad, errs


# The GEMM core's cases: every instance at the flagship depth (4 blocks),
# both widths, one point, a partial tile, one tile, a ragged second tile,
# a ragged third tile and a ragged end (47 tiles a field), trained (saved
# activations, a backward) or forward only.
CORE_INSTANCES = ("static", "warped", "field_axis", "pre_encoded", "field_axis_pre_encoded")
CORE_N = (1, 63, 64, 65, 129, 3000)
CORE_DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                            "fused_mlp_core_digests.json")
# The occupancy grid's update: the 8x256 field's forward, nothing saved, on
# one point a cell of a 128^3 grid along (0, 0, -1) (32,768 point tiles).
UPDATE_N = 128 ** 3
UPDATE_KEY = f"grid update 256 n={UPDATE_N} no_save"


def core_case_key(instance, width, n, save):
    return f"{instance} {width} n={n} {'train' if save else 'no_save'}"


def core_case(instance, width, n, save):
    """One forward (and with save, one backward) call of the fused kernels
    at 8 layers: {"out": [the outputs], "weights": [the weight and bias
    grads], "inputs": [the pose grad and the points' and directions' grads
    where the instance has them]}, of the cotangent parity.compare uses.
    The instances, each with its own weight stream: "static" (one field, raw
    points, no warp: no narrow GEMMs in the backward), "warped" (a warp,
    BARF masks, the pose sums), "field_axis" (K = 2 fields on points made
    from per-ray poses, input grads), "pre_encoded" (84 point columns: a
    three-chunk lin_in, input grads) and "field_axis_pre_encoded". Without
    save, the forward runs under no_grad and saves nothing."""
    seed = 40 + n % 7
    kw, extra = {"pe": PE}, []
    if instance in ("static", "warped"):
        cfg, params, x, d = _setup(seed, width, 8, n)
        if instance == "warped":
            pose = _unit_pose(torch.device("cuda"))
            kw.update(warp=pack_warp(pose), pe_masks=tuple(
                tfused.pe_mask_row(barf_weights(37, 100, f, device="cuda"), f) for f in PE))
            extra = [pose]
    elif instance == "field_axis":
        cfg, params, x, d, pose = _stacked_setup(width, seed, n_rays=n, n_samples=1, depth=8)
        kw["stacked"], extra = True, [x, d, pose]
    else:
        kw = {"pe": None}
        if instance == "pre_encoded":
            cfg, params, x, d = _enc_setup(width, seed, 4, 8, n)
        else:
            cfg, params, x, d = _stacked_enc_setup(width, seed, depth=8, n=n)
            kw["stacked"] = True
        extra = [x.requires_grad_(True), d.requires_grad_(True)]
    stacked = kw.pop("stacked", False)
    apply = tfused.fused_stacked_apply if stacked else tfused.fused_field_apply

    def run():
        a, r = apply(params, x, d, cfg.n_blocks, **kw)
        return torch.cat([a[..., None], r], -1)

    if not save:
        with torch.no_grad():
            return {"out": [run()]}
    out = run()
    weights = list(tfused.flatten_params(params, cfg.n_blocks))
    cot = torch.cat([torch.cos(out[..., :1]), 2.0 * out[..., 1:]], -1).detach()
    g = torch.autograd.grad(out, weights + extra, cot)
    return {"out": [out.detach()], "weights": list(g[:len(weights)]),
            "inputs": list(g[len(weights):])}


def update_case():
    """The grid update's forward (UPDATE_KEY): {"out": [the outputs]}."""
    cfg, params, x, d = _setup(47, 256, 8, UPDATE_N)
    d = torch.tensor([0.0, 0.0, -1.0], device="cuda").expand(UPDATE_N, 3).contiguous()
    with torch.no_grad():
        a, r = tfused.fused_field_apply(params, x, d, cfg.n_blocks, PE)
    return {"out": [torch.cat([a[..., None], r], -1)]}


def core_digests(instance, width, n, save):
    """core_case's tensors -> a sha256 of each group's bytes (with each
    tensor's dtype and shape)."""
    return digests(core_case(instance, width, n, save))


def digests(case):
    """{group: [tensors]} -> a sha256 of each group's bytes (with each
    tensor's dtype and shape)."""
    import hashlib

    out = {}
    for name, tensors in case.items():
        h = hashlib.sha256()
        for t in tensors:
            t = t.detach().contiguous().cpu()
            h.update(f"{t.dtype} {tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        out[name] = h.hexdigest()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("save", [True, False], ids=["train", "no_save"])
@pytest.mark.parametrize("n", CORE_N)
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("instance", CORE_INSTANCES)
def test_gemm_core_matches_the_parent_kernel_bit_for_bit(card, instance, width, n, save):
    """The GEMM core that reads A from shared memory (128-byte-swizzled
    operand tiles, relu applied in the epilogues, each ring slot refilled by
    the producer warp once every consumer warp has released it, the saved
    rows stored by tensor copies) against the kernels before it, bit for
    bit: the outputs, the weight grads and the pose or input grads of
    core_case, as sha256 digests recorded by scripts/torch_kernel_digests.py
    from the parent source on an H100 (the JSON file names the tree and the
    card). The cases stream every segment chunk
    count the kernels have: 2 (lin_in on raw points, the views layer's
    direction segment, and at width 128 the backward's W / 2 GEMMs), 3
    (lin_in on 84 pre-encoded columns), 4 (W / 2 at width 256, W at 128), 8
    (W at 256) and the views layer's two segments; the three-slot ring wraps
    at every GEMM boundary. A tile read through a relu holds bf16(relu(v)) =
    relu(bf16(v)), so the products are those of the kernels with A in
    registers (ff3b3ee), whose digests the cases before n = 129 read too;
    every digest was recorded again from 6878a1e. The forward without
    saving gives the same outputs as with."""
    with open(CORE_DIGESTS) as fp:
        want = json.load(fp)["cases"]
    got = core_digests(instance, width, n, save)
    assert got == want[core_case_key(instance, width, n, save)]
    if not save:
        assert got["out"] == want[core_case_key(instance, width, n, True)]["out"]


@pytest.mark.cuda
def test_grid_update_forward_matches_the_parent_kernel_bit_for_bit(card):
    """The occupancy grid update's forward at its size (2,097,152 points,
    nothing saved, 32,768 point tiles) against the parent's digest of the
    same call, recorded with the GEMM core's cases."""
    with open(CORE_DIGESTS) as fp:
        want = json.load(fp)["cases"][UPDATE_KEY]
    tfused.reset_launch_counts()
    assert digests(update_case()) == want
    assert tfused.launches["fwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("instance", CORE_INSTANCES)
def test_gemm_core_is_bitwise_reproducible(card, instance, width):
    """Two calls of core_case on the same 3,000 ragged points a field give
    the same outputs, weight grads and pose (the kernel's pose sums) or
    input grads, bit for bit: the ring's order of chunks and every
    reduction's order are fixed by the shapes alone."""
    first, second = (core_case(instance, width, N, True) for _ in range(2))
    for name in first:
        assert all(torch.equal(a, b) for a, b in zip(first[name], second[name])), name
    assert all(bool(g.abs().sum() > 0) for g in first["weights"] + first["inputs"])


def _assert_as_close_to_f32(run, out_f, n_w):
    """parity.compare's run against out_f, the plain version run in float32
    on the same leaves: for the outputs, the weight grads and the other
    grads (inputs, pose), the kernel's largest distance from float32 (the
    largest over the group's tensors of max |u - f| / max |f|) within 1.5
    times the bf16 plain version's."""
    leaves, cot = run["leaves"], run["cot"]
    g_k = torch.autograd.grad(run["out_k"], leaves, cot, retain_graph=True)
    g_b = torch.autograd.grad(run["out_p"], leaves, cot, retain_graph=True)
    g_f = torch.autograd.grad(out_f, leaves, cot)

    def dist(us, fs):
        return max(float((u - f).abs().max() / (f.abs().max() + 1e-12)) for u, f in zip(us, fs))

    groups = {"out": ([run["out_k"].detach()], [run["out_p"].detach()], [out_f.detach()]),
              "weights": (g_k[:n_w], g_b[:n_w], g_f[:n_w]),
              "inputs_or_pose": (g_k[n_w:], g_b[n_w:], g_f[n_w:])}
    for name, (k, b, f) in groups.items():
        if k:
            assert dist(k, f) <= 1.5 * dist(b, f), (name, dist(k, f), dist(b, f))


@pytest.mark.cuda
def test_scene_marcher_on_the_card_matches_numpy(card):
    """The ground-truth marcher on the card against its numpy version on one
    48x48 frame with two vehicles, with the CPU test's bounds (rgb 2e-5,
    depth 2e-4, masks agreeing on more than 99.9% of the pixels)."""
    s = SyntheticScene(num_vehicles=2, num_frames=4, H=48, W=48, focal=48.0, n_march=64)
    got = s.render_frame(1, 5, 2)
    want = s._render_frame_numpy(1, 5, 2)
    assert abs(got[0] - want[0]).max() <= 2e-5
    assert abs(got[1] - want[1]).max() <= 2e-4
    assert (got[2] == want[2]).mean() > 0.999 and got[2].any()


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    cfg = StarConfig(num_vehicles=2, netdepth=2, netdepth_fine=2, netwidth=16, netwidth_fine=16,
                     n_samples=4, n_importance=4)
    params = init_star(cfg, torch.Generator(device="cuda").manual_seed(0))
    ckpt.save_checkpoint(str(tmp_path), {"params": params, "step": 3}, step=3)
    got = ckpt.restore_checkpoint(str(tmp_path))
    assert got["step"] == 3
    pairs = list(zip(tree_leaves(got["params"]), tree_leaves(params)))
    assert all(a.device.type == "cuda" and torch.equal(a, b) for a, b in pairs)


def _adam_by_formula(leaves, group_ids, schedules, grads, grad_clip, accumulate_steps,
                     b1=0.9, b2=0.999, eps=1e-8):
    """FusedGroupAdam's update written out, its learning rates a tensor
    made from the schedules' floats on the leaves' device: the leaves
    after each step, and the final moments."""
    device = leaves[0].device
    params = [p.detach().clone() for p in leaves]
    group = torch.cat([torch.full((p.numel(),), g, dtype=torch.long, device=device)
                       for p, g in zip(params, group_ids)])
    m = torch.zeros(group.numel(), device=device)
    v, acc = torch.zeros_like(m), torch.zeros_like(m)
    count = mini = 0
    history = []
    for step_grads in grads:
        g = torch.cat([x.reshape(-1) for x in step_grads])
        if accumulate_steps > 1:
            acc.add_((g - acc) / (mini + 1))
            mini += 1
            if mini < accumulate_steps:
                history.append([p.clone() for p in params])
                continue
            g = acc.clone()
            acc.zero_()
            mini = 0
        if grad_clip is not None:
            gnorm = torch.sqrt(torch.sum(g * g))
            g = g * torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        lrs = torch.tensor([s(count) for s in schedules], dtype=torch.float32, device=device)
        count += 1
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        update = -lrs[group] * (m / (1 - b1 ** count)) / (torch.sqrt(v / (1 - b2 ** count)) + eps)
        start = 0
        for p in params:
            p.add_(update[start:start + p.numel()].view_as(p))
            start += p.numel()
        history.append([p.clone() for p in params])
    return history, m, v


def adam_matches_its_formula(device, groups, accumulate_steps, steps=6):
    """FusedGroupAdam over leaves on ``device`` in ``groups`` learning-rate
    groups (a milestone halves each rate after the first update; the clip
    on with three groups) gives, step by step, leaves and moments equal bit
    for bit to _adam_by_formula's."""
    gen = torch.Generator().manual_seed(31)
    shapes = [(3, 4), (5,), (2, 2, 7)]
    leaves = [torch.randn(s, generator=gen).to(device) for s in shapes]
    group_ids = [min(i, groups - 1) for i in range(len(shapes))]
    schedules = [optim.make_schedule(lr, decay_milestones=[1])
                 for lr in (1e-2, 3e-2, 5e-3)[:groups]]
    grad_clip = 1.0 if groups > 1 else None
    grads = [[torch.randn(s, generator=gen).to(device) for s in shapes] for _ in range(steps)]
    want, m, v = _adam_by_formula(leaves, group_ids, schedules, grads, grad_clip,
                                  accumulate_steps)
    opt = optim.FusedGroupAdam(leaves, group_ids, schedules, grad_clip=grad_clip,
                               accumulate_steps=accumulate_steps)
    for step_grads, expected in zip(grads, want):
        for p, g in zip(leaves, step_grads):
            p.grad = g
        opt.step()
        assert all(torch.equal(a, b) for a, b in zip(leaves, expected))
    assert opt.count == steps // accumulate_steps
    assert torch.equal(opt.m, m) and torch.equal(opt.v, v)


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate_steps", [1, 3])
@pytest.mark.parametrize("groups", [1, 3])
def test_fused_group_adam_on_the_card_matches_its_formula(card, groups, accumulate_steps):
    adam_matches_its_formula(card, groups, accumulate_steps)


@pytest.mark.cuda
def test_host_prng_generator_is_on_the_card(card):
    _, gen = host_prng(5)
    assert gen.device.type == "cuda" and gen.initial_seed() == 5
    assert torch.rand(3, generator=gen, device="cuda").device.type == "cuda"


@pytest.mark.cuda
def test_field_queries_on_the_card_match_plain(card):
    """query_density and query_rgb through the fused forward (one launch
    each, nothing saved under no_grad) against the plain path, within
    parity.LIMITS' forward limits."""
    cfg, params, x, _ = _setup(20)
    plain = dataclasses.replace(cfg, use_fused=False)
    before = dict(tfused.launches)
    with torch.no_grad():
        dk, rk = tfields.query_density(params, cfg, x), tfields.query_rgb(params, cfg, x)
        dp, rp = tfields.query_density(params, plain, x), tfields.query_rgb(params, plain, x)
    assert tfused.launches["fwd"] - before["fwd"] == 2
    for a, b in ((dk, dp), (rk, rp)):
        assert float((a - b).abs().max() / b.abs().max()) <= parity.LIMITS["fwd"]
        assert float((a - b).norm() / b.norm()) <= parity.LIMITS["fwd_rms"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_ray"])
def test_online_step_over_two_ranks_on_the_card(card, layout):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device) against the one-process step, kernel path, 4 x 256 fields, 64
    rays x (32 + 32) samples: the loss within 1e-5 relative before the
    first update, the ranks' parameters equal after every step, each rank's
    launches the one-process step's."""
    import numpy as np

    from startrax_torch.parallel import dryrun, mesh
    from startrax_torch.train import loop

    cfg = StarConfig(num_vehicles=2, netdepth=4, netdepth_fine=4, netwidth=256,
                     netwidth_fine=256, n_samples=32, n_importance=32, near=2.0, far=6.0)
    params = convert.params_to_numpy(loop.init_online_params(
        cfg, 4, torch.Generator().manual_seed(21), "cpu"))
    rng = np.random.default_rng(22)
    n = 64
    d = rng.normal(size=(n, 3)).astype(np.float32)
    batch = {"rays_o": rng.normal(size=(n, 3)).astype(np.float32),
             "rays_d": d / np.linalg.norm(d, axis=-1, keepdims=True),
             "target": rng.uniform(size=(n, 3)).astype(np.float32),
             "target_depth": np.where(np.arange(n) % 3 == 0, 4.0, 0.0).astype(np.float32),
             "frame": np.int32(2) if layout == "shared" else rng.integers(0, 4, n).astype(
                 np.int32)}
    spec = {"kind": "online", "star_cfg": cfg, "params": params, "batches": [batch] * 4,
            "loss_cfg": loop.LossConfig(use_depth_loss=True, depth_lambda=0.1),
            "opt": dict(lrate_static=5e-4, lrate_dynamic=5e-4, lrate_pose=5e-4,
                        grad_clip=1.0, accumulate_steps=2), "seed": 23, "device": "cuda"}
    one = dryrun.replay(None, spec)
    two = mesh.run_ranks(dryrun.replay, 2, "gloo", args=(spec,), device="cuda:0",
                         timeout=120.0, join_timeout=600.0)
    for out in two:
        np.testing.assert_allclose(out["losses"][:2], one["losses"][:2], rtol=1e-5)
        assert out["spread"] == [0.0] * 4
        assert out["launches"] == one["launches"]
