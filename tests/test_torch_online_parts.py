"""The online app's parts, on the CPU: test() against startrax's, resume,
the warm start, the refusals (data parallelism, an unknown polish_mode, the
video and LPIPS), selection, the optimizer state round trip,
the gradient-isolation diagnostic and the synthetic adapter's interface.

test(): both packages' test protocol (startrax/apps/test_protocol.py and
its port) on one parameter tree (random fields from a seed, the scene's
noisy GT poses), saved once in each package's checkpoint format, on a
24x24 scene with K = 2. Measured: PSNR (per frame and per view) to 3.9e-5
dB, SSIM to 2.0e-5, the 2D IoU to 1.7e-3 (one pixel of a frame whose
dynamic transmittance sits at the 0.1 threshold), RPE, ATE and 3D IoU
equal. Tolerances, ten times those: 4e-4 dB, 2e-4, 1.8e-2, and 1e-6 for the
pose metrics. The pose files are byte-equal. selection_score: both
packages' scores of one tree agree to 1.5e-7 relative (photometric) and
8.9e-8 (photometric_depth); tolerance 1.5e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from startrax.apps import online as japp
from startrax.data.synthetic import SyntheticAdapter as JAdapter
from startrax.data.synthetic import SyntheticScene as JScene
from startrax.train import checkpoint as jckpt
from startrax.train import loop as jloop
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import common as tcommon
from startrax_torch.apps import online as tapp
from startrax_torch.data.synthetic import SyntheticAdapter as TAdapter
from startrax_torch.data.synthetic import SyntheticScene as TScene
from startrax_torch.models.star import StarConfig, init_star, render_star
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import loop as tloop
from startrax_torch.train import optim as toptim
from startrax_torch.train.diagnostics import check_batch_gradient_isolation
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.tree import tree_leaves
from test_torch_online import (BASE, _configs, _fresh_scene_memo,  # noqa: F401
                               _one_torch_thread, _rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test(): the tolerance of each kind of test/* row (module docstring)
TEST_TOL = (("psnr", 4e-4), ("ssim", 2e-4), ("2d_iou", 1.8e-2), ("", 1e-6))
# tests/test_apps.py's resume config (test_online_polish_substate_resumes)
RESUME = dict(epochs_online=6, steps_per_epoch=4, num_vehicles=1, polish_epochs=50,
              polish_mode="alternate", alt_field_epochs=2, alt_pose_epochs=2,
              alt_plateau_window=100, epoch_val=2)


def _tree(jcfg, poses=None):
    """A numpy parameter tree from a seed; its poses replaced when given."""
    tree = jax.tree.map(np.asarray, jloop.init_online_params(
        jax.random.PRNGKey(0), jconfig.star_config_from(jcfg), jcfg.num_frames))
    if poses is not None:
        tree["poses"] = np.asarray(poses, np.float32)
    return tree


def _noisy_poses(cfg):
    data = tcommon.make_dataset(cfg, "train", "cpu")
    noisy = data.noisy_gt_relative_poses(np.random.default_rng(0))  # [K, F, 7]
    return np.swapaxes(noisy, 0, 1)[1:]


def test_test_protocol_matches_startrax(tmp_path):
    jcfg, tcfg = _configs(tmp_path)
    tree = _tree(jcfg, _noisy_poses(tcfg))
    jpath, tpath = str(tmp_path / "jckpt"), str(tmp_path / "tckpt")
    jckpt.save_checkpoint(jpath, {"params": tree}, step=3)
    tckpt.save_checkpoint(tpath, {"params": convert.params_from_numpy(tree, device="cpu")},
                          step=3)
    jcfg, _ = _configs(tmp_path, test=True, online_ckpt_path=jpath)
    _, tcfg = _configs(tmp_path, test=True, online_ckpt_path=tpath)
    japp.test(jcfg)
    tapp.test(tcfg, device="cpu")

    jdir, tdir = (tmp_path / p / "smoke" / "online_test" for p in ("jax", "torch"))
    jrows, trows = _rows(str(jdir)), _rows(str(tdir))
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    keys = set().union(*map(set, trows))
    for k in ("test/view0_frame_psnr", "test/view0_frame_psnr_dynamic", "test/view0_frame_2d_iou",
              "test/rpe_trans_1", "test/ate_1", "test/3d_iou_1", "test/view1_ssim_static"):
        assert k in keys, k
    for t, j in zip(trows, jrows):
        for k in j:
            if k.startswith("test/"):
                tol = next(v for part, v in TEST_TOL if part in k)
                assert abs(t[k] - j[k]) <= tol, (k, t[k], j[k])
    ates = [r[f"test/ate_{k}"] for r in trows for k in (0, 1) if f"test/ate_{k}" in r]
    assert len(ates) == 2 and max(ates) < 0.4  # the frame-0 entry is the GT pose
    for k in (0, 1):
        name = f"poses_vehicle{k}.txt"
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    assert sorted(os.listdir(tdir / "images")) == sorted(os.listdir(jdir / "images"))


@pytest.mark.parametrize("selection", ["photometric", "photometric_depth"])
def test_selection_score_matches_startrax(tmp_path, selection):
    jcfg, tcfg = _configs(tmp_path, selection=selection, selection_stride=2)
    tree = _tree(jcfg, _noisy_poses(tcfg))
    jval = japp.make_dataset(jcfg, "val")
    tval = tcommon.make_dataset(tcfg, "val", "cpu")
    jstar = jconfig.star_config_from(jcfg)
    tstar = tconfig.star_config_from(tcfg)
    j = japp.selection_score(jcfg, jstar, jax.tree.map(jax.numpy.asarray, tree), jval,
                             jcfg.num_frames)
    t = tapp.selection_score(tcfg, tstar, convert.params_from_numpy(tree, device="cpu"), tval,
                             tcfg.num_frames, device="cpu")
    assert np.isfinite(t) and abs(t - j) <= 1.5e-6 * abs(j)


@pytest.mark.parametrize("losses, window, tol", [
    ([1.0, 0.9, 0.8, 0.79], 2, 0.03), ([1.0, 0.99, 0.99, 0.985], 2, 0.03), ([1.0], 1, 0.03),
    ([0.5, 0.4, 0.3, 0.2, 0.2, 0.2], 3, 0.1)])
def test_loss_plateau_matches_startrax(losses, window, tol):
    assert tapp._loss_plateau(losses, window, tol) == japp._loss_plateau(losses, window, tol)


@pytest.mark.parametrize("frames, start, n", [(0, 0, 15), (4, 0, 15), (3, 1, 8), (10, 0, 5)])
def test_score_frames_match_startrax(frames, start, n):
    assert (tapp._score_frames(tconfig.Config(selection_frames=frames), start, n)
            == japp._score_frames(jconfig.Config(selection_frames=frames), start, n))


def test_online_resumes_mid_polish(tmp_path):
    """As tests/test_apps.py checks startrax's: the polish sub-state and the
    best-epoch snapshot survive a restart, and the resumed epochs continue
    the alternation. The saved params and every optimizer state load
    bitwise into a fresh app's leaves and buffers."""
    _, cfg = _configs(tmp_path, **RESUME)
    tapp.train(cfg, device="cpu")
    run_dir = tmp_path / "torch" / "smoke" / "online"
    h1 = json.loads((run_dir / "history.json").read_text())
    assert [h["phase"] for h in h1] == ["joint", "joint", "polish_field", "polish_field",
                                        "polish_pose", "polish_pose"]
    assert sorted(os.listdir(run_dir / "ckpts")) == ["1", "3", "5", "6"]
    best_epoch = min((h for h in h1 if "score" in h), key=lambda h: h["score"])["epoch"]
    assert max(int(d) for d in os.listdir(run_dir / "ckpts_best")) == best_epoch

    # what a resume loads: the saved state into fresh leaves and buffers
    saved = tckpt.restore_checkpoint(str(run_dir / "ckpts"), step=5, device="cpu")
    assert saved["polish"]["polish_used"] == 4 and saved["polish"]["best_epoch"] == best_epoch
    assert {"opt_state", "opt_state_polish", "opt_state_field"} <= set(saved)
    star_cfg = tconfig.star_config_from(cfg)
    params = tloop.init_online_params(star_cfg, cfg.num_frames, torch.Generator(), "cpu")
    live = tree_leaves(params)
    tckpt.copy_into(params, saved["params"])
    assert all(a is b and a.requires_grad for a, b in zip(tree_leaves(params), live))
    assert all(torch.equal(a, b) for a, b in zip(live, tree_leaves(saved["params"])))
    for name in ("opt_state", "opt_state_polish", "opt_state_field"):
        opt = toptim.make_fused_star_optimizer(params, 1e-4, 5e-4, 5e-4, steps_per_epoch=4)
        buffers = (opt.m, opt.v)
        opt.load_state_dict(saved[name])
        assert opt.m is buffers[0] and opt.v is buffers[1]
        for k in ("m", "v", "count", "mini_step"):
            assert torch.equal(torch.as_tensor(getattr(opt, k)),
                               torch.as_tensor(saved[name][k])), (name, k)

    cfg2 = tconfig.Config(**{**cfg.__dict__, "online_ckpt_path": str(run_dir / "ckpts"),
                             "epochs_online": 10})
    tapp.train(cfg2, device="cpu")
    log = (run_dir / "run.log").read_text()
    assert "resumed online training at epoch 7" in log  # the final checkpoint, step 6
    assert "resumed polish sub-state: used=4 alt=field/1" in log
    assert f"restored best-epoch snapshot (epoch {best_epoch}" in log
    h2 = json.loads((run_dir / "history.json").read_text())
    assert [h["epoch"] for h in h2] == [7, 8, 9]
    assert [h["phase"] for h in h2] == ["polish_field", "polish_field", "polish_pose"]


def test_warm_start_trains_the_static_fields(tmp_path):
    """appearance_ckpt_path copies an appearance checkpoint's static fields
    into the online leaves: every leaf still requires grad and is the one
    the optimizers hold, and one optimizer step changes the static
    weights."""
    _, cfg = _configs(tmp_path, N_rand=64, noisy_pose_init=True)
    star_cfg = tconfig.star_config_from(cfg)
    app = init_star(star_cfg, torch.Generator().manual_seed(5), "cpu")
    path = str(tmp_path / "app_ckpts")
    tckpt.save_checkpoint(path, {"params": app}, step=2)
    cfg = tconfig.Config(**{**cfg.__dict__, "appearance_ckpt_path": path})
    train_data = tcommon.make_dataset(cfg, "train", "cpu")
    rng, gen = tcommon.host_prng(cfg.seed, "cpu")
    params = tapp._init_params(cfg, star_cfg, gen, "cpu", train_data, rng)
    assert all(leaf.requires_grad and leaf.is_leaf for leaf in tree_leaves(params))
    for k in ("static_coarse", "static_fine"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params["nerf"][k]),
                                                     tree_leaves(app[k])))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params["nerf"]["dynamic_coarse"]), tree_leaves(app["dynamic_coarse"])))
    noisy = np.swapaxes(train_data.noisy_gt_relative_poses(np.random.default_rng(cfg.seed)),
                        0, 1)[1:]
    assert torch.equal(params["poses"].detach(), torch.from_numpy(noisy))

    opt = toptim.make_fused_star_optimizer(params, cfg.lrate_static, cfg.lrate_dynamic,
                                           cfg.lrate_pose)
    step = tloop.make_online_train_step(star_cfg, tconfig.loss_config_from(cfg), opt)
    before = [t.detach().clone() for t in tree_leaves(params["nerf"]["static_coarse"])]
    batch = train_data.sample_batch(np.random.default_rng(1), cfg.N_rand, 0, 5)
    step(params, tapp._place_batch(batch, "cpu"), generator=gen)
    after = tree_leaves(params["nerf"]["static_coarse"])
    trained = [(a, b) for a, b in zip(before, after)
               if b.grad is not None and bool(b.grad.abs().max() > 0)]
    assert len(trained) >= len(after) // 2
    assert all(not torch.equal(a, b) for a, b in trained)


@pytest.mark.parametrize("accumulate, steps", [(1, 3), (4, 6)], ids=["plain", "mid_accumulation"])
def test_optimizer_state_round_trip_is_bitwise(tmp_path, accumulate, steps):
    """A FusedGroupAdam saved after `steps` steps (with accumulation 4, two
    mini-steps into the second update) and loaded into a fresh optimizer
    over copies of the leaves takes the next steps bitwise as the original
    does."""
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(5, 3, generator=gen).requires_grad_(True),
              torch.randn(4, generator=gen).requires_grad_(True)]
    grads = [[torch.randn(p.shape, generator=gen) for p in leaves] for _ in range(steps + 4)]

    def make(ls):
        return toptim.FusedGroupAdam(ls, [0, 1], [lambda c: 1e-2 * 0.9 ** c, lambda c: 5e-3],
                                     grad_clip=1.0, accumulate_steps=accumulate)

    def run(opt, ls, gs):
        for g in gs:
            for p, gi in zip(ls, g):
                p.grad = gi.clone()
            opt.step()

    opt = make(leaves)
    run(opt, leaves, grads[:steps])
    assert opt.mini_step == (steps % accumulate if accumulate > 1 else 0)
    tckpt.save_checkpoint(str(tmp_path), {"opt": opt.state_dict(), "leaves": leaves}, step=0)
    saved = tckpt.restore_checkpoint(str(tmp_path), device="cpu")
    copies = [t.clone().requires_grad_(True) for t in saved["leaves"]]
    fresh = make(copies)
    fresh.load_state_dict(saved["opt"])
    run(opt, leaves, grads[steps:])
    run(fresh, copies, grads[steps:])
    assert all(torch.equal(a, b) for a, b in zip(leaves, copies))
    assert torch.equal(opt.m, fresh.m) and torch.equal(opt.v, fresh.v)
    assert (opt.count, opt.mini_step) == (fresh.count, fresh.mini_step)
    with pytest.raises(ValueError, match="accumulation"):
        toptim.FusedGroupAdam(copies, [0, 1], [lambda c: 0.0] * 2,
                              accumulate_steps=1 if accumulate > 1 else 2).load_state_dict(saved["opt"])


def _online_cfg(tmp_path, **kw):
    return tconfig.Config(**{**BASE, "basedir": str(tmp_path), "epochs_online": 1,
                             "steps_per_epoch": 1, **kw})


@pytest.mark.parametrize("entry, kw, err, match", [
    ("train", dict(data_parallel="on"), RuntimeError, "only one device is visible"),
    ("test", dict(data_parallel="on"), RuntimeError, "only one device is visible"),
    ("train", dict(data_parallel="sideways"), ValueError, "auto/on/off"),
    ("train", dict(polish_epochs=2, polish_mode="sideways"), ValueError, "polish_mode"),
    ("test", dict(lpips_weights="EXISTING"), NotImplementedError, "LPIPS"),
], ids=["data_parallel_train", "data_parallel_test", "data_parallel_value", "polish_mode_value",
        "lpips"])
def test_online_refuses_before_making_a_run_dir(tmp_path, entry, kw, err, match):
    if kw.get("lpips_weights") == "EXISTING":
        weights = tmp_path / "vgg.pth"
        weights.write_bytes(b"weights")
        kw = dict(kw, lpips_weights=str(weights))
    base = tmp_path / "runs"
    cfg = _online_cfg(base, test=entry == "test", **kw)
    with pytest.raises(err, match=match):
        getattr(tapp, entry)(cfg, device="cpu")
    assert not base.exists()


def test_test_protocol_writes_the_view_gifs(tmp_path):
    """save_video_frames: each test view's frames in view{v}.gif (startrax's
    gif fallback: 250 ms a frame, looping), the frames the logged test
    images hold, mapped to the GIF's palette (read back with PIL)."""
    from PIL import Image

    from startrax_torch.utils.logging import _gif_palette, read_png

    jcfg, tcfg = _configs(tmp_path)
    path = str(tmp_path / "tckpt")
    tckpt.save_checkpoint(path, {"params": convert.params_from_numpy(
        _tree(jcfg, _noisy_poses(tcfg)), device="cpu")}, step=3)
    _, tcfg = _configs(tmp_path, test=True, online_ckpt_path=path, save_video_frames=True)
    tapp.test(tcfg, device="cpu")
    run = tmp_path / "torch" / "smoke" / "online_test"
    for view in (0, 1):
        names = sorted(n for n in os.listdir(run / "images") if n.startswith(f"test_view{view}_"))
        frames = np.stack([read_png(str(run / "images" / n)) for n in names])
        palette, idx = _gif_palette(frames)
        gif = Image.open(run / f"view{view}.gif")
        assert (gif.n_frames, gif.info["duration"], gif.info["loop"]) == (len(names), 250, 0)
        for i in range(len(names)):
            gif.seek(i)
            np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), palette[idx[i]])


@pytest.mark.parametrize("extra", [[], ["--test", "true"]], ids=["train", "test"])
def test_online_defaults_to_the_card(tmp_path, monkeypatch, extra):
    """Through main's argv parser: without a CUDA device the app raises and
    names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "startrax", "configs", "synthetic_star_online.txt")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapp.main(["--config", config, "--basedir", str(tmp_path), *extra])
    assert os.listdir(tmp_path) == []


def test_missing_lpips_weights_are_logged_and_skipped(tmp_path):
    from startrax_torch.apps import test_protocol

    class WS:
        lines = []

        def log(self, msg):
            self.lines.append(msg)

    cfg = tconfig.Config(lpips_weights=str(tmp_path / "absent.pth"))
    assert test_protocol.make_lpips(cfg, WS()) is None
    assert "skipping LPIPS" in WS.lines[0]


@pytest.mark.parametrize("with_pose", [False, True], ids=["appinit", "online"])
def test_gradient_isolation_diagnostic(with_pose):
    """The port's check_batch_gradient_isolation passes on the eval render
    (train=False) and raises on a renderer that mixes rays, as
    tests/test_occgrid_vis_mesh.py checks startrax's."""
    cfg = StarConfig(num_vehicles=1, netdepth=4, netdepth_fine=4, netwidth=16, netwidth_fine=16,
                     n_samples=8, n_importance=8, near=2.0, far=6.0, compute_dtype=torch.float32,
                     perturb=0.0)
    params = init_star(cfg, torch.Generator().manual_seed(0), "cpu")
    pose = (torch.tensor([[0.1, -0.2, 0.05, 0.0, 0.0, 0.0, 1.0]]) if with_pose else None)
    rng = np.random.default_rng(0)
    batch = {"rays_o": rng.normal(size=(4, 3)).astype(np.float32),
             "rays_d": rng.normal(size=(4, 3)).astype(np.float32)}

    def render(o, d):
        return render_star(params, cfg, o, d, pose=pose, train=False)

    check_batch_gradient_isolation(render, batch)

    def mixing(o, d):
        out = dict(render(o, d))
        out["rgb"] = out["rgb"] + 0.01 * out["rgb"].mean(dim=0, keepdim=True)
        return out

    with pytest.raises(AssertionError, match="mixing"):
        check_batch_gradient_isolation(mixing, batch)


def test_synthetic_adapter_interface_matches_startrax():
    """The port's SyntheticAdapter has startrax's public class attributes
    and methods, with equal class values (bbox_rebase_frame0 = False, which
    the test protocol reads), and the same public instance attributes."""
    def public(obj):
        return {n for n in dir(obj) if not n.startswith("_")}

    assert public(TAdapter) == public(JAdapter)
    for name in public(JAdapter):
        j = getattr(JAdapter, name)
        if not callable(j):
            assert getattr(TAdapter, name) == j, name
    assert TAdapter.bbox_rebase_frame0 is False
    scene = dict(num_vehicles=2, num_frames=3, H=8, W=8, focal=8.0)
    t = TAdapter(TScene(**scene), num_views=1, device="cpu")
    j = JAdapter(JScene(**scene), num_views=1)
    assert public(t) == public(j)
    np.testing.assert_allclose(t.bbox_local_vertices(), j.bbox_local_vertices(), rtol=1e-6)
