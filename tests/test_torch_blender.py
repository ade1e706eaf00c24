"""The port's Blender loader and lego app against startrax's, on the CPU.

- data/blender.BlenderScene against startrax's on tests/test_data.py's
  capture layout (3 views a split of 16x16 RGBA written by imageio, plus a
  5-view val split for testskip): images, poses, focal, intrinsics, rays and
  a seeded batch, on white and on black, with and without half_res. The
  same arithmetic in float32 on the same bytes, so the arrays are equal,
  except that half_res replaces cv2.resize(INTER_AREA) with a numpy mean of
  each 2x2 block, and cv2 sums the four values in another order: within
  1e-6 (measured 1.2e-7 after compositing, two float32 ulps of 1).
- halve_images against cv2.resize(INTER_AREA) to half size (cv2 is an oracle
  on this box only) within 1e-6 (measured 6.0e-8), and odd sizes raise.
- utils/logging.write_png's RGBA files (colour type 6) read back equal by
  imageio, PIL and read_png.
- apps/lego through its argv parser against startrax's lego app on a
  Blender capture the test writes, from one set of weights, on the same
  batches and uniforms, in float32 on the plain field path, compared as
  tests/test_torch_app_init.py compares app_init, at its tolerances: the
  fine losses within 5e-4 relative (measured 2.8e-6), PSNR within 5e-3 dB
  (measured 8.6e-5), SSIM within 5e-4 (measured 1.9e-5), the final
  parameters within 2 x lr x steps; the same rows, steps and image files.
"""

import json
import os

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from startrax.apps import app_init as japp
from startrax.apps import lego as jlego
from startrax.data.blender import BlenderScene as JBlender
from startrax.models.star import init_star as jinit_star
from startrax.utils import config as jconfig
from startrax_torch import convert
from startrax_torch.apps import app_init as tapp
from startrax_torch.apps import lego as tlego
from startrax_torch.data import blender as tblender
from startrax_torch.utils.logging import read_png, write_png
from startrax_torch.utils.tree import tree_leaves
from test_torch_app_init import _rows, _uniform_feed
from test_torch_online import _one_torch_thread  # noqa: F401


def _capture(root, rng, hw=(16, 16), views=3, splits=("train", "val", "test"), writer=None):
    """A Blender-format capture: transforms_{split}.json and RGBA PNG files
    (random colours and alpha), cameras backing off along +z."""
    writer = writer or imageio.imwrite
    for split in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(views):
            name = f"{split}/r_{i}"
            writer(os.path.join(root, f"{name}.png"),
                   rng.integers(0, 256, (*hw, 4), dtype=np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = [0, 0, 4 - i * 0.1]
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fp:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, fp)
    return str(root)


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lego")
    _capture(root, np.random.default_rng(5), splits=("train", "test"))
    _capture(root, np.random.default_rng(6), views=5, splits=("val",))
    return str(root)


def _same_scene(t, j, atol=0.0):
    assert (t.H, t.W, t.near, t.far) == (j.H, j.W, j.near, j.far)
    assert t.focal == pytest.approx(j.focal, rel=1e-12)
    for name in ("images", "poses", "K", "rays_o", "rays_d"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
@pytest.mark.parametrize("half", [False, True], ids=["full", "half_res"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_blender_scene_matches_startrax(blender_dir, split, half, white):
    kw = dict(split=split, half_res=half, white_bkgd=white, near=2.5, far=5.5)
    t, j = tblender.BlenderScene(blender_dir, **kw), JBlender(blender_dir, **kw)
    _same_scene(t, j, atol=1e-6 if half else 0.0)
    assert t.images.shape[1:] == ((8, 8, 3) if half else (16, 16, 3))
    bt, bj = (s.sample_batch(np.random.default_rng(9), 32) for s in (t, j))
    assert sorted(bt) == sorted(bj) == ["rays_d", "rays_o", "target"]
    for k in bt:
        np.testing.assert_allclose(bt[k], bj[k], rtol=0, atol=1e-6 if half else 0.0, err_msg=k)
    for view in range(t.images.shape[0]):
        for a, b in zip(t.view_rays(view), j.view_rays(view)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("testskip", [0, 1, 2, 3])
def test_blender_testskip_matches_startrax(blender_dir, testskip):
    """val keeps every testskip-th frame (all with 0); train ignores it."""
    for split, views in (("val", [5, 5, 3, 2][testskip]), ("train", 3)):
        t = tblender.BlenderScene(blender_dir, split=split, testskip=testskip)
        j = JBlender(blender_dir, split=split, testskip=testskip)
        assert t.images.shape[0] == views
        _same_scene(t, j)


def test_blender_background_compositing(blender_dir, tmp_path):
    """A transparent image composites to white on white and to black on black."""
    root = _capture(tmp_path, np.random.default_rng(1), views=1, splits=("val",))
    imageio.imwrite(os.path.join(root, "val/r_0.png"), np.zeros((16, 16, 4), np.uint8))
    white = tblender.BlenderScene(root, split="val", white_bkgd=True)
    black = tblender.BlenderScene(root, split="val", white_bkgd=False)
    np.testing.assert_array_equal(white.images, 1.0)
    np.testing.assert_array_equal(black.images, 0.0)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20), (800, 800)])
def test_halve_images_matches_cv2_inter_area(hw):
    rng = np.random.default_rng(hw[0])
    imgs = (rng.integers(0, 256, (2, *hw, 4)) / 255.0).astype(np.float32)
    got = tblender.halve_images(imgs)
    want = np.stack([cv2.resize(im, (hw[1] // 2, hw[0] // 2), interpolation=cv2.INTER_AREA)
                     for im in imgs])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(15, 16), (16, 15)])
def test_half_res_refuses_odd_sizes(hw, tmp_path):
    with pytest.raises(ValueError, match="even image size"):
        tblender.halve_images(np.zeros((1, *hw, 4), np.float32))
    root = _capture(tmp_path, np.random.default_rng(2), hw=hw, views=1, splits=("train",))
    with pytest.raises(ValueError, match="even image size"):
        tblender.BlenderScene(root, half_res=True)


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_write_png_reads_back_in_every_reader(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError, match=r"\[H, W, 3\] or \[H, W, 4\]"):
        write_png(path, img[..., :2])


def test_blender_capture_written_by_write_png_loads_as_imageio_s(tmp_path):
    """The capture chip_smoke.py writes on the card: write_png's RGBA files
    load to the same scene as imageio's."""
    a = _capture(tmp_path / "a", np.random.default_rng(3), views=2, splits=("train",),
                 writer=write_png)
    b = _capture(tmp_path / "b", np.random.default_rng(3), views=2, splits=("train",))
    _same_scene(tblender.BlenderScene(a, half_res=True), tblender.BlenderScene(b, half_res=True))


LEGO = """expname = lego_small
dataset_type = blender
white_bkgd = True
half_res = True
near = 2.0
far = 6.0
scale_factor = -1
netdepth = 4
netdepth_fine = 4
netwidth = 32
netwidth_fine = 32
N_samples = 12
N_importance = 12
N_rand = 128
mixed_precision = False
lrate = 5e-4
lrate_decay = 250
epochs_appearance = 2
steps_per_epoch = 10
epoch_val = 1
appearance_init_thres = 1e-9
num_workers = 1
data_parallel = off
perturb = 0.0
raw_noise_std = 0.0
use_viewdirs = True
"""


def test_lego_app_matches_startrax(tmp_path, monkeypatch):
    """startrax_torch.apps.lego.main against startrax.apps.lego.main, one
    argv (the lego.txt recipe at tiny widths) on a 24x24 capture halved to
    12x12 (three views a split; SSIM's 11-pixel window needs 11)."""
    data = _capture(tmp_path / "data", np.random.default_rng(4), hw=(24, 24))
    config = tmp_path / "lego_small.txt"
    config.write_text(LEGO)
    argv = ["--config", str(config), "--datadir", data]
    jcfg = jconfig.load_config(argv + ["--basedir", str(tmp_path / "jax")])
    jparams = jinit_star(jax.random.PRNGKey(0), jconfig.star_config_from(jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(japp, "init_star", lambda key, cfg: jparams)
    monkeypatch.setattr(tapp, "init_star",
                        lambda cfg, gen, dev: convert.params_from_numpy(tree, device=dev))
    _uniform_feed(monkeypatch, jcfg.seed)
    jtrain, jout = japp.train, []
    monkeypatch.setattr(japp, "train", lambda cfg: jout.append(jtrain(cfg)))
    ttrain = tapp.train
    monkeypatch.setattr(tapp, "train", lambda cfg: ttrain(cfg, device="cpu"))

    jlego.main(argv + ["--basedir", str(tmp_path / "jax")])
    tout = tlego.main(argv + ["--basedir", str(tmp_path / "torch")])

    dirs = [str(tmp_path / p / "lego_small" / "app_init") for p in ("jax", "torch")]
    jrows, trows = _rows(dirs[0]), _rows(dirs[1])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    losses = [(t["train/fine_loss"], j["train/fine_loss"]) for t, j in zip(trows, jrows)
              if "train/fine_loss" in j]
    vals = [(t, j) for t, j in zip(trows, jrows) if "val/psnr" in j]
    assert len(losses) == 2 and len(vals) == 2
    np.testing.assert_allclose(*zip(*losses), rtol=5e-4)
    for t, j in vals:
        assert abs(t["val/psnr"] - j["val/psnr"]) < 5e-3
        assert abs(t["val/ssim"] - j["val/ssim"]) < 5e-4
    assert losses[-1][0] < losses[0][0]
    assert sorted(os.listdir(os.path.join(dirs[1], "images"))) == sorted(
        os.listdir(os.path.join(dirs[0], "images")))
    steps = jcfg.epochs_appearance * jcfg.steps_per_epoch
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout[0])):
        assert a.device.type == "cpu"
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0,
                                   atol=2 * jcfg.lrate * steps)


def test_lego_app_defaults_to_the_card(tmp_path, monkeypatch):
    """Through main's argv parser: without a CUDA device the app raises and
    names device="cpu" before it makes a run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "startrax", "configs", "lego.txt")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tlego.main(["--config", config, "--basedir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
