"""The port's PNG reader and CARLA loader, on the CPU.

- utils/logging.read_png against imageio on the PNG files imageio writes
  (every colour type it writes at 8 bits: grey, grey + alpha, RGB, RGBA;
  its encoder picks the row filters), on files that force each of the five
  row filters on every row, and on write_png's files: equal arrays. What it
  does not read (16-bit, palette, interlaced) raises ValueError naming it,
  and so do a corrupt chunk and a file that is not a PNG.
- data/carla.CarlaScene against startrax's on a CARLA-format capture (the
  layout of tests/test_data.py's carla_dir: 57 cameras, 3 frames, 2
  vehicles, the 24-bit depth code, semantic id 10, bboxes.npy; the colour
  frames written by imageio, the rest by write_png): images, semantics,
  depths, camera poses and rays bitwise; GT, relative and noisy poses and
  bbox vertices within 1e-6 (float32 rounding of the quaternion
  conversion); every sample_batch mode under the same numpy generator
  bitwise; the public interface equal; make_dataset's carla branch.
"""

import dataclasses
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from startrax.apps import common as jcommon
from startrax.data import carla as jcarla
from startrax_torch.apps import common as tcommon
from startrax_torch.data import carla as tcarla
from startrax_torch.utils import config as tconfig
from startrax_torch.utils.logging import read_png, write_png

H, W = 12, 16
N_CAMS = 57  # train (< 50), val (50-55), test (> 55)
N_FRAMES = 3
N_VEHICLES = 2
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels


def _image(shape, kind, seed):
    """random bytes, a smooth ramp, or the ramp with every third row random"""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ramp = (np.sin(yy / 5.0) + np.cos(xx / 7.0)) * 60 + 128
    img = np.broadcast_to(ramp.reshape(ramp.shape + (1,) * (len(shape) - 2)), shape)
    img = img.astype(np.uint8)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "mixed":
        img = img.copy()
        img[::3] = rng.integers(0, 256, img[::3].shape, dtype=np.uint8)
    return img


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode(img, ctype, filters, depth=8, interlace=0):
    """A PNG file's bytes with the given row filter on each row (a plain
    reference encoder, pixel by pixel)."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.int64)
    bpp = x.shape[2]
    rows = []
    for y in range(h):
        f = filters[y]
        out = np.zeros((w, bpp), np.int64)
        for i in range(w):
            a = x[y, i - 1] if i else np.zeros(bpp, np.int64)
            b = x[y - 1, i] if y else np.zeros(bpp, np.int64)
            c = x[y - 1, i - 1] if y and i else np.zeros(bpp, np.int64)
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = [np.zeros(bpp, np.int64), a, b, (a + b) // 2, paeth][f]
            out[i] = (x[y, i] - pred) % 256
        rows.append(bytes([f]) + out.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


def _filters_of(path):
    """The row filter types in a PNG file."""
    buf, pos, idat = open(path, "rb").read(), 8, []
    while pos < len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", buf[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat.append(buf[pos + 8:pos + 8 + length])
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("kind", ["random", "smooth", "mixed"])
@pytest.mark.parametrize("ctype", sorted(CHANNELS))
def test_read_png_matches_imageio(ctype, kind, tmp_path):
    shape = (23, 31) if ctype == 0 else (23, 31, CHANNELS[ctype])
    img = _image(shape, kind, seed=ctype)
    path = str(tmp_path / "img.png")
    imageio.imwrite(path, img)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)
    if kind != "random":  # imageio's encoder picks a filter a row: predictors here
        assert _filters_of(path) - {0}


@pytest.mark.parametrize("ctype", sorted(CHANNELS))
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_read_png_each_row_filter(filt, ctype, tmp_path):
    shape = (9, 11) if ctype == 0 else (9, 11, CHANNELS[ctype])
    img = _image(shape, "mixed", seed=filt)
    path = tmp_path / "img.png"
    path.write_bytes(_encode(img, ctype, [filt] * shape[0]))
    np.testing.assert_array_equal(read_png(str(path)), img)
    np.testing.assert_array_equal(imageio.imread(str(path)), img)  # the encoder is sound


def test_read_png_mixed_row_filters(tmp_path):
    img = _image((40, 37, 3), "mixed", seed=9)
    path = tmp_path / "img.png"
    path.write_bytes(_encode(img, 2, [(3 * y) % 5 for y in range(40)]))
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_read_png_reads_write_png(tmp_path):
    img = _image((17, 29, 3), "random", seed=4)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    img = _image((6, 5, 3), "random", seed=5)
    cases = {
        "16-bit": _encode(np.zeros((4, 4), np.uint8), 0, [0] * 4, depth=16),
        "palette": _encode(np.zeros((4, 4), np.uint8), 3, [0] * 4),
        "interlaced": _encode(img, 2, [0] * 6, interlace=1),
    }
    for what, data in cases.items():
        path = tmp_path / f"{what}.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=what):
            read_png(str(path))
    path = tmp_path / "grey16.png"
    imageio.imwrite(str(path), np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000)
    with pytest.raises(ValueError, match="16-bit"):
        read_png(str(path))
    good = bytearray(_encode(img, 2, [1] * 6))
    good[-20] ^= 0xFF  # a byte of the IDAT chunk
    (tmp_path / "corrupt.png").write_bytes(bytes(good))
    with pytest.raises(ValueError, match="corrupt"):
        read_png(str(tmp_path / "corrupt.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "not.png"))


@pytest.fixture(scope="module")
def carla_dir(tmp_path_factory):
    """tests/test_data.py's CARLA capture: colour frames through imageio,
    semantics and depths through write_png."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("carla")
    np.save(root / "intrinsics.npy", {"h": H, "w": W, "fov": 90.0})
    extrinsics = {}
    for i in range(N_CAMS):
        ang = 2 * np.pi * i / N_CAMS
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_euler("z", ang).as_matrix()
        pose[:3, 3] = [10 * np.cos(ang), 10 * np.sin(ang), 2.0]
        extrinsics[i] = pose
    np.save(root / "extrinsics.npy", extrinsics)
    code = int(500.0 / 1000.0 * (256 ** 3 - 1))  # 500 m in the 24-bit code
    for i in range(N_CAMS):
        cam = root / f"camera{i}"
        cam.mkdir()
        for f in range(N_FRAMES):
            imageio.imwrite(cam / f"{f}.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            sem = np.full((H, W, 3), 7, np.uint8)
            sem[:4, :4 + (i + f) % 3] = 10  # "car" pixels
            write_png(str(cam / f"{f}_semantic.png"), sem)
            depth = np.zeros((H, W, 3), np.uint8)
            depth[..., 0], depth[..., 1], depth[..., 2] = code % 256, (code // 256) % 256, \
                code // 65536
            depth[0, 0] = [1, 2, 3]
            write_png(str(cam / f"{f}_depth.png"), depth)
    for k in range(N_VEHICLES):
        vdir = root / "poses" / f"vehicle{k}"
        vdir.mkdir(parents=True)
        for f in range(N_FRAMES):
            pose = np.eye(4)
            pose[:3, :3] = Rotation.from_euler("z", 0.1 * f + 0.2 * k).as_matrix()
            pose[:3, 3] = [f * 2.0 + k, 0.5, 1.0]
            np.save(vdir / f"{f}.npy", pose)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       np.float64) * [2.0, 1.0, 0.8]
    np.save(root / "bboxes.npy", np.array([{"local_vertices": corners}] * N_VEHICLES,
                                          dtype=object), allow_pickle=True)
    return str(root)


def _cfg(mod, datadir, **kw):
    return mod.CarlaConfig(**{**dict(datadir=datadir, num_frames=N_FRAMES,
                                     num_vehicles=N_VEHICLES, has_depth_data=True,
                                     scale_factor=0.01, near=3.0, far=80.0), **kw})


SCENE_ARRAYS = ("images", "semantic", "depths", "poses", "rays_o", "rays_d", "K")


@pytest.mark.parametrize("split, kw", [
    ("train", {}), ("val", {}), ("test", {"eval_last_frame": 2}),
    ("train", {"has_depth_data": False, "scale_factor": -1.0})],
    ids=["train", "val", "test-eval_last_frame", "train-no-depth-unscaled"])
def test_carla_scene_matches_startrax(carla_dir, split, kw):
    j = jcarla.CarlaScene(_cfg(jcarla, carla_dir, **kw), split)
    t = tcarla.CarlaScene(_cfg(tcarla, carla_dir, **kw), split)
    for name in SCENE_ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.H, t.W, t.focal, t.near, t.far, t.split) == (j.H, j.W, j.focal, j.near, j.far,
                                                            j.split)
    n_views = {"train": 50, "val": 6, "test": 1}[split]
    assert t.images.shape == (n_views, kw.get("eval_last_frame", N_FRAMES), H, W, 3)
    if kw.get("has_depth_data", True):
        assert np.allclose(t.depths[:, :, 1:], 5.0, rtol=1e-4)  # 500 m x 0.01
    for name in ("gt_vehicle_poses", "gt_relative_poses", "bbox_local_vertices"):
        a, b = getattr(t, name)(), np.asarray(getattr(j, name)())
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(t.noisy_gt_relative_poses(np.random.default_rng(1)),
                               j.noisy_gt_relative_poses(np.random.default_rng(1)), rtol=0,
                               atol=1e-6)
    for view in (0, n_views - 1):
        for a, b in zip(t.view_rays(view), j.view_rays(view)):
            np.testing.assert_array_equal(a, b)


SAMPLE_MODES = {
    "window": dict(start_frame=0, current_frame=N_FRAMES),
    "frame": dict(frame=2),
    "car": dict(current_frame=2, car_sample_ratio=0.5),
    "crop": dict(crop=True, current_frame=N_FRAMES),
    "view_range": dict(current_frame=N_FRAMES, view_range=(10, 20)),
    "mixed": dict(current_frame=N_FRAMES, mixed_frames=True),
    "mixed-car": dict(start_frame=1, current_frame=N_FRAMES, mixed_frames=True,
                      car_sample_ratio=0.3, view_range=(0, 30)),
    "mixed-crop": dict(current_frame=N_FRAMES, mixed_frames=True, crop=True,
                       car_sample_ratio=0.3),
    "ghost": dict(current_frame=N_FRAMES, ghost_sample_ratio=0.2, car_sample_ratio=0.2),
    "frame0": dict(current_frame=N_FRAMES, frame0_sample_ratio=0.25, ghost_sample_ratio=0.25),
}


@pytest.fixture(scope="module")
def scenes(carla_dir):
    return (tcarla.CarlaScene(_cfg(tcarla, carla_dir, crop_box=(2, 9, 3, 30)), "train"),
            jcarla.CarlaScene(_cfg(jcarla, carla_dir, crop_box=(2, 9, 3, 30)), "train"))


@pytest.mark.parametrize("mode", sorted(SAMPLE_MODES))
def test_carla_sample_batch_matches_startrax(scenes, mode):
    t, j = scenes
    kw = SAMPLE_MODES[mode]
    for seed in (0, 1):
        bt = t.sample_batch(np.random.default_rng(seed), 48, **kw)
        bj = j.sample_batch(np.random.default_rng(seed), 48, **kw)
        assert sorted(bt) == sorted(bj) == ["frame", "rays_d", "rays_o", "target", "target_depth"]
        for k in bj:
            a, b = np.asarray(bt[k]), np.asarray(bj[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=k)
    if "mixed" in mode or "ghost" in mode or "frame0" in mode:
        assert bt["frame"].shape == (48,)
    else:
        assert bt["frame"].shape == ()
    assert sorted(t._car_pools) == sorted(j._car_pools)


def test_carla_scene_interface_matches_startrax(scenes):
    """The port's CarlaScene has startrax's public methods and instance
    attributes, and the module its public names."""
    def public(obj):
        return {n for n in dir(obj) if not n.startswith("_")}

    t, j = scenes
    assert public(tcarla.CarlaScene) == public(jcarla.CarlaScene)
    assert public(t) == public(j)
    assert [f.name for f in dataclasses.fields(tcarla.CarlaConfig)] == [
        f.name for f in dataclasses.fields(jcarla.CarlaConfig)]
    assert tcarla.CAR_SEMANTIC_ID == jcarla.CAR_SEMANTIC_ID == 10
    names = ["camera10/", "camera2/", "camera1/", "x_9.png", "x_10.png"]
    assert sorted(names, key=tcarla.natural_keys) == sorted(names, key=jcarla.natural_keys)


def test_carla_helpers_match_startrax(carla_dir):
    assert tcarla.load_intrinsics(carla_dir) == jcarla.load_intrinsics(carla_dir)
    img = np.random.default_rng(3).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcarla._decode_carla_depth(img),
                                  jcarla._decode_carla_depth(img))
    for split in ("train", "val", "test"):
        assert tcarla._view_split_indices(N_CAMS, split) == jcarla._view_split_indices(N_CAMS,
                                                                                       split)
    with pytest.raises(ValueError, match="invalid split"):
        tcarla._view_split_indices(N_CAMS, "holdout")


def test_make_dataset_loads_carla(carla_dir):
    """apps/common.make_dataset's carla branch: the config's fields reach
    the scene as startrax's factory passes them; the blender branch reads
    a Blender capture, so on the CARLA capture it raises for
    transforms_train.json."""
    kw = dict(dataset_type="carla", datadir=carla_dir, num_frames=N_FRAMES,
              num_vehicles=N_VEHICLES, has_depth_data=True, eval_last_frame=2)
    from startrax.utils import config as jconfig

    for split in ("train", "test"):
        t = tcommon.make_dataset(tconfig.Config(**kw), split)
        j = jcommon.make_dataset(jconfig.Config(**kw), split)
        assert isinstance(t, tcarla.CarlaScene) and dataclasses.asdict(t.cfg) == \
            dataclasses.asdict(j.cfg)
        np.testing.assert_array_equal(t.images, j.images)
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        tcommon.make_dataset(tconfig.Config(dataset_type="blender", datadir=carla_dir), "train")
    assert os.path.isdir(carla_dir)
