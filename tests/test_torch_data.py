"""Parity of the port's synthetic scene (startrax_torch.data.synthetic) and
its host data modules with startrax.data, on the CPU.

- The torch ground-truth marcher against JAX's jitted marcher and against
  the numpy marcher, at tests/test_data.py::test_accel_render_matches_numpy's
  shape, with its bounds: rgb within 2e-5, depth within 2e-4, the dynamic
  masks agreeing on more than 99.9% of the pixels.
- One scene cache for both packages: a cache written by either package's
  SyntheticAdapter is found under the same file name and read by the other's.
- Batch sampling is numpy in both packages: for one generator seed the
  batches are equal, every sampling option included.
- noisy_gt_relative_poses within 1e-5 of JAX's for one generator seed.
- The copied host modules (transforms, prefetch) give the same results.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from startrax.data import prefetch as jprefetch
from startrax.data import synthetic as jsyn
from startrax.data import transforms as jtransforms
from startrax_torch.data import prefetch as tprefetch
from startrax_torch.data import synthetic as tsyn
from startrax_torch.data import transforms as ttransforms

SCENE = dict(num_vehicles=2, num_frames=4, H=48, W=48, focal=48.0, n_march=64)


def _close_render(a, b):
    np.testing.assert_allclose(a[0], b[0], atol=2e-5)
    np.testing.assert_allclose(a[1], b[1], atol=2e-4)
    assert (a[2] == b[2]).mean() > 0.999  # borderline pixels may flip


def test_scene_dataclass_matches_startrax():
    """The dataclass fields are the cache key: same names, types, defaults."""
    def fields(cls):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]

    assert fields(tsyn.SyntheticScene) == fields(jsyn.SyntheticScene)
    assert tsyn._CACHE_VERSION == jsyn._CACHE_VERSION == 3


def test_torch_marcher_matches_jax_and_numpy():
    t = tsyn.SyntheticScene(**SCENE)
    got = t.render_frame(1, 5, 2, device="cpu")
    assert [a.shape for a in got] == [(48, 48, 3), (48, 48), (48, 48)]
    assert got[0].dtype == got[1].dtype == np.float32 and got[2].dtype == bool
    _close_render(got, jsyn.SyntheticScene(**SCENE)._render_frame_accel(1, 5, 2))
    _close_render(got, t._render_frame_numpy(1, 5, 2))
    assert got[2].any() and not got[2].all()  # a vehicle is in view, not everywhere


def test_torch_marcher_chunks_and_crops_give_the_same_pixels(monkeypatch):
    """Rows are marched independently: a crop of the rays, or a chunk of
    one row, gives the full frame's pixels exactly."""
    t = tsyn.SyntheticScene(**SCENE)
    full = t.render_frame(3, 5, 1, device="cpu")
    ro, rd = t.view_rays(3, 5)
    crop = t.march(ro[10:30, 5:25], rd[10:30, 5:25], 1, device="cpu")
    for a, b in zip(crop, full):
        np.testing.assert_array_equal(a, b[10:30, 5:25])
    monkeypatch.setattr(tsyn, "_MARCH_CHUNK_BYTES", 1)
    for a, b in zip(t.render_frame(3, 5, 1, device="cpu"), full):
        np.testing.assert_array_equal(a, b)


def test_marcher_and_dataset_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tsyn.SyntheticScene(**dict(SCENE, H=8, W=8))
    for call in (lambda: t.render_frame(0, 2, 0), lambda: t.make_dataset(num_views=1),
                 lambda: tsyn.SyntheticAdapter(t, num_views=1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


SMALL = dict(num_vehicles=1, num_frames=3, H=16, W=16, focal=16.0, n_march=48)


@pytest.mark.parametrize("writer", ["startrax", "startrax_torch"])
def test_scene_cache_is_shared_between_packages(writer, tmp_path, monkeypatch):
    monkeypatch.setattr(jsyn, "_GEN_MEMO", {})
    monkeypatch.setattr(tsyn, "_GEN_MEMO", {})
    jscene, tscene = jsyn.SyntheticScene(**SMALL), tsyn.SyntheticScene(**SMALL)
    key = tsyn.cache_key(tscene, 5)
    assert key == json.dumps({"views": 5, "version": 3, **dataclasses.asdict(jscene)},
                             sort_keys=True)
    make = {"startrax": lambda: jsyn.SyntheticAdapter(jscene, num_views=3, num_val_views=2,
                                                       cache_dir=str(tmp_path)),
            "startrax_torch": lambda: tsyn.SyntheticAdapter(tscene, num_views=3,
                                                             num_val_views=2,
                                                             cache_dir=str(tmp_path),
                                                             device="cpu")}
    written = make[writer]()
    assert os.listdir(tmp_path) == [tsyn.cache_file(tscene, 5)]
    mtime = os.path.getmtime(tmp_path / tsyn.cache_file(tscene, 5))
    # the reader finds the file and generates nothing: it needs no device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reader = make["startrax_torch" if writer == "startrax" else "startrax"]()
    assert os.path.getmtime(tmp_path / tsyn.cache_file(tscene, 5)) == mtime
    assert sorted(reader.data) == sorted(written.data)
    for k in written.data:
        np.testing.assert_array_equal(reader.data[k], written.data[k])
    # and the data agrees with what the other package would generate itself
    other = (tscene.make_dataset(5, device="cpu") if writer == "startrax"
             else jscene.make_dataset(5))
    _close_render(*[(d["images"][:3], d["depths"][:3], d["dyn_masks"][:3])
                    for d in (written.data, other)])


@pytest.fixture(scope="module")
def adapters():
    """A JAX adapter and the port's over one generated scene (the port's
    memo given JAX's data, so both sample from equal arrays)."""
    scene = dict(SMALL, num_frames=4)
    jtr = jsyn.SyntheticAdapter(jsyn.SyntheticScene(**scene), num_views=4, num_val_views=1)
    tscene = tsyn.SyntheticScene(**scene)
    key = tsyn.cache_key(tscene, 5)
    tsyn._GEN_MEMO[key] = jsyn._GEN_MEMO[key]
    yield jtr, tsyn.SyntheticAdapter(tscene, num_views=4, num_val_views=1)
    tsyn._GEN_MEMO.pop(key)


SAMPLING = {
    "frame": dict(frame=2),
    "window": dict(start_frame=1, current_frame=4),
    "car": dict(frame=0, car_sample_ratio=0.25),
    "view_range": dict(frame=1, car_sample_ratio=0.25, view_range=(1, 3)),
    "mixed": dict(start_frame=0, current_frame=4, mixed_frames=True, car_sample_ratio=0.3),
    "ghost": dict(start_frame=0, current_frame=4, car_sample_ratio=0.25,
                  ghost_sample_ratio=0.25),
    "frame0": dict(start_frame=0, current_frame=3, frame0_sample_ratio=0.25),
    "all": dict(start_frame=0, current_frame=4, car_sample_ratio=0.25, ghost_sample_ratio=0.25,
                frame0_sample_ratio=0.25, view_range=(0, 3)),
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_sample_batch_equals_startrax(adapters, name):
    jtr, ttr = adapters
    jb = jtr.sample_batch(np.random.default_rng(5), 96, **SAMPLING[name])
    tb = ttr.sample_batch(np.random.default_rng(5), 96, **SAMPLING[name])
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype
        np.testing.assert_array_equal(tb[k], jb[k])


def test_sample_ray_batch_and_scene_facts_equal_startrax(adapters):
    jtr, ttr = adapters
    for ratio in (0.0, 0.5):
        jb = jsyn.sample_ray_batch(np.random.default_rng(9), jtr.data, 64, 1, ratio)
        tb = tsyn.sample_ray_batch(np.random.default_rng(9), ttr.data, 64, 1, ratio)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(ttr.bbox_local_vertices(), jtr.bbox_local_vertices())
    np.testing.assert_allclose(ttr.gt_vehicle_poses(), jtr.gt_vehicle_poses(), atol=1e-7)
    np.testing.assert_array_equal(ttr.gt_relative_poses(), jtr.gt_relative_poses())


def test_noisy_gt_relative_poses_match_startrax(adapters):
    jtr, ttr = adapters
    got = ttr.noisy_gt_relative_poses(np.random.default_rng(3))
    want = np.asarray(jtr.noisy_gt_relative_poses(np.random.default_rng(3)))
    assert got.shape == want.shape == (1, 4, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[:, 0], ttr.gt_relative_poses()[:, 0], atol=1e-6)


def test_transforms_match_startrax():
    rng = np.random.default_rng(1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    batch = np.stack([pose, np.linalg.inv(pose).astype(np.float32)])
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    for name, args in (("from_ue4_to_nerf", (pose,)), ("invert_transformation", (pose,)),
                       ("invert_transformation", (batch,)), ("from_ue4_to_nerf_pts", (pts,)),
                       ("pose_spherical", (30.0, 4.0)), ("pose_rotational", (45.0,)),
                       ("pose_translational", (2.0,))):
        np.testing.assert_array_equal(getattr(ttransforms, name)(*args),
                                      getattr(jtransforms, name)(*args))


def test_prefetcher_gives_startrax_batches_and_raises_worker_errors():
    def sample(rng, state):
        return {"x": rng.integers(0, 1000, size=4), "n": state["n"]}

    got = []
    for mod in (tprefetch, jprefetch):
        with mod.BatchPrefetcher(sample, {"n": 7}, seed=11, depth=2, workers=1) as pf:
            got.append([next(pf) for _ in range(5)])
    for a, b in zip(*got):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["n"] == b["n"] == 7

    def fail(rng, state):
        raise ValueError("boom")

    pf = tprefetch.BatchPrefetcher(fail, {}, workers=1)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        next(pf)
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)
