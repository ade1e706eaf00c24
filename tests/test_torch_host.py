"""Parity of the port's host modules with startrax's, on the CPU: the pose,
trajectory and 3D-IoU metrics (startrax_torch.eval.{pose,trajectory,iou}),
the curriculum, checkpoints and pose files (startrax_torch.train), metric
logging (startrax_torch.utils.logging) and the app scaffolding
(startrax_torch.apps.common).

The metrics are copies of numpy code, so they are held to equality with
startrax's on tests/test_eval.py's cases and on random trajectories. A
checkpoint restores bitwise; a pose file is byte-equal to startrax's; a
metrics row equals startrax's but for its time stamp; a logged PNG decodes
to the logged 8-bit array.
"""

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from startrax.eval import iou as jiou
from startrax.eval import pose as jpose
from startrax.eval import trajectory as jtraj
from startrax.train import checkpoint as jckpt
from startrax.train import curriculum as jcur
from startrax.utils import logging as jlogging
from startrax_torch.apps import common as tcommon
from startrax_torch.eval import iou as tiou
from startrax_torch.eval import pose as tpose
from startrax_torch.eval import trajectory as ttraj
from startrax_torch.models.star import StarConfig, init_star
from startrax_torch.train import checkpoint as tckpt
from startrax_torch.train import curriculum as tcur
from startrax_torch.train import loop as tloop
from startrax_torch.utils import config as tconfig
from startrax_torch.utils import logging as tlogging
from startrax_torch.utils.tree import tree_leaves


def _pose7(t, rotvec):
    return np.concatenate([t, Rotation.from_rotvec(rotvec).as_quat()]).astype(np.float32)


def _traj(seed, n=6, k=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return np.stack([_pose7(rng.normal(size=3), rng.normal(size=3) * 0.2)
                     for _ in range(int(np.prod(shape)))]).reshape(shape + (7,))


def _unit_box(center, half=0.5):
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       np.float32) * half
    return corners + np.asarray(center, np.float32)


def _equal(a, b):
    """Equal nested results: tuples and lists item by item, arrays exactly."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _mats(seed, n=5):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    T[:, :3, 3] = np.random.default_rng(seed).normal(size=(n, 3))
    return T


_R = Rotation.from_euler("z", np.pi / 4).as_matrix().astype(np.float32)
_SHIFT = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
_SHIFT[:, 0, 3] = 0.4
METRICS = {
    "pose_identity": ("pose", "get_pose_metrics",
                      lambda: (np.stack([_pose7([0] * 3, [0] * 3)] * 4),) * 2),
    "pose_translation": ("pose", "get_pose_metrics", lambda: (
        np.stack([_pose7([1, 0, 0], [0] * 3)] * 3), np.stack([_pose7([0] * 3, [0] * 3)] * 3))),
    "pose_random": ("pose", "get_pose_metrics", lambda: (_traj(1), _traj(2))),
    "pose_matrices": ("pose", "get_pose_metrics", lambda: (_mats(3), _mats(4))),
    "pose_multi": ("pose", "get_pose_metrics_multi", lambda: (_traj(4, 5, 2), _traj(5, 5, 2))),
    "rpe_identical": ("traj", "evaluate_rpe", lambda: (_traj(3),) * 2),
    "rpe_random": ("traj", "evaluate_rpe", lambda: (_traj(6), _traj(7))),
    "rpe_matrices": ("traj", "evaluate_rpe", lambda: (_mats(5, 6), _mats(6, 6))),
    "ate_known": ("traj", "evaluate_ate", lambda: (np.stack([_pose7([0, 3, 4], [0] * 3)] * 4),
                                                   np.stack([_pose7([0] * 3, [0] * 3)] * 4))),
    "ate_random": ("traj", "evaluate_ate", lambda: (_traj(8), _traj(9))),
    "ate_matrices": ("traj", "evaluate_ate", lambda: (_mats(7), _mats(8))),
    "iou_identical": ("iou", "box3d_iou", lambda: (_unit_box([0, 0, 0]),) * 2),
    "iou_disjoint": ("iou", "box3d_iou", lambda: (_unit_box([0, 0, 0]), _unit_box([5, 0, 0]))),
    "iou_half": ("iou", "box3d_iou", lambda: (_unit_box([0, 0, 0]), _unit_box([0.5, 0, 0]))),
    "iou_rotated": ("iou", "box3d_iou", lambda: (_unit_box([0, 0, 0]),
                                                 _unit_box([0, 0, 0]) @ _R.T)),
    "iou_3d_poses": ("iou", "compute_3d_iou", lambda: (
        _SHIFT, np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        np.stack([_unit_box([0, 0, 0], half=0.4)] * 2))),
    "iou_2d": ("iou", "compute_2d_iou", lambda: (
        np.where(np.arange(100)[:, None] < [30, 60], 0.01, 1.0).astype(np.float32),
        np.arange(100) < 40)),
}
_MODS = {"pose": (tpose, jpose), "traj": (ttraj, jtraj), "iou": (tiou, jiou)}


@pytest.mark.parametrize("case", sorted(METRICS))
def test_eval_metrics_equal_startrax(case):
    mod, fn, make = METRICS[case]
    t, j = _MODS[mod]
    args = make()
    _equal(getattr(t, fn)(*args), getattr(j, fn)(*args))
    if fn.startswith("get_pose_metrics"):  # and per frame
        _equal(getattr(t, fn)(*args, reduce=False), getattr(j, fn)(*args, reduce=False))


def test_eval_metrics_golden_values():
    """test_eval.py's known values, on the port."""
    trans = tpose.get_pose_metrics(*METRICS["pose_translation"][2]())[0]
    assert trans == pytest.approx(1.0, rel=1e-6)
    assert ttraj.evaluate_ate(*METRICS["ate_known"][2]()) == pytest.approx(5.0, rel=1e-6)
    assert ttraj.evaluate_rpe(*METRICS["rpe_identical"][2]())[0] == pytest.approx(0.0, abs=1e-5)
    assert tiou.box3d_iou(*METRICS["iou_half"][2]()) == pytest.approx(1 / 3, rel=1e-3)
    assert tiou.box3d_iou(*METRICS["iou_disjoint"][2]()) == 0.0


CUR_CFG = dict(num_frames=8, initial_num_frames=3, online_thres=1e-3, tightened_thres=5e-4,
               min_epochs_between=2)


def test_curriculum_sequences_equal_startrax():
    losses = np.random.default_rng(0).uniform(1e-4, 2e-3, size=60)
    states = []
    for mod in (tcur, jcur):
        cfg = mod.CurriculumConfig(**CUR_CFG)
        s, seq = mod.CurriculumState.initial(cfg), []
        for loss in losses:
            s = mod.advance(s, cfg, float(loss))
            seq.append(dataclasses.asdict(s))
        states.append(seq)
    assert states[0] == states[1]
    assert states[0][-1]["current_frame"] > CUR_CFG["initial_num_frames"]
    s = tcur.CurriculumState(current_frame=6, threshold=5e-4, epochs_since_advance=3)
    d = {k: np.asarray(v) for k, v in tckpt.curriculum_to_dict(s).items()}
    assert tckpt.curriculum_from_dict(d) == s
    assert jckpt.curriculum_to_dict(jcur.CurriculumState(**dataclasses.asdict(s))) == \
        tckpt.curriculum_to_dict(s)


def test_pose_files_are_byte_equal_to_startrax(tmp_path):
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, :3] = Rotation.random(5, random_state=1).as_matrix()
    T[:, :3, 3] = np.random.default_rng(2).normal(size=(5, 3))
    tckpt.save_poses_txt(str(tmp_path / "t.txt"), T)
    jckpt.save_poses_txt(str(tmp_path / "j.txt"), T)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    back = tckpt.load_poses_txt(str(tmp_path / "t.txt"))
    np.testing.assert_allclose(back, T, atol=1e-6)
    np.testing.assert_array_equal(back, jckpt.load_poses_txt(str(tmp_path / "t.txt")))


TINY = StarConfig(num_vehicles=2, netdepth=2, netdepth_fine=2, netwidth=16, netwidth_fine=16,
                  n_samples=4, n_importance=4)


def _state(seed):
    params = init_star(TINY, torch.Generator().manual_seed(seed), device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return {"params": params, "poses": np.arange(6, dtype=np.float32).reshape(2, 3),
            "curriculum": {"current_frame": 5, "done": False}, "epoch": seed}


def test_checkpoint_restores_bitwise_latest_and_by_step(tmp_path):
    path = str(tmp_path / "ckpts")
    states = {s: _state(s) for s in (0, 3, 12)}
    for s, st in states.items():
        assert tckpt.save_checkpoint(path, st, step=s) == os.path.join(path, str(s))
    assert sorted(os.listdir(path)) == ["0", "12", "3"]  # no temporary left behind
    for step, want in ((None, states[12]), (3, states[3])):
        got = tckpt.restore_checkpoint(path, step=step, device="cpu")
        a, b = tree_leaves(got["params"]), tree_leaves(want["params"])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(not x.requires_grad for x in a)
        np.testing.assert_array_equal(got["poses"], want["poses"])
        assert isinstance(got["poses"], np.ndarray)
        assert got["curriculum"] == want["curriculum"] and got["epoch"] == want["epoch"]
    assert tckpt.checkpoint_keys(path) == {"params", "poses", "curriculum", "epoch"}
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(path, step=5, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_checkpoint_gc_keeps_the_newest(tmp_path):
    path = str(tmp_path / "ckpts")
    for s in (1, 2, 10, 4, 7):
        tckpt.save_checkpoint(path, {"x": torch.full((2,), float(s))}, step=s)
    assert tckpt.gc_checkpoints(path, keep_last=3) == [4, 7, 10]
    assert float(tckpt.restore_checkpoint(path, device="cpu")["x"][0]) == 10.0
    assert tckpt.gc_checkpoints(path, keep_last=0) == []


def test_checkpoint_restore_defaults_to_the_card(tmp_path, monkeypatch):
    tckpt.save_checkpoint(str(tmp_path), {"x": torch.ones(2)}, step=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tckpt.restore_checkpoint(str(tmp_path))
    assert tckpt.checkpoint_keys(str(tmp_path)) == {"x"}


def test_restore_static_only_keeps_exactly_the_static_keys():
    app = init_star(TINY, torch.Generator().manual_seed(1), device="cpu")
    online = tloop.init_online_params(TINY, 3, torch.Generator().manual_seed(2), device="cpu")
    out = tckpt.restore_static_only(app, online)
    assert sorted(out) == ["nerf", "poses"] and out["poses"] is online["poses"]
    for k, v in out["nerf"].items():
        assert v is (app[k] if k.startswith("static") else online["nerf"][k])
    assert sorted(out["nerf"]) == sorted(online["nerf"])


def test_metrics_rows_equal_startrax(tmp_path):
    rows = []
    for name, mod in (("t", tlogging), ("j", jlogging)):
        logger = mod.MetricsLogger(str(tmp_path / name))
        logger.log({"train/fine_loss": np.float32(0.125), "epoch": 3}, 40)
        logger.log({"val/psnr": torch.tensor(21.5) if name == "t" else 21.5, "note": "x"}, 41)
        logger.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows.append([{k: v for k, v in json.loads(line).items() if k != "time"}
                         for line in f])
    assert rows[0] == rows[1] == [{"step": 40, "train/fine_loss": 0.125, "epoch": 3.0},
                                  {"step": 41, "val/psnr": 21.5, "note": "x"}]


def _read_png(path):
    """An 8-bit RGB PNG with unfiltered rows -> [H, W, 3] uint8."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_log_image_writes_a_png_of_the_logged_array(tmp_path):
    img = np.random.default_rng(0).uniform(-0.2, 1.2, size=(7, 5, 3)).astype(np.float32)
    img[0, 0, 0] = np.nan
    logger = tlogging.MetricsLogger(str(tmp_path))
    path = logger.log_image("val/rgb", img, 12)
    logger.close()
    assert path == str(tmp_path / "images" / "val_rgb_000012.png")
    want = (255 * np.clip(np.nan_to_num(img), 0, 1)).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(path), want)
    with pytest.raises(ValueError):
        tlogging.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


def test_configure_logger_follows_the_run_dir(tmp_path):
    a = tlogging.configure_logger(str(tmp_path / "a"), "port_test")
    a.info("first")
    b = tlogging.configure_logger(str(tmp_path / "b"), "port_test")
    b.info("second")
    for h in b.handlers:
        h.flush()
    assert "second" not in (tmp_path / "a" / "run.log").read_text()
    assert "second" in (tmp_path / "b" / "run.log").read_text()


def test_workspace_and_host_prng(tmp_path, monkeypatch):
    cfg = tconfig.Config(basedir=str(tmp_path), expname="e")
    ws = tcommon.Workspace(cfg, "app_init")
    assert ws.run_dir == os.path.join(str(tmp_path), "e", "app_init")
    assert ws.ckpt_dir == os.path.join(ws.run_dir, "ckpts")
    assert json.load(open(os.path.join(ws.run_dir, "args.json")))["expname"] == "e"
    rng, gen = tcommon.host_prng(7, device="cpu")
    assert rng.integers(0, 1 << 30) == np.random.default_rng(7).integers(0, 1 << 30)
    assert gen.device.type == "cpu" and gen.initial_seed() == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcommon.host_prng(7)


@pytest.mark.parametrize("kind", ["carla", "blender", "nope"])
def test_make_dataset_raises_for_what_is_not_ported(kind, tmp_path):
    """An unknown kind raises ValueError. The CARLA and Blender loaders are
    ported: on a directory that holds no capture it is the loader that
    raises, reading intrinsics.npy or transforms_train.json
    (tests/test_torch_carla.py and tests/test_torch_blender.py hold them
    against startrax's on a capture)."""
    cfg = tconfig.Config(dataset_type=kind, datadir=str(tmp_path))
    err, match = {"carla": (FileNotFoundError, "intrinsics.npy"),
                  "blender": (FileNotFoundError, "transforms_train.json"),
                  "nope": (ValueError, "unknown")}[kind]
    with pytest.raises(err, match=match):
        tcommon.make_dataset(cfg, "train", device="cpu")
