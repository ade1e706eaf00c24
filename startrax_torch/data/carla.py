"""CARLA multi-view dynamic-scene data pipeline (host-side numpy).

Counterpart of startrax/data/carla.py, with the same layout, conventions and
draws; PNG files are read with the port's own reader (utils/logging.read_png,
numpy and zlib) in place of imageio. Directory layout:

  datadir/
    intrinsics.npy        {"h", "w", "fov"} dict
    extrinsics.npy        {cam_index: 4x4 UE4 camera pose} dict
    camera0/ ... cameraN/ per-frame "<f>.png", "<f>_semantic.png",
                          "<f>_depth.png" (24-bit encoded CARLA depth)
    poses/<vehicle>/*.npy per-frame 4x4 UE4 vehicle poses
    bboxes.npy            per-vehicle {"local_vertices": [8,3]} (optional)

Conventions: the UE4 -> NeRF axis change; the world scale_factor on
translations, near/far and depths; the view split train < 50, val 50..55,
test > 55; semantic car id 10; the 24-bit depth code times 1000 m; the GT
relative pose of frame f is pose0 @ inv(pose_f); the noisy pose init adds
y-axis Euler noise N * pi/16 - pi/32 and translation noise N / 100 to the
frames after 0. Ray grids are stored per view, and a batch gathers (view,
pixel) rays and (frame, view, pixel) targets by index.
"""

from __future__ import annotations

import dataclasses
import os
import re
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import rays as ray_ops
from ..ops.lie import matrix_to_se3
from ..utils.logging import read_png
from . import transforms

CAR_SEMANTIC_ID = 10


def natural_keys(text: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


@dataclasses.dataclass
class CarlaConfig:
    datadir: str
    num_frames: int
    num_vehicles: int = 1
    has_depth_data: bool = False
    scale_factor: float = 0.01
    near: float = 3.0
    far: float = 80.0
    eval_last_frame: int = 0  # 0 = all frames
    crop_box: tuple = (100, 300, 100, 300)  # precrop window (y0,y1,x0,x1)


def load_intrinsics(datadir: str):
    d = np.load(os.path.join(datadir, "intrinsics.npy"), allow_pickle=True).item()
    H, W, fov = int(d["h"]), int(d["w"]), float(d["fov"])
    return H, W, ray_ops.focal_from_fov(W, fov)


def _decode_carla_depth(depth_img: np.ndarray) -> np.ndarray:
    """24-bit RGB-encoded depth -> metres."""
    d = depth_img.astype(np.float64)
    normalized = (d[..., 0] + d[..., 1] * 256.0 + d[..., 2] * 256.0 * 256.0) / (
        256.0 ** 3 - 1.0)
    return (1000.0 * normalized).astype(np.float32)


def _view_split_indices(n_cameras: int, split: str):
    if split == "train":
        return [i for i in range(n_cameras) if i < 50]
    if split == "val":
        return [i for i in range(n_cameras) if 50 <= i <= 55]
    if split == "test":
        return [i for i in range(n_cameras) if i > 55]
    raise ValueError(f"invalid split {split}")


class CarlaScene:
    """Loads one CARLA capture into host arrays, per split."""

    def __init__(self, cfg: CarlaConfig, split: str, max_frames: Optional[int] = None):
        self.cfg = cfg
        self.split = split
        self._car_pools = {}  # (start, end, vlo, vhi) -> [M, 4] (v, f, y, x) car pixels
        H, W, focal = load_intrinsics(cfg.datadir)
        self.H, self.W, self.focal = H, W, focal
        self.K = ray_ops.intrinsics_matrix(H, W, focal)

        extrinsics = np.load(os.path.join(cfg.datadir, "extrinsics.npy"),
                             allow_pickle=True).item()
        cameras = sorted(glob(os.path.join(cfg.datadir, "camera*/")), key=natural_keys)
        view_ids = _view_split_indices(len(cameras), split)

        n_frames = max_frames or cfg.num_frames
        imgs, poses, semantic, depth = [], [], [], []
        for i in view_ids:
            rgb_paths, sem_paths, depth_paths = [], [], []
            for path in sorted(glob(os.path.join(cameras[i], "*.png")), key=natural_keys):
                if path.endswith("_semantic.png"):
                    sem_paths.append(path)
                elif path.endswith("_depth.png"):
                    depth_paths.append(path)
                else:
                    rgb_paths.append(path)
            imgs.append([read_png(p) for p in rgb_paths[:n_frames]])
            semantic.append([read_png(p)[..., 0] for p in sem_paths[:n_frames]])
            if cfg.has_depth_data:
                depth.append([_decode_carla_depth(read_png(p)) for p in depth_paths[:n_frames]])
            poses.append(transforms.from_ue4_to_nerf(np.asarray(extrinsics[i])))

        self.images = (np.asarray(imgs, dtype=np.float32) / 255.0)[..., :3]  # [V, F, H, W, 3]
        self.semantic = np.asarray(semantic, dtype=np.uint8) if semantic and semantic[0] else None
        self.depths = np.asarray(depth, dtype=np.float32) if cfg.has_depth_data else None
        self.poses = np.asarray(poses, dtype=np.float32)  # [V, 4, 4]

        self.near, self.far = cfg.near, cfg.far
        if cfg.scale_factor > 0:
            self.near *= cfg.scale_factor
            self.far *= cfg.scale_factor
            self.poses[:, :3, 3] *= cfg.scale_factor
            if self.depths is not None:
                self.depths *= cfg.scale_factor

        if split == "test" and cfg.eval_last_frame:
            self.images = self.images[:, :cfg.eval_last_frame]
            if self.semantic is not None:
                self.semantic = self.semantic[:, :cfg.eval_last_frame]
            if self.depths is not None:
                self.depths = self.depths[:, :cfg.eval_last_frame]

        # per-view ray grids [V, H, W, 3] (not replicated per frame)
        grids = [ray_ops.get_rays_np(H, W, self.K, p[:3, :4]) for p in self.poses]
        self.rays_o = np.stack([g[0] for g in grids]).astype(np.float32)
        self.rays_d = np.stack([g[1] for g in grids]).astype(np.float32)

        bboxes_path = os.path.join(cfg.datadir, "bboxes.npy")
        self.bboxes = (np.load(bboxes_path, allow_pickle=True)
                       if os.path.exists(bboxes_path) else None)

    # ---------------- GT vehicle poses ----------------

    def _vehicle_pose_files(self):
        posedir = os.path.join(self.cfg.datadir, "poses")
        vehicle_dirs = sorted(os.listdir(posedir), key=natural_keys)
        return [sorted(glob(os.path.join(posedir, v, "*.npy")), key=natural_keys)
                for v in vehicle_dirs[:self.cfg.num_vehicles]]

    def _nerf_pose(self, path):
        p = transforms.from_ue4_to_nerf(np.load(path))
        if self.cfg.scale_factor > 0:
            p[:3, 3] *= self.cfg.scale_factor
        return p

    def gt_vehicle_poses(self) -> np.ndarray:
        """World->vehicle (inverse) poses per frame, [K, F, 4, 4]."""
        return np.stack([np.stack([transforms.invert_transformation(self._nerf_pose(f))
                                   for f in files[:self.cfg.num_frames]])
                         for files in self._vehicle_pose_files()]).astype(np.float32)

    def gt_relative_poses(self) -> np.ndarray:
        """7-vec poses [K, F, 7]: pose0 @ inv(pose_f), mapping frame-f world
        points into the frame-0 canonical vehicle frame."""
        out = []
        for files in self._vehicle_pose_files():
            mats = [self._nerf_pose(f) for f in files[:self.cfg.num_frames]]
            out.append(np.stack([np.eye(4, dtype=np.float32)]
                                + [mats[0] @ transforms.invert_transformation(p)
                                   for p in mats[1:]]))
        mats = np.stack(out).astype(np.float32)  # [K, F, 4, 4]
        return matrix_to_se3(torch.from_numpy(mats)).numpy()

    def noisy_gt_relative_poses(self, rng: np.random.Generator) -> np.ndarray:
        """Noisy init for online training [K, F, 7]: y-axis Euler noise
        (N * pi/16 - pi/32) and translation noise (N / 100) on frames >= 1."""
        from scipy.spatial.transform import Rotation

        gt = self.gt_relative_poses()  # [K, F, 7]
        K, F = gt.shape[:2]
        noisy = np.zeros_like(gt)
        for k in range(K):
            eul = Rotation.from_quat(gt[k, :, 3:7]).as_euler("xyz")
            trans = gt[k, :, :3].copy()
            eul[1:, 1] += rng.standard_normal(F - 1) * np.pi / 16 - np.pi / 32
            trans[1:] += rng.standard_normal((F - 1, 3)) / 100.0
            q = Rotation.from_euler("xyz", eul).as_quat()
            noisy[k] = np.concatenate([trans, q], axis=-1)
        return noisy.astype(np.float32)

    def bbox_local_vertices(self) -> Optional[np.ndarray]:
        """[K, 8, 3] scaled NeRF-frame bbox corners."""
        if self.bboxes is None:
            return None
        return np.stack([
            self.cfg.scale_factor * transforms.from_ue4_to_nerf_pts(
                np.asarray(self.bboxes[i]["local_vertices"], dtype=np.float32))
            for i in range(self.cfg.num_vehicles)])

    # ---------------- batch sampling ----------------

    def _car_pool(self, start: int, end: int, view_range=None) -> np.ndarray:
        """Cached (v, f, y, x) indices of car pixels in the frame window."""
        vlo, vhi = view_range or (0, self.images.shape[0])
        key = (start, end, vlo, vhi)
        if key not in self._car_pools:
            m = self.semantic[vlo:vhi, start:end] == CAR_SEMANTIC_ID
            v, f, y, x = np.nonzero(m)
            self._car_pools[key] = np.stack([v + vlo, f + start, y, x], axis=-1)
        return self._car_pools[key]

    def _crop_pixels(self, rng, n_rand):
        y0, y1, x0, x1 = self.cfg.crop_box
        return (rng.integers(y0, min(y1, self.H), n_rand),
                rng.integers(x0, min(x1, self.W), n_rand))

    def sample_batch(
        self,
        rng: np.random.Generator,
        n_rand: int,
        start_frame: int = 0,
        current_frame: int = 1,
        car_sample_ratio: float = 0.0,
        crop: bool = False,
        frame: Optional[int] = None,
        mixed_frames: bool = False,
        ghost_sample_ratio: float = 0.0,
        frame0_sample_ratio: float = 0.0,
        view_range=None,
    ) -> Dict[str, np.ndarray]:
        """Random ray minibatch from a random in-window frame, startrax's
        draws in startrax's order.

        mixed_frames=True samples each ray's frame independently from the
        window (batch["frame"] becomes an [N] int array). ghost_sample_ratio
        reserves rays through car pixels of another in-window frame,
        frame0_sample_ratio rays through frame-0 car pixels; either forces
        the mixed layout (both need semantics). car_sample_ratio reserves
        rays through car pixels; crop draws pixels from crop_box.
        view_range=(lo, hi) restricts sampling to that half-open view
        subset."""
        V = self.images.shape[0]
        vlo, vhi = view_range or (0, V)
        if ghost_sample_ratio > 0 or frame0_sample_ratio > 0:
            mixed_frames = True
        if mixed_frames and frame is None:
            f = rng.integers(start_frame, current_frame, size=n_rand)
            v = rng.integers(vlo, vhi, n_rand)
            if crop:
                y, x = self._crop_pixels(rng, n_rand)
            else:
                y = rng.integers(0, self.H, n_rand)
                x = rng.integers(0, self.W, n_rand)
            lo = 0
            n_car = int(n_rand * car_sample_ratio)
            if n_car > 0 and not crop and self.semantic is not None:
                pool = self._car_pool(start_frame, current_frame, view_range)
                if len(pool):
                    picks = pool[rng.integers(0, len(pool), size=n_car)]
                    v[:n_car], f[:n_car], y[:n_car], x[:n_car] = picks.T
                    lo = n_car
            if self.semantic is not None and not crop:
                n_ghost = int(n_rand * ghost_sample_ratio)
                if n_ghost > 0 and current_frame - start_frame > 1:
                    pool = self._car_pool(start_frame, current_frame, view_range)
                    if len(pool):
                        hi = min(lo + n_ghost, n_rand)
                        picks = pool[rng.integers(0, len(pool), size=hi - lo)]
                        pv, pf, py, px = picks.T
                        shift = rng.integers(1, current_frame - start_frame, size=hi - lo)
                        other = start_frame + (pf - start_frame + shift) % (
                            current_frame - start_frame)
                        v[lo:hi], f[lo:hi], y[lo:hi], x[lo:hi] = pv, other, py, px
                        lo = hi
                n_f0 = int(n_rand * frame0_sample_ratio)
                if n_f0 > 0 and start_frame == 0:
                    pool0 = self._car_pool(0, 1, view_range)
                    if len(pool0):
                        hi = min(lo + n_f0, n_rand)
                        picks = pool0[rng.integers(0, len(pool0), size=hi - lo)]
                        v[lo:hi], f[lo:hi], y[lo:hi], x[lo:hi] = picks.T
                        lo = hi
            return self._gather(v, f, y, x, f.astype(np.int32))
        if frame is None:
            frame = int(rng.integers(start_frame, current_frame))

        if crop:
            v = rng.integers(vlo, vhi, n_rand)
            y, x = self._crop_pixels(rng, n_rand)
        elif car_sample_ratio > 0 and self.semantic is not None:
            n_car = int(n_rand * car_sample_ratio)
            car_mask = self.semantic[vlo:vhi, frame] == CAR_SEMANTIC_ID
            car_idx = np.argwhere(car_mask)
            noncar_idx = np.argwhere(~car_mask)
            pick_car = (car_idx[rng.integers(0, max(len(car_idx), 1), n_car)] if len(car_idx)
                        else np.zeros((0, 3), int))
            pick_non = noncar_idx[rng.integers(0, len(noncar_idx), n_rand - len(pick_car))]
            picks = np.concatenate([pick_car, pick_non], axis=0)
            picks = picks[rng.permutation(len(picks))]
            v, y, x = picks[:, 0] + vlo, picks[:, 1], picks[:, 2]
        else:
            v = rng.integers(vlo, vhi, n_rand)
            y = rng.integers(0, self.H, n_rand)
            x = rng.integers(0, self.W, n_rand)
        return self._gather(v, frame, y, x, np.int32(frame))

    def _gather(self, v, f, y, x, frame):
        batch = {"rays_o": self.rays_o[v, y, x], "rays_d": self.rays_d[v, y, x],
                 "target": self.images[v, f, y, x], "frame": frame}
        if self.depths is not None:
            batch["target_depth"] = self.depths[v, f, y, x]
        return batch

    def view_rays(self, view: int):
        """Full-frame rays for one view: ([H, W, 3], [H, W, 3])."""
        return self.rays_o[view], self.rays_d[view]
