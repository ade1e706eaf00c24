"""Blender synthetic-scene loader (NeRF lego format, host-side numpy).

Counterpart of startrax/data/blender.py: transforms_{train,val,test}.json
with camera_angle_x and per-frame transform_matrix; every testskip-th frame
of the val and test splits; RGBA images composited onto a white (or black)
background. PNG files are read with the port's own reader
(utils/logging.read_png) in place of imageio, and ``half_res`` halves the
images by the mean of each 2x2 block in place of cv2.resize(INTER_AREA),
which is that mean where the factor is exactly 2 (even H and W); odd sizes
raise. The scene stays on the host: a batch gathers (view, pixel) rays and
targets by index.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..ops import rays as ray_ops
from ..utils.logging import read_png


def halve_images(imgs: np.ndarray) -> np.ndarray:
    """[N, H, W, C] -> [N, H // 2, W // 2, C], the mean of each 2x2 block
    (cv2.resize with INTER_AREA to half size, for even H and W)."""
    n, h, w, c = imgs.shape
    if h % 2 or w % 2:
        raise ValueError(f"half_res needs an even image size, got {h}x{w}")
    return imgs.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4), dtype=imgs.dtype)


class BlenderScene:
    def __init__(self, datadir: str, split: str = "train", half_res: bool = False,
                 testskip: int = 1, white_bkgd: bool = True, near: float = 2.0,
                 far: float = 6.0):
        with open(os.path.join(datadir, f"transforms_{split}.json")) as fp:
            meta = json.load(fp)

        skip = 1 if (split == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(read_png(os.path.join(datadir, frame["file_path"] + ".png")))
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))

        imgs = (np.asarray(imgs) / 255.0).astype(np.float32)  # [N, H, W, 4]
        self.poses = np.stack(poses)

        H, W = imgs.shape[1:3]
        focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
        if half_res:
            H, W, focal = H // 2, W // 2, focal / 2.0
            imgs = halve_images(imgs)

        if imgs.shape[-1] == 4:
            rgb, alpha = imgs[..., :3], imgs[..., -1:]
            imgs = rgb * alpha + (1.0 - alpha) if white_bkgd else rgb * alpha

        self.images = imgs.astype(np.float32)  # [N, H, W, 3]
        self.H, self.W, self.focal = int(H), int(W), float(focal)
        self.K = ray_ops.intrinsics_matrix(self.H, self.W, self.focal)
        self.near, self.far = near, far

        grids = [ray_ops.get_rays_np(self.H, self.W, self.K, p[:3, :4]) for p in self.poses]
        self.rays_o = np.stack([g[0] for g in grids]).astype(np.float32)
        self.rays_d = np.stack([g[1] for g in grids]).astype(np.float32)

    def sample_batch(self, rng: np.random.Generator, n_rand: int) -> Dict[str, np.ndarray]:
        """n_rand rays of random views and pixels, with their target colours."""
        N = self.images.shape[0]
        v = rng.integers(0, N, n_rand)
        y = rng.integers(0, self.H, n_rand)
        x = rng.integers(0, self.W, n_rand)
        return {"rays_o": self.rays_o[v, y, x], "rays_d": self.rays_d[v, y, x],
                "target": self.images[v, y, x]}

    def view_rays(self, view: int):
        return self.rays_o[view], self.rays_d[view]

