"""Procedural multi-view dynamic scene for tests and benchmarks (PyTorch).

Counterpart of startrax/data/synthetic.py: an analytic static density field
plus K rigid "vehicles" moving along known SE(3) trajectories, rendered by a
fine ray march into pixel-exact supervision, so that appearance init must
reconstruct the static field and online training must recover the known
vehicle poses from photometric loss alone.

The ground-truth marcher (``SyntheticScene.march``) is elementwise float32
PyTorch on the device the caller resolves (device.resolve: the card by
default, the CPU when asked by name), over chunks of image rows. It has no
matrix product, so no TF32 rounding can enter on the card. Its plain version
is the numpy marcher (``march_numpy``, ``_render_frame_numpy``), which the
tests and chip_smoke.py hold it against; it is never chosen in its place.

The on-disk cache is the JAX package's: the same format version, file-name
rule and key (every field of the SyntheticScene dataclass, the view count
and the version), so either package reads a cache that the other wrote.
Batch sampling is numpy, the same draws as startrax's for one generator.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..device import resolve
from ..ops import lie
from ..ops import rays as ray_ops

# bump when scene-generation code changes (invalidates on-disk caches); the
# JAX package reads and writes the same version
_CACHE_VERSION = 3

# the largest [rows, W, S, 3] float32 tensor of one chunk of the marcher
_MARCH_CHUNK_BYTES = 64 << 20

# --------------------------------------------------------------------------
# Analytic fields: a handful of colored Gaussian blobs + a ground slab.
# --------------------------------------------------------------------------

_STATIC_BLOBS = np.array(
    [
        # x, y, z, radius, sigma_peak, r, g, b
        [0.0, -0.1, 0.0, 0.55, 28.0, 0.9, 0.25, 0.2],
        [0.9, 0.15, -0.5, 0.4, 24.0, 0.2, 0.8, 0.3],
        [-0.8, 0.05, -0.4, 0.45, 24.0, 0.25, 0.35, 0.9],
        [0.2, 0.6, 0.6, 0.3, 20.0, 0.9, 0.85, 0.2],
    ],
    dtype=np.float32,
)

_VEHICLE_COLORS = np.array(
    [[0.95, 0.55, 0.1], [0.1, 0.9, 0.9], [0.8, 0.1, 0.8]], dtype=np.float32
)

_VEHICLE_SCALES = np.array([0.45, 0.18, 0.22], np.float32)


def static_sigma_rgb(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic static field. pts [..., 3] -> (sigma [...], rgb [..., 3])."""
    sigma = np.zeros(pts.shape[:-1], np.float32)
    rgb_acc = np.zeros(pts.shape[:-1] + (3,), np.float32)
    for bx, by, bz, rad, peak, r, g, b in _STATIC_BLOBS:
        d2 = np.sum((pts - np.array([bx, by, bz], np.float32)) ** 2, -1)
        s = peak * np.exp(-d2 / (2 * rad * rad / 9.0))
        sigma += s
        rgb_acc += s[..., None] * np.array([r, g, b], np.float32)
    # ground slab at y = -1
    ground = 20.0 * np.exp(-((pts[..., 1] + 1.0) ** 2) / 0.005)
    sigma += ground
    rgb_acc += ground[..., None] * np.array([0.45, 0.45, 0.5], np.float32)
    rgb = rgb_acc / np.maximum(sigma[..., None], 1e-8)
    return sigma, np.clip(rgb, 0.0, 1.0)


def vehicle_sigma_rgb(pts_canonical: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic vehicle k in its canonical frame: an anisotropic super-
    Gaussian (sharp-edged box-like blob, long axis = x) with a striped
    texture, which keeps the SE(3) pose photometrically observable."""
    q = np.sum((pts_canonical / _VEHICLE_SCALES) ** 4, -1)
    sigma = 80.0 * np.exp(-q / 2.0)
    base = _VEHICLE_COLORS[k % 3]
    x, y, z = pts_canonical[..., 0], pts_canonical[..., 1], pts_canonical[..., 2]
    stripes = 0.55 + 0.45 * np.sin(14.0 * x) * np.sin(9.0 * y + 3.0 * z)
    rgb = base * stripes[..., None]
    return sigma.astype(np.float32), np.clip(rgb, 0.0, 1.0).astype(np.float32)


def _march_chunk(rays_o, rays_d, z, Rk, tk, colors):
    """The marcher on rays [r, W, 3] and depths z [S] (float32 tensors on one
    device): the math of the numpy marcher, elementwise. Rk [K, 3, 3] and
    tk [K, 3] (float32 numpy) map world points into each vehicle's frame,
    colors [K, 3] its base colour. Returns (rgb [r, W, 3], depth [r, W],
    dyn_mask [r, W] bool)."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[:, None]  # [r, W, S, 3]
    sigma = torch.zeros(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    rgb_acc = torch.zeros_like(pts)
    for bx, by, bz, rad, peak, r, g, b in _STATIC_BLOBS:
        center = pts.new_tensor([bx, by, bz])
        d2 = torch.sum((pts - center) ** 2, -1)
        s = float(peak) * torch.exp(-d2 / float(2 * rad * rad / np.float32(9.0)))
        sigma = sigma + s
        rgb_acc = rgb_acc + s[..., None] * pts.new_tensor([r, g, b])
    ground = 20.0 * torch.exp(-((pts[..., 1] + 1.0) ** 2) / 0.005)
    sigma = sigma + ground
    rgb_acc = rgb_acc + ground[..., None] * pts.new_tensor([0.45, 0.45, 0.5])
    sigma_static = sigma

    scales = pts.new_tensor(_VEHICLE_SCALES)
    x, y, zz = pts.unbind(-1)
    for R, t, color in zip(Rk, tk, colors):
        # R @ p + t as multiply-adds: no matrix product, so no TF32
        pts_can = torch.stack([float(R[i, 0]) * x + float(R[i, 1]) * y + float(R[i, 2]) * zz
                               + float(t[i]) for i in range(3)], -1)
        s_k = 80.0 * torch.exp(-torch.sum((pts_can / scales) ** 4, -1) / 2.0)
        cx, cy, cz = pts_can.unbind(-1)
        stripes = 0.55 + 0.45 * torch.sin(14.0 * cx) * torch.sin(9.0 * cy + 3.0 * cz)
        rgb_k = torch.clamp(pts.new_tensor(color) * stripes[..., None], 0.0, 1.0)
        sigma = sigma + s_k
        rgb_acc = rgb_acc + s_k[..., None] * rgb_k

    rgb = torch.clamp(rgb_acc / torch.clamp(sigma[..., None], min=1e-8), 0.0, 1.0)
    dists = torch.diff(z, append=(z[-1] + (z[1] - z[0]))[None])
    dists = dists * torch.linalg.vector_norm(rays_d, dim=-1)[..., None]
    alpha = 1.0 - torch.exp(-sigma * dists)
    T = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                      -1)[..., :-1]
    w = alpha * T
    img = torch.sum(w[..., None] * rgb, -2)
    depth = torch.sum(w * z, -1)
    sigma_dyn = sigma - sigma_static
    dyn_mask = torch.sum(w * (sigma_dyn > 0.5 * sigma), -1) > 0.1
    return img, depth, dyn_mask


# --------------------------------------------------------------------------
# Scene
# --------------------------------------------------------------------------


def _look_at(eye: np.ndarray, center: np.ndarray, up=np.array([0.0, 1.0, 0.0])):
    """c2w matrix in NeRF convention (camera looks along -z)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f
    c2w[:3, 3] = eye
    return c2w


def _quat_from_yaw(yaw: float) -> np.ndarray:
    return np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)], np.float32)


@dataclasses.dataclass
class SyntheticScene:
    """A ring of cameras around an origin-centered scene with K vehicles
    translating/yawing over F frames. Its fields are the cache key's (with
    startrax's SyntheticScene): add none that does not change the data."""

    num_vehicles: int = 1
    num_frames: int = 8
    H: int = 64
    W: int = 64
    focal: float = 64.0
    near: float = 2.0
    far: float = 8.0
    n_march: int = 192  # samples for ground-truth marching
    cam_radius: float = 4.0
    cam_height: float = 1.2

    @property
    def K(self) -> np.ndarray:
        return ray_ops.intrinsics_matrix(self.H, self.W, self.focal)

    def camera(self, view: int, num_views: int) -> np.ndarray:
        ang = 2 * np.pi * view / num_views
        eye = np.array(
            [self.cam_radius * np.cos(ang), self.cam_height, self.cam_radius * np.sin(ang)],
            np.float32,
        )
        return _look_at(eye, np.zeros(3, np.float32))

    def view_rays(self, view: int, num_views: int):
        """(rays_o, rays_d), each [H, W, 3] float32 numpy, of a view."""
        return ray_ops.get_rays_np(self.H, self.W, self.K, self.camera(view, num_views))

    def gt_pose_world(self, frame: int, k: int) -> np.ndarray:
        """World-from-canonical pose of vehicle k at `frame`, as a 7-vec.

        Vehicle 0 translates along x with slight yaw; vehicle 1 along z."""
        t = frame / max(self.num_frames - 1, 1)
        if k % 2 == 0:
            trans = np.array([-1.2 + 2.4 * t, -0.55, 1.1], np.float32)
            yaw = 0.3 * t
        else:
            trans = np.array([1.0, -0.55, -1.3 + 2.2 * t], np.float32)
            yaw = -0.25 * t
        return np.concatenate([trans, _quat_from_yaw(yaw)]).astype(np.float32)

    def gt_relative_pose(self, frame: int, k: int) -> np.ndarray:
        """The pose the model applies to world points at `frame`: the inverse
        of the world pose, so that warped points land in the vehicle frame."""
        p = self.gt_pose_world(frame, k)
        R = Rotation.from_quat(p[3:]).as_matrix().astype(np.float32)
        t = p[:3]
        Rinv = R.T
        tinv = -Rinv @ t
        q = Rotation.from_matrix(Rinv).as_quat().astype(np.float32)
        return np.concatenate([tinv, q]).astype(np.float32)

    def _vehicle_frames(self, frame: int):
        """(Rk [K, 3, 3], tk [K, 3]) float32: each vehicle's pose at frame."""
        poses = [self.gt_relative_pose(frame, k) for k in range(self.num_vehicles)]
        Rk = np.stack([Rotation.from_quat(p[3:]).as_matrix() for p in poses])
        tk = np.stack([p[:3] for p in poses])
        return Rk.reshape(-1, 3, 3).astype(np.float32), tk.reshape(-1, 3).astype(np.float32)

    def sigma_rgb_at(self, pts: np.ndarray, frame: int):
        """Total scene density/color at world pts for a given frame."""
        sigma, rgb = static_sigma_rgb(pts)
        rgb_acc = sigma[..., None] * rgb
        for k, (R, t) in enumerate(zip(*self._vehicle_frames(frame))):
            pts_can = np.einsum("ij,...j->...i", R, pts) + t
            s_k, rgb_k = vehicle_sigma_rgb(pts_can, k)
            sigma += s_k
            rgb_acc += s_k[..., None] * rgb_k
        rgb = rgb_acc / np.maximum(sigma[..., None], 1e-8)
        return sigma, np.clip(rgb, 0.0, 1.0)

    def march(self, rays_o, rays_d, frame: int, device=None):
        """Ground-truth march of rays [h, w, 3] (numpy) at `frame` on
        ``device`` (None: the card, device.resolve), in chunks of rows.
        Returns numpy (rgb [h, w, 3], depth [h, w], dyn_mask [h, w] bool)."""
        device = resolve(device)
        h, w = rays_o.shape[:2]
        rows = max(1, _MARCH_CHUNK_BYTES // (w * self.n_march * 3 * 4))
        z = torch.from_numpy(np.linspace(self.near, self.far, self.n_march,
                                         dtype=np.float32)).to(device)
        Rk, tk = self._vehicle_frames(frame)
        colors = [_VEHICLE_COLORS[k % 3] for k in range(self.num_vehicles)]
        outs = []
        for r0 in range(0, h, rows):
            o, d = (torch.as_tensor(np.ascontiguousarray(a[r0:r0 + rows]), dtype=torch.float32,
                                    device=device) for a in (rays_o, rays_d))
            outs.append([t.cpu().numpy() for t in _march_chunk(o, d, z, Rk, tk, colors)])
        return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))

    def march_numpy(self, rays_o, rays_d, frame: int):
        """The numpy marcher: the plain version of ``march``."""
        z = np.linspace(self.near, self.far, self.n_march, dtype=np.float32)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[:, None]  # [h, w, S, 3]

        sigma, rgb = self.sigma_rgb_at(pts, frame)
        sigma_static, _ = static_sigma_rgb(pts)

        dists = np.diff(z, append=z[-1] + (z[1] - z[0]))
        dists = dists * np.linalg.norm(rays_d, axis=-1)[..., None]
        alpha = 1.0 - np.exp(-sigma * dists)
        T = np.cumprod(
            np.concatenate([np.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1), -1
        )[..., :-1]
        w = alpha * T
        img = np.sum(w[..., None] * rgb, axis=-2)
        depth = np.sum(w * z, axis=-1)

        # dynamic mask: rays whose visible weight is dominated by dynamic density
        sigma_dyn = sigma - sigma_static
        dyn_mask = np.sum(w * (sigma_dyn > 0.5 * sigma), axis=-1) > 0.1
        return img.astype(np.float32), depth.astype(np.float32), dyn_mask

    def render_frame(self, view: int, num_views: int, frame: int, device=None):
        """Ground-truth render of a view at a frame by ``march`` on
        ``device`` (None: the card). Returns (rgb [H,W,3], depth [H,W],
        dyn_mask [H,W] bool) as numpy."""
        return self.march(*self.view_rays(view, num_views), frame, device=device)

    def _render_frame_numpy(self, view: int, num_views: int, frame: int):
        """render_frame's plain version, by the numpy marcher."""
        return self.march_numpy(*self.view_rays(view, num_views), frame)

    def make_dataset(self, num_views: int = 6, frames=None,
                     device=None) -> Dict[str, np.ndarray]:
        """All views x frames, marched on ``device`` (None: the card): images,
        rays, depths, masks, GT poses, as numpy."""
        device = resolve(device)
        frames = list(range(self.num_frames)) if frames is None else frames
        imgs, depths, masks, rays_o_all, rays_d_all = [], [], [], [], []
        for v in range(num_views):
            ro, rd = self.view_rays(v, num_views)
            row_i, row_d, row_m = [], [], []
            for f in frames:
                img, dep, m = self.march(ro, rd, f, device=device)
                row_i.append(img)
                row_d.append(dep)
                row_m.append(m)
            imgs.append(np.stack(row_i))
            depths.append(np.stack(row_d))
            masks.append(np.stack(row_m))
            rays_o_all.append(ro)
            rays_d_all.append(rd)
        gt_rel = np.stack(
            [
                np.stack([self.gt_relative_pose(f, k) for k in range(self.num_vehicles)])
                for f in frames
            ]
        )  # [F, K, 7]
        return {
            "images": np.stack(imgs),  # [V, F, H, W, 3]
            "depths": np.stack(depths),  # [V, F, H, W]
            "dyn_masks": np.stack(masks),  # [V, F, H, W]
            "rays_o": np.stack(rays_o_all),  # [V, H, W, 3]
            "rays_d": np.stack(rays_d_all),  # [V, H, W, 3]
            "gt_relative_poses": gt_rel,  # [F, K, 7]
        }


def cache_key(scene: SyntheticScene, total_views: int) -> str:
    """The in-process memo key: every field of the scene, the view count and
    the format version, as the JAX package builds it."""
    return json.dumps({"views": total_views, "version": _CACHE_VERSION,
                       **dataclasses.asdict(scene)}, sort_keys=True)


def cache_file(scene: SyntheticScene, total_views: int) -> str:
    """The cache's file name in its directory, as the JAX package names it."""
    digest = hashlib.sha1(cache_key(scene, total_views).encode()).hexdigest()[:16]
    return (f"synth_v{total_views}_f{scene.num_frames}_h{scene.H}"
            f"_k{scene.num_vehicles}_{digest}.npz")


# in-process memo so the train and val splits of the same scene share one
# generated dataset
_GEN_MEMO: Dict[str, Dict[str, np.ndarray]] = {}


class SyntheticAdapter:
    """Dataset-style facade over SyntheticScene with CarlaScene's sampling
    API (used by the apps and tests).

    num_val_views > 0 generates that many extra views held out from training:
    split="train" exposes the first `num_views`, split="val"/"test" the
    held-out tail. The dataset comes from the in-process memo, else from the
    cache in ``cache_dir``, else it is generated on ``device`` (None: the
    card) and, with a ``cache_dir``, written there atomically."""

    def __init__(self, scene: SyntheticScene, num_views: int = 6,
                 cache_dir: str = "", split: str = "train",
                 num_val_views: int = 0, device=None):
        self.scene = scene
        total_views = num_views + num_val_views
        desc = cache_key(scene, total_views)
        if desc in _GEN_MEMO:
            self.data = _GEN_MEMO[desc]
        elif cache_dir:
            path = os.path.join(cache_dir, cache_file(scene, total_views))
            if os.path.exists(path):
                with np.load(path) as z:
                    self.data = {k: z[k] for k in z.files}
            else:
                self.data = scene.make_dataset(num_views=total_views, device=device)
                os.makedirs(cache_dir, exist_ok=True)
                # a name of this process's own: ranks may write at once
                tmp = f"{path}.{os.getpid()}.tmp.npz"
                np.savez(tmp, **self.data)
                os.replace(tmp, path)
        else:
            self.data = scene.make_dataset(num_views=total_views, device=device)
        _GEN_MEMO[desc] = self.data

        if num_val_views > 0:
            sl = (slice(0, num_views) if split == "train"
                  else slice(num_views, total_views))
            self.data = dict(self.data)
            for k in ("images", "depths", "dyn_masks", "rays_o", "rays_d"):
                self.data[k] = self.data[k][sl]
        self.images = self.data["images"]
        self.depths = self.data["depths"]  # [V, F, H, W] analytic depth
        self.rays_o = self.data["rays_o"]
        self.rays_d = self.data["rays_d"]
        self.near, self.far = scene.near, scene.far
        self.H, self.W = scene.H, scene.W
        self._car_pools = {}  # (start, end, vlo, vhi) -> [M, 4] (v, f, y, x) car pixels

    def _car_pool(self, start: int, end: int,
                  view_range=None) -> np.ndarray:
        vlo, vhi = view_range or (0, self.images.shape[0])
        key = (start, end, vlo, vhi)
        if key not in self._car_pools:
            m = self.data["dyn_masks"][vlo:vhi, start:end]  # [V', F', H, W]
            v, f, y, x = np.nonzero(m)
            self._car_pools[key] = np.stack([v + vlo, f + start, y, x], axis=-1)
        return self._car_pools[key]

    def sample_batch(self, rng, n_rand, start_frame=0, current_frame=1, frame=None,
                     car_sample_ratio=0.0, mixed_frames=False,
                     ghost_sample_ratio=0.0, frame0_sample_ratio=0.0,
                     view_range=None, **_):
        """Random ray minibatch, the same draws as startrax's sample_batch.

        mixed_frames=True samples each ray's frame independently from the
        window (batch["frame"] becomes an [N] int array); car_sample_ratio
        reserves that fraction of rays for pixels on a vehicle;
        ghost_sample_ratio reserves rays through vehicle pixels of a
        different in-window frame; frame0_sample_ratio pins rays to frame-0
        vehicle pixels. Both of the last force the mixed-frame layout.
        view_range=(lo, hi) restricts sampling to that half-open view
        subset."""
        if ghost_sample_ratio > 0 or frame0_sample_ratio > 0:
            mixed_frames = True
        if not mixed_frames:
            if frame is None:
                frame = int(rng.integers(start_frame, current_frame))
            return sample_ray_batch(
                rng, self.data, n_rand, frame,
                car_sample_ratio=car_sample_ratio, view_range=view_range
            )

        V, F, H, W, _ = self.data["images"].shape
        vlo, vhi = view_range or (0, V)
        v = rng.integers(vlo, vhi, size=n_rand)
        f = rng.integers(start_frame, current_frame, size=n_rand)
        y = rng.integers(0, H, size=n_rand)
        x = rng.integers(0, W, size=n_rand)
        lo = 0
        n_car = int(n_rand * car_sample_ratio)
        if n_car > 0:
            pool = self._car_pool(start_frame, current_frame, view_range)
            if len(pool):
                picks = pool[rng.integers(0, len(pool), size=n_car)]
                v[lo:n_car], f[lo:n_car], y[lo:n_car], x[lo:n_car] = picks.T
                lo = n_car
        n_ghost = int(n_rand * ghost_sample_ratio)
        if n_ghost > 0 and current_frame - start_frame > 1:
            pool = self._car_pool(start_frame, current_frame, view_range)
            if len(pool):
                hi = min(lo + n_ghost, n_rand)
                picks = pool[rng.integers(0, len(pool), size=hi - lo)]
                pv, pf, py, px = picks.T
                # redraw each ray's frame from the window EXCLUDING the frame
                # the pixel's vehicle mask came from
                shift = rng.integers(1, current_frame - start_frame, size=hi - lo)
                other = start_frame + (pf - start_frame + shift) % (
                    current_frame - start_frame)
                v[lo:hi], f[lo:hi], y[lo:hi], x[lo:hi] = pv, other, py, px
                lo = hi
        n_f0 = int(n_rand * frame0_sample_ratio)
        if n_f0 > 0 and start_frame == 0:
            hi = min(lo + n_f0, n_rand)
            # anchor rays: frame-0 VEHICLE pixels (the identity pose only
            # constrains the dynamic field where the vehicle is visible)
            pool0 = self._car_pool(0, 1, view_range)
            if len(pool0):
                picks = pool0[rng.integers(0, len(pool0), size=hi - lo)]
                v[lo:hi], f[lo:hi], y[lo:hi], x[lo:hi] = picks.T
            else:
                f[lo:hi] = 0
            lo = hi
        return {
            "rays_o": self.data["rays_o"][v, y, x],
            "rays_d": self.data["rays_d"][v, y, x],
            "target": self.data["images"][v, f, y, x],
            "target_depth": self.data["depths"][v, f, y, x],
            "frame": f.astype(np.int32),
        }

    def view_rays(self, view: int):
        return self.rays_o[view], self.rays_d[view]

    # the synthetic scene's canonical vehicle frame is origin-centered (the
    # model pose IS world->vehicle), unlike CARLA where the canonical frame
    # is the frame-0 placement — the test protocol's bbox math and its
    # frame-0 trajectory entry branch on this (apps/test_protocol.py)
    bbox_rebase_frame0 = False

    def bbox_local_vertices(self) -> np.ndarray:
        """[K, 8, 3] canonical-frame bbox corners of the analytic vehicles:
        the sigma = 1 iso-extent of the super-Gaussian 80 * exp(-q/2),
        q = sum((p / scales)^4) -> half-extent = scales * (2 ln 80)^(1/4)."""
        ext = _VEHICLE_SCALES * (2.0 * np.log(80.0)) ** 0.25
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32)
        K = self.scene.num_vehicles
        return np.broadcast_to(corners * ext, (K, 8, 3)).copy()

    def gt_vehicle_poses(self) -> np.ndarray:
        """[K, F, 4, 4] world->vehicle GT pose matrices."""
        K, F = self.scene.num_vehicles, self.scene.num_frames
        out = np.zeros((K, F, 4, 4), np.float32)
        for k in range(K):
            for f in range(F):
                p = self.scene.gt_relative_pose(f, k)
                out[k, f, :3, :3] = Rotation.from_quat(p[3:]).as_matrix()
                out[k, f, :3, 3] = p[:3]
                out[k, f, 3, 3] = 1.0
        return out

    def gt_relative_poses(self):
        # [K, F, 7] to match CarlaScene's convention
        return np.swapaxes(self.data["gt_relative_poses"], 0, 1)

    def noisy_gt_relative_poses(self, rng):
        """The GT poses [K, F, 7] composed with a random tangent (std 0.05
        per component, frame 0 untouched), drawn from the numpy generator;
        the composition runs on the host (CPU tensors)."""
        gt = self.gt_relative_poses()  # [K, F, 7]
        tau = rng.normal(size=gt.shape[:-1] + (6,)).astype(np.float32) * 0.05
        tau[:, 0] = 0.0
        noisy = lie.se3_multiply(torch.from_numpy(np.ascontiguousarray(gt)),
                                 lie.se3_exp(torch.from_numpy(tau)))
        return noisy.numpy()


def sample_ray_batch(rng, data, n_rand: int, frame: int, car_sample_ratio: float = 0.0,
                     view_range=None):
    """Random ray minibatch from one frame across all views; a
    car_sample_ratio fraction of rays is drawn from vehicle pixels.
    view_range=(lo, hi) restricts to that view subset."""
    V, F, H, W, _ = data["images"].shape
    vlo, vhi = view_range or (0, V)
    v = rng.integers(vlo, vhi, size=n_rand)
    y = rng.integers(0, H, size=n_rand)
    x = rng.integers(0, W, size=n_rand)
    n_car = int(n_rand * car_sample_ratio)
    if n_car > 0:
        cv, cy, cx = np.nonzero(data["dyn_masks"][vlo:vhi, frame])
        if len(cv):
            idx = rng.integers(0, len(cv), size=n_car)
            v[:n_car], y[:n_car], x[:n_car] = cv[idx] + vlo, cy[idx], cx[idx]
    return {
        "rays_o": data["rays_o"][v, y, x],
        "rays_d": data["rays_d"][v, y, x],
        "target": data["images"][v, frame, y, x],
        "target_depth": data["depths"][v, frame, y, x],
        "frame": np.int32(frame),
    }
