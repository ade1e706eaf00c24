"""Visualization helpers: depth colormaps, value overlays, static/dynamic
composition, projected 3D bounding boxes (host-side numpy, eval-only).

The port's copy of startrax/utils/vis.py without cv2, which the card's
machine lacks: ``draw_box`` rasterises its edges itself as cv2.line(..., 1)
does (8-connected, clipped to the image, no anti-aliasing), and
``visualize_depth_with_values`` returns the colormap without the value
labels, which is what startrax returns where cv2 is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """JET colormap on [0,1] values -> [..., 3] RGB in [0,1] (no cv2 needed)."""
    x = np.clip(x, 0.0, 1.0)
    four = 4.0 * x
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def visualize_depth(depth: np.ndarray, near: Optional[float] = None, far: Optional[float] = None):
    """Depth [H, W] (or [K, H, W] batched per vehicle) -> JET RGB, normalized
    per image like the reference (utils/visualization.py:12-57)."""
    depth = np.asarray(depth, np.float32)
    if depth.ndim == 3:
        return np.stack([visualize_depth(d, near, far) for d in depth])
    lo = np.min(depth) if near is None else near
    hi = np.max(depth) if far is None else far
    x = (depth - lo) / max(hi - lo, 1e-8)
    return _jet(x)


def visualize_depth_with_values(depth: np.ndarray, grid: int = 8):
    """The depth colormap as uint8 (startrax's overlay grid without cv2:
    the unannotated colormap; ``grid`` places no labels)."""
    return (visualize_depth(depth) * 255).astype(np.uint8).copy()


def compose_static_dynamic(rgb_static: np.ndarray, rgb_dynamic: np.ndarray):
    """Side-by-side composition panel (reference utils/visualization.py:97-105)."""
    rows = [np.asarray(rgb_static)]
    rgb_dynamic = np.asarray(rgb_dynamic)
    if rgb_dynamic.ndim == 4:  # [K, H, W, 3]
        rows.extend(list(rgb_dynamic))
    else:
        rows.append(rgb_dynamic)
    return np.concatenate(rows, axis=1)


def project_points(pts_world: np.ndarray, K: np.ndarray, w2c: np.ndarray):
    """World points [N, 3] -> pixel coords [N, 2] with intrinsics K and
    world-to-camera w2c (reference get_image_point, utils/logging__.py:204-223).
    Camera follows the NeRF convention (x right, y up, -z forward)."""
    homog = np.concatenate([pts_world, np.ones((pts_world.shape[0], 1))], axis=-1)
    cam = (w2c @ homog.T).T[:, :3]
    # NeRF cam -> pinhole: flip y and z
    x = cam[:, 0] / np.maximum(-cam[:, 2], 1e-8) * K[0, 0] + K[0, 2]
    y = -cam[:, 1] / np.maximum(-cam[:, 2], 1e-8) * K[1, 1] + K[1, 2]
    return np.stack([x, y], axis=-1)


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine of a segment to the image [0, w) x [0, h): the clipped
    end points, or None when the segment misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _line_pixels(w: int, h: int, p1, p2):
    """The pixels (x, y) of cv2's 8-connected line from p1 to p2 (its
    LineIterator, left to right), clipped to the image."""
    ends = _clip_line(w, h, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]))
    if ends is None:
        return []
    x1, y1, x2, y2 = ends
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        step_minor = err < 0
        err += -2 * dy + (2 * dx if step_minor else 0)
        if vert:
            y += sy
            x += sx if step_minor else 0
        else:
            x += sx
            y += sy if step_minor else 0
    return out


def draw_box(img: np.ndarray, corners_px: np.ndarray, color=(0, 255, 0)):
    """Draw a projected 3D box wireframe onto an image (uint8, HxWx3),
    corners in the (-,+)^3 binary order used by eval.iou tests: each edge a
    1-pixel 8-connected line between the rounded corners, as cv2.line(img,
    pa, pb, color, 1) draws it."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    for a, b in _BOX_EDGES:
        pa = np.round(corners_px[a]).astype(int)
        pb = np.round(corners_px[b]).astype(int)
        for x, y in _line_pixels(w, h, pa, pb):
            img[y, x] = color
    return img
