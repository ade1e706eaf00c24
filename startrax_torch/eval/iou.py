"""2D segmentation IoU and 3D bounding-box IoU (host-side numpy, eval-only).

Counterparts of the reference compute_2d_iou / compute_3d_iou
(utils/metrics.py:487-550). The reference's 3D IoU calls pytorch3d's CUDA
box3d_overlap; here the exact intersection volume of the two convex boxes is
computed with generic convex-polyhedron intersection (vertex collection +
ConvexHull volume) — no CUDA, no vertex-order convention needed.

The port's own copy of startrax/eval/iou.py (numpy, scipy and the
standard library), kept so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import ConvexHull, QhullError


def compute_2d_iou(dynamic_transmittance, semantic_mask, thres: float = 0.1):
    """Predicted mask = any vehicle's final transmittance < thres; IoU of the
    union vs the semantic car mask (reference utils/metrics.py:527-550).

    dynamic_transmittance: [N_rays, K]; semantic_mask: [N_rays] bool.
    Returns (iou, per-vehicle predicted masks [K, N_rays])."""
    dt = np.asarray(dynamic_transmittance)
    sem = np.asarray(semantic_mask).astype(bool)
    predicted_masks = (dt < thres).T  # [K, N]
    union_pred = predicted_masks.any(axis=0)
    union = np.count_nonzero(np.logical_or(sem, union_pred))
    inter = np.count_nonzero(np.logical_and(sem, union_pred))
    iou = inter / union if union > 0 else 0.0
    return iou, predicted_masks


def _inside(pts: np.ndarray, hull: ConvexHull, tol: float = 1e-9) -> np.ndarray:
    return np.all(pts @ hull.equations[:, :3].T + hull.equations[:, 3] <= tol, axis=-1)


def _hull_edges(hull: ConvexHull):
    edges = set()
    for s in hull.simplices:
        for i in range(3):
            edges.add(tuple(sorted((int(s[i]), int(s[(i + 1) % 3])))))
    return edges


def convex_intersection_volume(pts_a: np.ndarray, pts_b: np.ndarray) -> float:
    """Exact intersection volume of two convex polyhedra given as vertex sets.

    Vertices of A∩B = (A's verts in B) ∪ (B's verts in A) ∪ (edge/face-plane
    intersection points inside both); the hull of those is the intersection.
    """
    try:
        hull_a, hull_b = ConvexHull(pts_a), ConvexHull(pts_b)
    except QhullError:
        return 0.0

    cand = [pts_a[_inside(pts_a, hull_b)], pts_b[_inside(pts_b, hull_a)]]
    for P, hp, hq in ((pts_a, hull_a, hull_b), (pts_b, hull_b, hull_a)):
        for (i, j) in _hull_edges(hp):
            p, d = P[i], P[j] - P[i]
            for eq in hq.equations:
                n, off = eq[:3], eq[3]
                denom = float(n @ d)
                if abs(denom) < 1e-12:
                    continue
                t = -(off + float(n @ p)) / denom
                if 0.0 <= t <= 1.0:
                    x = p + t * d
                    if _inside(x[None], hq, tol=1e-7)[0] and _inside(x[None], hp, tol=1e-7)[0]:
                        cand.append(x[None])
    cand = [c for c in cand if len(c)]
    pts = np.concatenate(cand, axis=0) if cand else np.zeros((0, 3))
    if pts.shape[0] < 4:
        return 0.0
    try:
        return float(ConvexHull(pts).volume)
    except QhullError:
        return 0.0


def box3d_iou(corners_a: np.ndarray, corners_b: np.ndarray) -> float:
    """IoU of two 3D boxes given as 8 corners each (any vertex order)."""
    try:
        va = ConvexHull(corners_a).volume
        vb = ConvexHull(corners_b).volume
    except QhullError:
        return 0.0
    vi = convex_intersection_volume(corners_a, corners_b)
    denom = va + vb - vi
    return float(vi / denom) if denom > 0 else 0.0


def compute_3d_iou(
    pose: np.ndarray,  # estimated vehicle-to-world, [K, 4, 4]
    gt_pose: np.ndarray,  # GT vehicle-to-world, [K, 4, 4]
    local_vertices: np.ndarray,  # [K, 8, 3] box corners in the vehicle frame
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-vehicle 3D box IoU of estimated vs GT pose applied to the local
    bbox corners (reference compute_3d_iou, utils/metrics.py:487-523).

    Returns (ious [K], bboxes [K, 8, 3], gt_bboxes [K, 8, 3])."""
    K = gt_pose.shape[0]
    homog = np.concatenate([local_vertices, np.ones((K, 8, 1), np.float32)], axis=-1)
    bboxes = np.einsum("vij,vnj->vni", pose, homog)[..., :3]
    gt_bboxes = np.einsum("vij,vnj->vni", gt_pose, homog)[..., :3]
    ious = np.array([box3d_iou(bboxes[k], gt_bboxes[k]) for k in range(K)], np.float32)
    return ious, bboxes, gt_bboxes
