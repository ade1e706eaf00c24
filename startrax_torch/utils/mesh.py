"""Mesh extraction from a trained density field (host-side, eval-only).

The port's copy of startrax/utils/mesh.py: a numpy marching tetrahedra (6
tets a cell, vectorised over the grid) and OBJ export, with the reference's
defaults (a 256^3 density grid over [-0.8, 0.8]^3, sigma 50). The density
and colour callables take host points [n, 3] and may return tensors on the
card (models.fields.query_density, query_rgb): the grid goes to the host a
chunk at a time, under torch.no_grad, as startrax's np.asarray takes it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

# Cube corners: bit0 = x, bit1 = y, bit2 = z.
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32
)
# Decomposition into 6 tetrahedra sharing the 0-7 diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7]],
    np.int32,
)
# Tet edges, indexed 0..5.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
# Per inside-bitmask (bit i = vertex i inside), triangles as triples of edge
# indices into _TET_EDGES.
_TET_CASES = {
    1: [(0, 1, 2)],
    2: [(0, 4, 3)],
    3: [(1, 2, 4), (1, 4, 3)],
    4: [(1, 3, 5)],
    5: [(0, 2, 5), (0, 5, 3)],
    6: [(0, 4, 5), (0, 5, 1)],
    7: [(2, 4, 5)],
    8: [(2, 5, 4)],
    9: [(0, 1, 5), (0, 5, 4)],
    10: [(0, 3, 5), (0, 5, 2)],
    11: [(1, 5, 3)],
    12: [(1, 3, 4), (1, 4, 2)],
    13: [(0, 3, 4)],
    14: [(0, 2, 1)],
}


def marching_tetrahedra(
    grid: np.ndarray, threshold: float, bounds: Tuple[float, float] = (-1.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract an isosurface mesh from a [N, N, N] scalar grid.

    Returns (vertices [V, 3] in world coords, faces [F, 3] int)."""
    n = grid.shape[0]
    lo, hi = bounds
    scale = (hi - lo) / (n - 1)

    # cell corner values: [nc, nc, nc, 8]
    nc = n - 1
    ix, iy, iz = np.meshgrid(np.arange(nc), np.arange(nc), np.arange(nc), indexing="ij")
    base = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)  # [C, 3]
    corner_idx = base[:, None, :] + _CORNER_OFFSETS[None]  # [C, 8, 3]
    vals = grid[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [C, 8]
    corner_pos = (corner_idx.astype(np.float64) * scale + lo)  # [C, 8, 3]

    # quick reject: cells fully in/out
    inside8 = vals > threshold
    active = np.logical_and(inside8.any(-1), (~inside8).any(-1))
    vals = vals[active]
    corner_pos = corner_pos[active]

    verts_out = []
    for tet in _TETS:
        tv = vals[:, tet]  # [A, 4]
        tp = corner_pos[:, tet]  # [A, 4, 3]
        mask = (tv > threshold).astype(np.int32)
        case = mask[:, 0] | (mask[:, 1] << 1) | (mask[:, 2] << 2) | (mask[:, 3] << 3)
        for c, tris in _TET_CASES.items():
            sel = case == c
            if not sel.any():
                continue
            v = tv[sel]
            p = tp[sel]
            # interpolated point on each tet edge
            edge_pts = []
            for (a, b) in _TET_EDGES:
                va, vb = v[:, a], v[:, b]
                denom = np.where(np.abs(vb - va) < 1e-12, 1.0, vb - va)
                t = np.clip((threshold - va) / denom, 0.0, 1.0)
                edge_pts.append(p[:, a] + t[:, None] * (p[:, b] - p[:, a]))
            edge_pts = np.stack(edge_pts, axis=1)  # [S, 6, 3]
            for (e0, e1, e2) in tris:
                verts_out.append(
                    np.stack([edge_pts[:, e0], edge_pts[:, e1], edge_pts[:, e2]], axis=1)
                )

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_verts = np.concatenate(verts_out, axis=0)  # [F, 3, 3]
    flat = tri_verts.reshape(-1, 3)
    # dedupe vertices
    keys = np.round(flat / (scale * 1e-4)).astype(np.int64)
    _, uniq_idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    vertices = flat[uniq_idx].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int64)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return vertices, faces[ok]


def _host(values) -> np.ndarray:
    if torch.is_tensor(values):
        return values.detach().float().cpu().numpy()
    return np.asarray(values)


def eval_density_grid(
    density_fn: Callable[[np.ndarray], np.ndarray],
    resolution: int = 256,
    bounds: Tuple[float, float] = (-0.8, 0.8),
    chunk: int = 65536,
) -> np.ndarray:
    """A density function on a regular grid [resolution]^3 over bounds^3,
    chunk points a call (reference utils/mesh.py:223-240: 256^3 over
    [-0.8, 0.8]^3)."""
    lo, hi = bounds
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    out = np.empty(pts.shape[0], np.float32)
    with torch.no_grad():
        for i in range(0, pts.shape[0], chunk):
            out[i : i + chunk] = _host(density_fn(pts[i : i + chunk]))
    return out.reshape(resolution, resolution, resolution)


def extract_mesh(
    density_fn: Callable[[np.ndarray], np.ndarray],
    path: str,
    resolution: int = 256,
    bounds: Tuple[float, float] = (-0.8, 0.8),
    sigma_threshold: float = 50.0,
):
    """Grid-eval the field density, run marching tetrahedra, write an OBJ
    (reference extract_mesh: sigma_threshold 50)."""
    grid = eval_density_grid(density_fn, resolution, bounds)
    verts, faces = marching_tetrahedra(grid, sigma_threshold, bounds)
    save_obj(path, verts, faces)
    return verts, faces


def extract_color_mesh(
    density_fn: Callable[[np.ndarray], np.ndarray],
    rgb_fn: Callable[[np.ndarray], np.ndarray],
    path: str,
    resolution: int = 256,
    bounds: Tuple[float, float] = (-0.8, 0.8),
    sigma_threshold: float = 50.0,
    chunk: int = 65536,
):
    """Vertex-coloured mesh: marching tetrahedra and the radiance field's
    colour at each vertex (startrax's extract_color_mesh: the learned
    field queried directly, no cameras)."""
    grid = eval_density_grid(density_fn, resolution, bounds)
    verts, faces = marching_tetrahedra(grid, sigma_threshold, bounds)
    colors = np.empty_like(verts)
    with torch.no_grad():
        for i in range(0, len(verts), chunk):
            colors[i : i + chunk] = _host(rgb_fn(verts[i : i + chunk]))
    save_obj(path, verts, faces, colors=np.clip(colors, 0, 1))
    return verts, faces, colors


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray, colors=None):
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            if colors is not None:
                c = colors[i]
                f.write(
                    f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n"
                )
            else:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
