"""Real-scan mesh grounds: triangle mesh → Heightfield.

Port of emloco_tpu/physics/mesh_terrain.py. The mesh is rasterized once on
the host into the same Heightfield the step and the sensor read, so a mesh
ground costs nothing per step beyond a procedural one. The host path is
numpy: `rasterize_trimesh_np` (the JAX package's native rasterizer gives the
same heights), then this package's walkable mask and spawn table.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .terrain import Heightfield, make_heightfield, spawn_table, walkable_mask


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (N,3) float32, faces (M,3) int32) from .npz/.npy, ascii
    .obj (polygons fan-triangulated) or ascii .ply."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npz", ".npy"):
        d = np.load(path, allow_pickle=True)
        if ext == ".npy":
            d = d.item()
        return (np.asarray(d["vertices"], np.float32),
                np.asarray(d["faces"], np.int32))
    if ext == ".obj":
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                p = line.split()
                if not p:
                    continue
                if p[0] == "v":
                    verts.append([float(p[1]), float(p[2]), float(p[3])])
                elif p[0] == "f":
                    idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
    if ext == ".ply":
        return _load_ply_ascii(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _load_ply_ascii(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        lines = iter(f.read().splitlines())
    n_v = n_f = 0
    for line in lines:
        p = line.split()
        if p[:2] == ["element", "vertex"]:
            n_v = int(p[2])
        elif p[:2] == ["element", "face"]:
            n_f = int(p[2])
        elif p and p[0] == "end_header":
            break
    verts = np.array([[float(x) for x in next(lines).split()[:3]]
                      for _ in range(n_v)], np.float32)
    faces = []
    for _ in range(n_f):
        p = [int(x) for x in next(lines).split()]
        for k in range(2, p[0]):
            faces.append([p[1], p[k], p[k + 1]])
    return verts, np.asarray(faces, np.int32)


def rasterize_trimesh_np(verts: np.ndarray, faces: np.ndarray, H: int, W: int,
                         cell: float, origin) -> Tuple[np.ndarray, np.ndarray]:
    """Top-surface rasterization, triangle by triangle (barycentric weights
    at each cell corner inside the triangle's bounding box): (heights (H,W),
    −inf where no triangle covers the cell, cover (H,W) bool)."""
    heights = np.full((H, W), -np.inf, np.float32)
    cover = np.zeros((H, W), bool)
    ox, oy = origin
    for a, b, c in verts[faces]:
        i0 = max(0, int(np.floor((min(a[0], b[0], c[0]) - ox) / cell)))
        i1 = min(H - 1, int(np.ceil((max(a[0], b[0], c[0]) - ox) / cell)))
        j0 = max(0, int(np.floor((min(a[1], b[1], c[1]) - oy) / cell)))
        j1 = min(W - 1, int(np.ceil((max(a[1], b[1], c[1]) - oy) / cell)))
        if i1 < i0 or j1 < j0:
            continue
        d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(d) < 1e-12:
            continue
        px = ox + np.arange(i0, i1 + 1) * cell
        py = oy + np.arange(j0, j1 + 1) * cell
        PX, PY = np.meshgrid(px, py, indexing="ij")
        w0 = ((b[1] - c[1]) * (PX - c[0]) + (c[0] - b[0]) * (PY - c[1])) / d
        w1 = ((c[1] - a[1]) * (PX - c[0]) + (a[0] - c[0]) * (PY - c[1])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -1e-5) & (w1 >= -1e-5) & (w2 >= -1e-5)
        z = w0 * a[2] + w1 * b[2] + w2 * c[2]
        sub = heights[i0:i1 + 1, j0:j1 + 1]
        np.maximum(sub, np.where(inside, z, -np.inf), out=sub)
        cover[i0:i1 + 1, j0:j1 + 1] |= inside
    return heights, cover


def mesh_heightfield(verts: np.ndarray, faces: np.ndarray, cell: float = 0.1,
                     pad: float = 1.0, max_slope: float = 0.5,
                     margin_cells: int = 3, max_spawn: int = 65536,
                     seed: int = 0, device=None) -> Heightfield:
    """A Heightfield from a mesh: the grid spans the vertices plus `pad`;
    uncovered cells take the lowest covered height (a solid floor); spawns
    are the covered cells whose slope is walkable, `margin_cells` from any
    that is not."""
    verts = np.asarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    ox = float(verts[:, 0].min() - pad)
    oy = float(verts[:, 1].min() - pad)
    H = int(np.ceil((verts[:, 0].max() + pad - ox) / cell)) + 1
    W = int(np.ceil((verts[:, 1].max() + pad - oy) / cell)) + 1
    heights, cover = rasterize_trimesh_np(verts, faces, H, W, cell, (ox, oy))
    floor = float(heights[cover].min()) if cover.any() else 0.0
    heights = np.where(cover, heights, floor).astype(np.float32)
    mask = cover & walkable_mask(heights, cell, max_slope, margin_cells)
    xy = spawn_table(mask, cell, (ox, oy), max_pts=max_spawn, seed=seed)
    return make_heightfield(heights, cell, (ox, oy), xy, device=device)


def mesh_terrain_from_file(path: str, **kw) -> Heightfield:
    verts, faces = load_mesh(path)
    return mesh_heightfield(verts, faces, **kw)
