"""ctypes wrappers of the native terrain pipeline (terrain_native.cpp)."""
from __future__ import annotations

import ctypes

import numpy as np

from .build import load_native

_F = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)


def fast_walkable_mask(heights: np.ndarray, cell: float,
                       max_slope: float = 0.5,
                       margin_cells: int = 3) -> np.ndarray:
    """Walkable cells (slope threshold, eroded by a margin); the plain
    version is `physics.terrain.walkable_mask`."""
    lib = load_native("terrain_native")
    H, W = heights.shape
    h = np.ascontiguousarray(heights, np.float32)
    out = np.zeros((H, W), np.uint8)
    lib.walkable_mask(h.ctypes.data_as(_F), ctypes.c_int(H), ctypes.c_int(W),
                      ctypes.c_float(cell), ctypes.c_float(max_slope),
                      ctypes.c_int(margin_cells), out.ctypes.data_as(_U8))
    return out.astype(bool)


def fast_spawn_table(mask: np.ndarray, cell: float, origin,
                     max_pts: int = 65536, seed: int = 0) -> np.ndarray:
    """World xy of up to max_pts walkable cells, in the order of a seeded
    partial Fisher-Yates shuffle (the C++ generator); at least one row. The
    plain version is `physics.terrain.spawn_table` (the same cells when
    none is dropped; coordinates rounded once from float64 there, in
    float32 here)."""
    lib = load_native("terrain_native")
    H, W = mask.shape
    m = np.ascontiguousarray(mask.astype(np.uint8))
    out = np.zeros((max_pts, 2), np.float32)
    lib.spawn_table.restype = ctypes.c_int
    n = lib.spawn_table(
        m.ctypes.data_as(_U8), ctypes.c_int(H), ctypes.c_int(W),
        ctypes.c_float(cell), ctypes.c_float(origin[0]),
        ctypes.c_float(origin[1]), ctypes.c_uint64(seed),
        ctypes.c_int(max_pts), out.ctypes.data_as(_F))
    return out[:max(n, 1)]


def fast_rasterize_trimesh(verts: np.ndarray, faces: np.ndarray, H: int,
                           W: int, cell: float, origin):
    """Top surface of a triangle mesh on an (H, W) grid, in float32:
    (heights with -1e30 where no triangle covers a cell, cover bool); the
    plain version is `physics.mesh_terrain.rasterize_trimesh_np` (float64
    arithmetic, -inf where uncovered)."""
    lib = load_native("terrain_native")
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    out_h = np.zeros((H, W), np.float32)
    cover = np.zeros((H, W), np.uint8)
    lib.rasterize_trimesh(
        v.ctypes.data_as(_F), ctypes.c_int(len(v)), f.ctypes.data_as(_I32),
        ctypes.c_int(len(f)), ctypes.c_int(H), ctypes.c_int(W),
        ctypes.c_float(cell), ctypes.c_float(origin[0]),
        ctypes.c_float(origin[1]), out_h.ctypes.data_as(_F),
        cover.ctypes.data_as(_U8))
    return out_h, cover.astype(bool)
