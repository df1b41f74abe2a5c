"""ctypes wrapper of the native trajnet++ ndjson reader
(ndjson_native.cpp)."""
from __future__ import annotations

import ctypes

import numpy as np

from .build import load_native


def read_ndjson_fast(path: str):
    """Parse a trajnet++-style ndjson file: (tracks_fp (n, 2) int32
    [frame, ped], tracks_xy (n, 2) float32, scenes (m, 4) int32 [id,
    primary, start, end]). An unreadable file raises IOError."""
    lib = load_native("ndjson_native")
    lib.ndjson_parse.restype = ctypes.c_void_p
    lib.ndjson_num_tracks.restype = ctypes.c_int64
    lib.ndjson_num_scenes.restype = ctypes.c_int64
    h = lib.ndjson_parse(path.encode())
    if not h:
        raise IOError(f"cannot parse {path}")
    h = ctypes.c_void_p(h)
    try:
        n = lib.ndjson_num_tracks(h)
        m = lib.ndjson_num_scenes(h)
        fp = np.zeros((n, 2), np.int32)
        xy = np.zeros((n, 2), np.float32)
        sc = np.zeros((m, 4), np.int32)
        lib.ndjson_copy_tracks(
            h, fp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        lib.ndjson_copy_scenes(
            h, sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.ndjson_free(h)
    return fp, xy, sc


def scenes_to_arrays(fp, xy, sc):
    """(T, N, 2) arrays per scene from the flat tracks: the primary first,
    then every other pedestrian seen on all of the scene's frames, in
    ascending id; a scene whose primary misses a frame is dropped (as
    `prediction.data.read_ndjson_scenes`)."""
    scenes = []
    order = np.lexsort((fp[:, 0], fp[:, 1]))
    fp_s, xy_s = fp[order], xy[order]
    peds, ped_starts = np.unique(fp_s[:, 1], return_index=True)
    ped_slices = {p: slice(s, e) for p, s, e in zip(
        peds, ped_starts, list(ped_starts[1:]) + [len(fp_s)])}
    for sid, primary, s, e in sc:
        frames = np.arange(s, e + 1)
        cols = []
        for p in [primary] + [p for p in peds if p != primary]:
            sl = ped_slices.get(p)
            if sl is None:
                if p == primary:
                    cols = None
                    break
                continue
            f_p = fp_s[sl, 0]
            idx = np.searchsorted(f_p, frames)
            ok = bool((idx < len(f_p)).all()) and np.array_equal(
                f_p[np.clip(idx, 0, len(f_p) - 1)], frames)
            if not ok:
                if p == primary:
                    cols = None
                    break
                continue
            cols.append(xy_s[sl][idx])
        if cols:
            scenes.append(np.stack(cols, axis=1))
    return scenes
