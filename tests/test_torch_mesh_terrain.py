"""emloco_tpu_torch.physics.mesh_terrain against the JAX package's: the
loaders on temporary OBJ (quads and slashed indices), NPZ, NPY and ASCII
PLY files, the numpy rasterizer, and `mesh_heightfield` on a synthetic
mesh, whose heights, corner texture, origin and spawn table must agree.

The JAX package rasterizes with its C++ helper, which equals the numpy one
(tests/test_mesh_terrain.py:25); the port has only the numpy one, so the
heights agree to 1e-5 m where both cover a cell and the covers exactly. The
mesh has fewer walkable cells than `max_spawn`, so neither package
subsamples and the spawn tables hold the same cells (the C++ helper lists
them in its own order and rounds in float32: compared sorted, to 1e-6 m).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.physics import mesh_heightfield as jmesh_heightfield
from emloco_tpu.physics import mesh_terrain as JM
from emloco_tpu.physics.terrain import height_at as jheight_at
from emloco_tpu_torch.physics import (height_at, load_mesh, mesh_heightfield,
                                      mesh_terrain_from_file)
from emloco_tpu_torch.physics import mesh_terrain as TM

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)


def _mesh():
    """A 4 × 4 m ground sloping to 0.8 m, a 1 × 1 m platform at 1 m, and a
    steep 0.6 m wedge (unwalkable)."""
    verts = np.array([[0, 0, 0], [4, 0, 0], [4, 4, 0.8], [0, 4, 0.8],
                      [1, 1, 1.0], [2, 1, 1.0], [2, 2, 1.0], [1, 2, 1.0],
                      [3, 0.5, 0.1], [3.4, 0.5, 0.7], [3.4, 1.5, 0.7]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7],
                      [8, 9, 10]], np.int32)
    return verts, faces


def _write(path, verts, faces, fmt):
    if fmt == "obj":            # one quad, fan-triangulated, slashed indices
        with open(path, "w") as f:
            f.write("# mesh\n\n")
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            f.write("vn 0 0 1\n")
            f.write("f 1/1/1 2/2/1 3/3/1 4/4/1\n")
            for a, b, c in faces[2:] + 1:
                f.write(f"f {a}//1 {b}//1 {c}//1\n")
    elif fmt == "ply":
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(verts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("element face 4\nproperty list uchar int vertex_index\n")
            f.write("end_header\n")
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]} 0 0 1\n")
            f.write("4 0 1 2 3\n3 4 5 6\n3 4 6 7\n3 8 9 10\n")
    elif fmt == "npz":
        np.savez(path, vertices=verts, faces=faces)
    else:
        np.save(path, {"vertices": verts, "faces": faces})


@pytest.mark.parametrize("fmt", ["obj", "ply", "npz", "npy"])
def test_loaders_match_jax(tmp_path, fmt):
    verts, faces = _mesh()
    path = str(tmp_path / f"m.{fmt}")
    _write(path, verts, faces, fmt)
    v, f = load_mesh(path)
    jv, jf = JM.load_mesh(path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_allclose(v, verts, atol=1e-6)
    assert len(f) == 5
    with pytest.raises(ValueError):
        load_mesh(str(tmp_path / "m.stl"))


def test_rasterizer_matches_jax():
    verts, faces = _mesh()
    h, c = TM.rasterize_trimesh_np(verts, faces, 50, 50, 0.1, (-0.5, -0.5))
    jh, jc = JM.rasterize_trimesh_np(verts, faces, 50, 50, 0.1, (-0.5, -0.5))
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(c, jc)


def test_mesh_heightfield_matches_jax(tmp_path):
    verts, faces = _mesh()
    hf = mesh_heightfield(verts, faces, cell=0.1, device="cpu")
    jhf = jmesh_heightfield(verts, faces, cell=0.1)
    assert hf.origin == pytest.approx(jhf.origin, abs=0)
    assert hf.cell == jhf.cell and hf.shape == tuple(jhf.heights.shape)
    np.testing.assert_allclose(hf.heights.numpy(), np.asarray(jhf.heights),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(hf.corner_tex.numpy(),
                               np.asarray(jhf.corner_tex), rtol=0, atol=1e-5)
    a, b = np.asarray(jhf.spawnable_xy), hf.spawnable_xy.numpy()
    assert a.shape == b.shape and len(b) > 10
    np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)],
                               rtol=0, atol=1e-6)
    xy = np.array([[1.5, 1.5], [3.0, 3.0], [3.3, 1.0]], np.float32)
    np.testing.assert_allclose(height_at(hf, torch.as_tensor(xy)).numpy(),
                               np.asarray(jheight_at(jhf, jnp.asarray(xy))),
                               rtol=0, atol=1e-5)
    assert abs(float(height_at(hf, torch.tensor([1.5, 1.5]))) - 1.0) < 1e-4
    # no spawn on the wedge; the file path gives the same field
    assert not ((b[:, 0] > 2.9) & (b[:, 0] < 3.5) & (b[:, 1] > 0.4)
                & (b[:, 1] < 1.6)).any()
    path = str(tmp_path / "m.npz")
    _write(path, verts, faces, "npz")
    hf2 = mesh_terrain_from_file(path, cell=0.1, device="cpu")
    torch.testing.assert_close(hf2.heights, hf.heights, rtol=0, atol=0)
