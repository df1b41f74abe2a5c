"""Host-side C++ helpers with ctypes bindings (port of emloco_tpu/native).

The terrain pipeline (walkable mask, spawn table, triangle-mesh
rasterization) and the trajnet++ ndjson reader, from the C++ sources kept
here (copies of the JAX package's). They are built with the host's g++ into
`build/` at the root of the checkout at first use and loaded with ctypes. A
failed build raises with the compiler's output: there is no silent numpy
fallback. The numpy versions (`physics.terrain.walkable_mask`,
`spawn_table`, `physics.mesh_terrain.rasterize_trimesh_np`,
`prediction.data.read_ndjson_scenes`) are the plain references the tests
hold these against.
"""
from .build import load_native  # noqa: F401
from .terrain import (fast_walkable_mask, fast_spawn_table,  # noqa: F401
                      fast_rasterize_trimesh)
from .ndjson import read_ndjson_fast, scenes_to_arrays  # noqa: F401
