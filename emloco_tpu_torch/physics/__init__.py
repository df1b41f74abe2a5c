from .terrain import (  # noqa: F401
    Heightfield,
    flat_terrain,
    generate_mixed_terrain,
    height_and_normal_at,
    height_at,
    height_at_min2,
    make_heightfield,
    normal_at,
)
from .mesh_terrain import (  # noqa: F401
    load_mesh,
    mesh_heightfield,
    mesh_terrain_from_file,
)
from .types import EngineConfig  # noqa: F401
from .reduced import (  # noqa: F401
    Model,
    PhysicsState,
    body_frame_state,
    build_model,
    default_tree,
    joint_state,
    kinematic_state,
    refresh_cache,
    step,
)
