from .mesh import distributed_init, make_mesh, shard_env_axis  # noqa: F401
