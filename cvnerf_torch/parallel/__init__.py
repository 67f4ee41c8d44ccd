"""Device-mesh creation and sharding helpers (data-parallel over rays)."""

from cvnerf_torch.parallel.mesh import (
    RAY_AXIS,
    initialize_distributed,
    make_mesh,
    ray_sharding,
    replicate_to_mesh,
    replicated_sharding,
)

__all__ = [
    "RAY_AXIS",
    "initialize_distributed",
    "make_mesh",
    "ray_sharding",
    "replicate_to_mesh",
    "replicated_sharding",
]
