"""The NeRF MLP (params as nested dicts of tensors)."""

from cvnerf_torch.models.nerf_mlp import (
    NerfMLPConfig,
    init_nerf_params,
    apply_nerf,
    nerf_param_count,
)

__all__ = [
    "NerfMLPConfig",
    "init_nerf_params",
    "apply_nerf",
    "nerf_param_count",
]
