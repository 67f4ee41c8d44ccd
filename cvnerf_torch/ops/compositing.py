"""Volume rendering: alpha compositing of raw network outputs along rays
(port of the JAX package's ``ops/compositing.py::volume_render``)."""

from __future__ import annotations

import torch

INF_DIST = 1e10


def volume_render(raw_rgba: torch.Tensor, t_vals: torch.Tensor,
                  ray_dirs: torch.Tensor, noise_std: float = 0.0,
                  white_bkg: bool = False,
                  noise: torch.Tensor | None = None) -> dict:
    """Composite raw ``[..., n_samples, 4]`` into pixel RGB.

    ``delta_i = t_{i+1} - t_i`` with a terminal 1e10, scaled by ``‖d‖``;
    ``rgb = sigmoid(raw[..., :3])``; noise (if any) is added to the raw
    density before the ReLU; ``alpha = 1 - exp(-relu(sigma)·delta)``;
    ``T_i`` is the exclusive cumprod of ``(1 - alpha + 1e-10)``; white
    background adds ``1 - acc``. Returns ``rgb``, ``weights``, ``acc`` and
    ``depth``.
    """
    deltas = t_vals[..., 1:] - t_vals[..., :-1]
    deltas = torch.cat(
        [deltas, torch.full_like(deltas[..., :1], INF_DIST)], dim=-1)
    deltas = deltas * torch.linalg.norm(ray_dirs[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw_rgba[..., :3])
    sigma = raw_rgba[..., 3]
    if noise_std > 0.0:
        if noise is None:
            raise ValueError("density noise needs pre-drawn normals")
        sigma = sigma + noise * noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * deltas)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * t_vals, dim=-1)
    if white_bkg:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "weights": weights, "acc": acc, "depth": depth}
