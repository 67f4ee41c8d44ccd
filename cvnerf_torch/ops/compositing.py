"""Volume rendering: alpha compositing of raw network outputs along rays,
and the two weight-space training regularizers (port of the JAX package's
``ops/compositing.py``)."""

from __future__ import annotations

import torch

INF_DIST = 1e10


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis whose backward reads no value
    on the host. PyTorch's own backward asks the host whether any factor is
    zero (a device sync, which a CUDA graph's capture refuses); the
    compositor's factors ``1 - alpha + 1e-10`` are never zero, so this is
    the branch it then takes: the reversed cumulative sum of ``output ·
    grad`` over the factors."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


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
    trans = _Cumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1))[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * t_vals, dim=-1)
    if white_bkg:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "weights": weights, "acc": acc, "depth": depth}


def _normalized_depth(t_vals: torch.Tensor, near: torch.Tensor,
                      far: torch.Tensor) -> torch.Tensor:
    return (t_vals - near[..., None]) / (far - near)[..., None]


def distortion_loss(weights: torch.Tensor, t_vals: torch.Tensor,
                    near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Per-ray mip-NeRF 360 distortion regularizer over normalized depths
    ``s = (t - near) / (far - near)``::

        L = sum_ij w_i w_j |s_i - s_j| + (1/3) sum_i w_i^2 (s_{i+1} - s_i)

    with the pairwise sum in O(S) through exclusive prefix sums over the
    ascending samples, ``2 sum_i w_i (s_i W_i - S_i)`` (``W_i``, ``S_i``
    the sums of ``w_j`` and ``w_j s_j`` over ``j < i``). The terminal
    sample has no interval. ``weights`` and ``t_vals`` are ``[...,
    n_samples]``, ``near``/``far`` ``[...]``; returns ``[...]``."""
    s = _normalized_depth(t_vals, near, far)
    ws = weights * s
    w_before = torch.cumsum(weights, dim=-1) - weights
    ws_before = torch.cumsum(ws, dim=-1) - ws
    pairwise = 2.0 * torch.sum(ws * w_before - weights * ws_before, dim=-1)
    delta = s[..., 1:] - s[..., :-1]
    self_term = torch.sum(weights[..., :-1] ** 2 * delta, dim=-1) / 3.0
    return pairwise + self_term


def occlusion_loss(weights: torch.Tensor, t_vals: torch.Tensor,
                   near: torch.Tensor, far: torch.Tensor,
                   frac: float) -> torch.Tensor:
    """Per-ray FreeNeRF occlusion regularizer: the compositing weight that
    lies in the first ``frac`` of each ray's normalized depth range
    (``[...]`` from ``[..., n_samples]``)."""
    s = _normalized_depth(t_vals, near, far)
    return torch.sum(weights * (s < frac).to(weights.dtype), dim=-1)
