"""Pinhole ray generation and NDC projection (port of
the JAX package's ``ops/rays.py``)."""

from __future__ import annotations

import torch


def camera_ray_directions(px_x: torch.Tensor, px_y: torch.Tensor,
                          width: float, height: float,
                          focal: float) -> torch.Tensor:
    """Camera-space directions ``d = ((x - W/2)/f, -(y - H/2)/f, -1)``,
    ``[..., 3]``, not normalized."""
    px_x = px_x.float()
    px_y = px_y.float()
    d_x = (px_x - width * 0.5) / focal
    d_y = -(px_y - height * 0.5) / focal
    return torch.stack([d_x, d_y, -torch.ones_like(d_x)], dim=-1)


def rays_for_pixels(px_x: torch.Tensor, px_y: torch.Tensor,
                    width: float, height: float, focal: float,
                    c2w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World-space ``(origins, directions)`` for the given pixels; ``c2w``
    is ``[3, 4]`` or ``[4, 4]``."""
    dirs_cam = camera_ray_directions(px_x, px_y, width, height, focal)
    dirs_world = torch.einsum("...k,jk->...j", dirs_cam, c2w[:3, :3].float())
    origins = c2w[:3, -1].float().expand(dirs_world.shape)
    return origins, dirs_world


def rays_for_pixels_batched(px_x: torch.Tensor, px_y: torch.Tensor,
                            width: float, height: float, focal: float,
                            c2w: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rays_for_pixels` with a camera per ray: ``c2w`` is ``[..., 3,
    4]`` (or ``[..., 4, 4]``) batched like the pixels (cross-image ray
    batching). The intrinsics are shared."""
    dirs_cam = camera_ray_directions(px_x, px_y, width, height, focal)
    dirs_world = torch.einsum("...k,...jk->...j", dirs_cam,
                              c2w[..., :3, :3].float())
    origins = c2w[..., :3, -1].float().expand(dirs_world.shape)
    return origins, dirs_world


def ray_grid(height: int, width: int, focal: float,
             c2w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid ``([H, W, 3], [H, W, 3])``, row-major, on
    ``c2w``'s device."""
    dev = c2w.device
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij")
    return rays_for_pixels(px, py, width, height, focal, c2w)


def ndc_rays(height: float, width: float, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor,
             variant: str = "canonical") -> tuple[torch.Tensor, torch.Tensor]:
    """Project rays to normalized device coordinates (forward-facing
    scenes). ``variant="canonical"`` is the standard NeRF warp;
    ``"reference"`` reproduces the reference's ``get_ndc`` with both of its
    deviations (origin shifted along itself; directions computed after the
    origin is overwritten) — see the JAX docstring for why it is unusable
    on recentered captures."""
    sx = -1.0 / (width / (2.0 * focal))
    sy = -1.0 / (height / (2.0 * focal))

    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    if variant == "reference":
        rays_o = rays_o + t[..., None] * rays_o
    elif variant == "canonical":
        rays_o = rays_o + t[..., None] * rays_d
    else:
        raise ValueError(f"unknown NDC variant: {variant!r}")

    o0 = sx * rays_o[..., 0] / rays_o[..., 2]
    o1 = sy * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    if variant == "reference":
        d0 = sx * (rays_d[..., 0] / rays_d[..., 2] - o0 / o2)
        d1 = sy * (rays_d[..., 1] / rays_d[..., 2] - o1 / o2)
        d2 = -2.0 * near / o2
    else:
        d0 = sx * (rays_d[..., 0] / rays_d[..., 2]
                   - rays_o[..., 0] / rays_o[..., 2])
        d1 = sy * (rays_d[..., 1] / rays_d[..., 2]
                   - rays_o[..., 1] / rays_o[..., 2])
        d2 = -2.0 * near / rays_o[..., 2]

    return (torch.stack([o0, o1, o2], dim=-1),
            torch.stack([d0, d1, d2], dim=-1))


# Reference-name alias: ``compute_rays(h, w, f, pose)`` (reference
# main.py:19-46) is ``ray_grid``, with the same arguments and returns.
compute_rays = ray_grid
