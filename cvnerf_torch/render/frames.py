"""Full-image and pose-sequence rendering (port of
the JAX package's ``render/frames.py``).

``render_image`` builds the ray grid on the pose's device, normalizes the
pre-NDC view directions, optionally warps to NDC, and renders the rays in
chunks. ``render_poses_to_frames`` keeps one frame in flight: frame ``i+1``
is queued on the device before frame ``i`` is copied to the host, so the
copy and any ``on_frame`` work overlap the device's render. Both take a
``mesh`` (``parallel/mesh.py``): each chunk's rays are then split over its
shards, and across processes every rank renders its shards and receives
the whole frame. ``render`` is the reference-shaped entry point: a frame
from ``c2w=`` or a ray batch from ``rays=``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cvnerf_torch.ops.rays import ndc_rays, ray_grid
from cvnerf_torch.ops.rng import split
from cvnerf_torch.parallel.mesh import Mesh
from cvnerf_torch.render.renderer import RenderConfig, render_rays_chunked


@torch.no_grad()
def render_image(params: dict, height: int, width: int, focal: float,
                 c2w: torch.Tensor, near: float, far: float,
                 cfg: RenderConfig, ndc: bool = False,
                 ndc_variant: str = "canonical",
                 chunk: int = 4096, key: torch.Tensor | None = None,
                 occupancy=None, mesh: Mesh | None = None) -> dict:
    """Render one ``[H, W]`` frame from a ``[3, 4]`` pose; the frame is
    rendered on ``c2w``'s device (with ``mesh``, on its shards' devices,
    and returned on ``c2w``'s). ``key`` (``ops.rng``) keys the draws of a
    stochastic configuration; ``occupancy`` is a baked grid the frame
    renders through. Returns ``rgb``, ``rgb_coarse``, ``acc`` and
    ``depth`` as tensors of shape ``[H, W, ...]``."""
    rays_o, rays_d = ray_grid(height, width, focal, c2w)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if ndc:
        rays_o, rays_d = ndc_rays(height, width, focal, 1.0, rays_o, rays_d,
                                  variant=ndc_variant)
    out = render_rays_chunked(params, rays_o, rays_d, viewdirs, near, far,
                              cfg, chunk=chunk, key=key, occupancy=occupancy,
                              mesh=mesh)
    return {k: v.reshape(height, width, *v.shape[1:]) for k, v in out.items()}


@torch.no_grad()
def render(params: dict, height: int, width: int, focal: float,
           chunk: int = 4096, rays=None, c2w=None, ndc: bool = True,
           near: float = 0.0, far: float = 1.0,
           cfg: RenderConfig = RenderConfig(),
           ndc_variant: str = "canonical",
           key: torch.Tensor | None = None):
    """The reference-shaped entry point (the JAX package's ``render``):
    a full image from ``c2w`` (``[3+, 4]``), or an ``(origins,
    directions)`` ray batch of any leading shape from ``rays``, exactly
    one of the two. ``ndc`` defaults to True, as in the reference: pass
    ``ndc=False`` for anything that is not a forward-facing LLFF scene.
    Returns ``(rgb, extras)``, ``extras`` holding ``rgb_coarse``, ``acc``
    and ``depth``."""
    if (rays is None) == (c2w is None):
        raise ValueError("provide exactly one of rays= or c2w=")
    if c2w is not None:
        out = render_image(params, height, width, focal,
                           torch.as_tensor(c2w, dtype=torch.float32)[:3, :4],
                           near, far, cfg, ndc=ndc, ndc_variant=ndc_variant,
                           chunk=chunk, key=key)
    else:
        rays_o, rays_d = (torch.as_tensor(x, dtype=torch.float32)
                          for x in rays)
        sh = rays_d.shape
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if ndc:
            rays_o, rays_d = ndc_rays(height, width, focal, 1.0, rays_o,
                                      rays_d, variant=ndc_variant)
        out = render_rays_chunked(params, rays_o, rays_d, viewdirs, near,
                                  far, cfg, chunk=chunk, key=key)
        out = {k: v.reshape(*sh[:-1], *v.shape[1:]) for k, v in out.items()}
    rgb = out.pop("rgb")
    return rgb, out


def render_poses_to_frames(params: dict, poses, height: int, width: int,
                           focal: float, near: float, far: float,
                           cfg: RenderConfig, ndc: bool = False,
                           ndc_variant: str = "canonical",
                           chunk: int = 4096, factor: int = 0,
                           on_frame: Callable[[int, np.ndarray], None]
                           | None = None,
                           frame_keys: tuple[str, ...] = ("rgb",),
                           collect: bool = True,
                           device: str | torch.device = "cuda",
                           key: torch.Tensor | None = None,
                           occupancy=None, mesh: Mesh | None = None):
    """Render a pose sequence to ``[N, H, W, 3]`` float frames on
    ``device``.

    ``factor`` downscales H/W/focal. ``frame_keys`` selects the outputs
    (``rgb``, ``depth``, ``acc``, ``rgb_coarse``): with the default the
    result is the stacked rgb array, otherwise a dict of stacked arrays.
    ``on_frame(i, rgb)`` receives each rgb frame as it lands;
    ``collect=False`` (which needs ``on_frame``) keeps no frames and
    returns None. A stochastic configuration renders pose ``i`` with key
    ``split(key, len(poses))[i]``, as the JAX package does; a deterministic
    one needs no key and renders every pose alike wherever it sits.
    ``occupancy`` is a baked grid every frame renders through; ``mesh``
    splits every frame's chunks over its shards.
    """
    if not collect and on_frame is None:
        raise ValueError("collect=False requires on_frame (nothing would "
                         "observe the frames)")
    if on_frame is not None and "rgb" not in frame_keys:
        raise ValueError(
            "on_frame receives rgb frames; include 'rgb' in frame_keys "
            f"(got {frame_keys!r}) or drop the callback")
    if factor:
        height, width = height // factor, width // factor
        focal = focal / factor

    if len(poses) == 0:
        def empty_for(k):
            ch = (3,) if k in ("rgb", "rgb_coarse") else ()
            return np.zeros((0, height, width, *ch), np.float32)
        if frame_keys == ("rgb",):
            return empty_for("rgb")
        return {k: empty_for(k) for k in frame_keys}

    keys = (split(key, len(poses)) if key is not None
            else [None] * len(poses))
    pending: list[tuple[int, dict]] = []
    frames: list[dict | None] = [None] * len(poses)

    def drain(entry):
        i, out = entry
        vals = {k: out[k].cpu().numpy() for k in frame_keys}  # waits for i
        if collect:
            frames[i] = vals
        if on_frame is not None:
            on_frame(i, vals["rgb"])

    for i, pose in enumerate(poses):
        c2w = torch.as_tensor(np.asarray(pose, np.float32)[:3, :4],
                              device=device)
        out = render_image(params, height, width, float(focal), c2w,
                           float(near), float(far), cfg, ndc=ndc,
                           ndc_variant=ndc_variant, chunk=chunk, key=keys[i],
                           occupancy=occupancy, mesh=mesh)
        pending.append((i, out))
        if len(pending) > 1:   # one frame in flight
            drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    if not collect:
        return None
    if frame_keys == ("rgb",):
        return np.stack([f["rgb"] for f in frames], 0)
    return {k: np.stack([f[k] for f in frames], 0) for k in frame_keys}
