"""The benchmark's inputs, made from ``--seed`` on the run's device: a
scene's images and camera poses, and the starting weights of the
configuration's model family (``families/``) fitted to the scene by its
plain reference (for serving, written as a checkpoint). The program under
test receives these and nothing else of the benchmark; the reference
receives the same.

Images are rendered analytically (ray-sphere hits, Lambertian shading), so
a seed gives the same pixels on any run; the published sizes and view
counts come from the configuration file.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from nerfbench import families
from nerfbench.reference.common import pixel_rays

_LIGHT = (0.4, 0.5, 0.77)
# The fit of the weights every cell starts from (a family's ``fit``): Adam
# steps, rays a step, steps drawn from the centre crop, and the density
# noise.
FIT = {"steps": 300, "rays": 2048, "precrop_steps": 150, "noise_std": 1.0}


def _rand(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def look_at(pos: torch.Tensor, target: torch.Tensor,
            up=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """``[N, 3, 4]`` camera-to-world poses at ``pos [N, 3]`` whose -z axis
    looks at ``target``."""
    back = pos - target
    back = back / torch.linalg.norm(back, dim=-1, keepdim=True)
    upv = torch.tensor(up, dtype=torch.float32, device=pos.device)
    right = torch.linalg.cross(upv.expand_as(back), back, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    cam_up = torch.linalg.cross(back, right, dim=-1)
    return torch.stack([right, cam_up, back, pos], -1)


def hemisphere_poses(gen, n: int, device, radius: float = 4.03):
    """Views of an object on the upper hemisphere, looking at the origin
    (a Blender scene's cameras)."""
    az = _rand(gen, (n,), 0.0, 2 * math.pi, device)
    el = _rand(gen, (n,), math.radians(8), math.radians(80), device)
    pos = radius * torch.stack([torch.cos(el) * torch.cos(az),
                                torch.cos(el) * torch.sin(az),
                                torch.sin(el)], -1)
    return look_at(pos, torch.zeros_like(pos))


def facing_poses(gen, n: int, device, spread: float = 0.25,
                 turn_deg: float = 3.0):
    """Forward-facing cameras near the mean pose (identity), each moved
    within ``spread`` in x and y and turned by up to ``turn_deg``."""
    r = spread * torch.sqrt(torch.rand((n,), generator=gen, device=device))
    a = _rand(gen, (n,), 0.0, 2 * math.pi, device)
    z = _rand(gen, (n,), -0.05, 0.05, device)
    pos = torch.stack([r * torch.cos(a), r * torch.sin(a), z], -1)
    ax, ay = (math.radians(turn_deg) * _rand(gen, (n,), -1.0, 1.0, device)
              for _ in range(2))
    target = pos + torch.stack([-torch.tan(ay), torch.tan(ax),
                                -torch.ones_like(ax)], -1)
    return look_at(pos, target, up=(0.0, 1.0, 0.0))


def spiral_poses(gen, n: int, device, radius: float = 0.15,
                 focus: float = 5.0):
    """Views on a jittered spiral around the mean pose, looking at a point
    ``focus`` ahead (a forward-facing scene's render path)."""
    th = _rand(gen, (n,), 0.0, 2 * math.pi, device)
    jit = _rand(gen, (n, 3), -0.02, 0.02, device)
    pos = torch.stack([radius * torch.cos(th), radius * torch.sin(th),
                       0.05 * torch.sin(0.5 * th)], -1) + jit
    target = torch.tensor([0.0, 0.0, -focus], device=device).expand_as(pos)
    return look_at(pos, target, up=(0.0, 1.0, 0.0))


def request_poses(cfg: dict, gen, n: int, device) -> torch.Tensor:
    """``n`` distinct seeded poses to render: hemisphere views of an object,
    or a jittered spiral for a forward-facing scene."""
    if cfg["dataset_type"] == "llff":
        return spiral_poses(gen, n, device)
    return hemisphere_poses(gen, n, device)


def _spheres(cfg, gen, device):
    """Centres, radii and colours of the scene's spheres."""
    if cfg["dataset_type"] == "llff":
        k = 12
        depth = _rand(gen, (k,), 2.0, 9.0, device)
        xy = _rand(gen, (k, 2), -0.45, 0.45, device) * depth[:, None]
        centres = torch.cat([xy, -depth[:, None]], -1)
        radii = _rand(gen, (k,), 0.06, 0.14, device) * depth
    else:
        k = 8
        centres = _rand(gen, (k, 3), -0.8, 0.8, device)
        radii = _rand(gen, (k,), 0.18, 0.45, device)
    colours = _rand(gen, (k, 3), 0.05, 0.95, device)
    return centres, radii, colours


def _shade(o, d, cfg, spheres, plane):
    """Colour of rays ``(o, d)``: the nearest sphere hit, shaded, else the
    background (white, or the forward-facing scene's textured plane)."""
    centres, radii, colours = spheres
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    oc = o[:, None, :] - centres[None]
    b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - radii[None] ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 1e-3), t, torch.full_like(t, 1e9))
    tmin, idx = t.min(-1)
    hit = tmin < 1e8
    p = o + d * tmin[:, None]
    nrm = (p - centres[idx]) / radii[idx, None]
    light = torch.tensor(_LIGHT, device=o.device)
    light = light / torch.linalg.norm(light)
    lit = 0.25 + 0.75 * torch.clamp((nrm * light).sum(-1), min=0.0)
    rgb = colours[idx] * lit[:, None]
    if cfg["dataset_type"] == "llff":
        freq, phase = plane
        tp = (-12.0 - o[:, 2]) / d[:, 2]
        q = o + d * tp[:, None]
        bg = 0.5 + 0.4 * torch.sin(q[:, :2] @ freq + phase)
    else:
        bg = torch.ones_like(rgb)
    return torch.where(hit[:, None], rgb, bg)


def make_scene(cfg: dict, gen, device) -> dict:
    """``images [N, H, W, 3]``, ``poses [N, 3, 4]`` (float32, on
    ``device``) and ``train_idx`` (the views not held out)."""
    n, h, w = cfg["n_views"], cfg["H"], cfg["W"]
    if cfg["dataset_type"] == "llff":
        poses = facing_poses(gen, n, device)
    else:
        poses = hemisphere_poses(gen, n, device)
    spheres = _spheres(cfg, gen, device)
    plane = (_rand(gen, (2, 3), -2.0, 2.0, device),
             _rand(gen, (3,), 0.0, 2 * math.pi, device))
    py, px = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    f = float(np.float32(cfg["focal"]))
    images = torch.empty(n, h, w, 3, dtype=torch.float32, device=device)
    for i in range(n):
        o, d = pixel_rays(px.reshape(-1), py.reshape(-1), w, h, f,
                          poses[i])
        images[i] = _shade(o, d, cfg, spheres, plane).reshape(h, w, 3)
    test = set(cfg["test_views"])
    train_idx = np.array([i for i in range(n) if i not in test], np.int64)
    return {"images": images, "poses": poses, "train_idx": train_idx}


def inputs(cfg: dict, seed: int, device) -> tuple:
    """What a run of ``seed`` hands the program and the reference: the
    scene, the family's weights fitted to it (``FIT``), the seed's
    generator as the fit leaves it (poses are drawn next) and the seconds
    the fit took, which are the reference's and not the program's
    set-up."""
    family = families.get(cfg)
    gen = torch.Generator(device).manual_seed(seed)
    sc = make_scene(cfg, gen, device)
    params = family.init_params(cfg, gen, device)
    sync(device)
    t = time.perf_counter()
    params = family.fit(params, sc, cfg, gen)
    sync(device)
    return sc, params, gen, time.perf_counter() - t


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
