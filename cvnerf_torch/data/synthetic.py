"""Numpy-only synthetic scenes and camera poses (the port's own copy of
the JAX package's ``data/synthetic.py`` and ``data/poses.py`` parts that
need no image files): the benchmarks' ``bench_scene``, the analytic
emissive-sphere render and ``pose_spherical``. Bit for bit the JAX
package's arrays; the PNG-writing dataset generators come with the data
loaders (they need ``imageio``).
"""

from __future__ import annotations

import numpy as np


def _translate_z(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rotate_x(phi: float) -> np.ndarray:
    """Rotation about the x axis (reference ``rot_phi``)."""
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rotate_y(theta: float) -> np.ndarray:
    """Rotation about the y axis, reference sign convention
    (``rot_theta``, data_helpers.py:27-31: -sin at [0,2], +sin at [2,0])."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


# Axis remap applied last: reflect x, swap y and z (data_helpers.py:40).
_AXIS_FLIP = np.array([[-1, 0, 0, 0],
                       [0, 0, 1, 0],
                       [0, 1, 0, 0],
                       [0, 0, 0, 1]], dtype=np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world 4×4 on a sphere looking at the origin.

    Composition order matches reference ``pose_spherical``
    (data_helpers.py:34-41): translate by radius, pitch by phi, yaw by theta,
    then the global axis flip.
    """
    c2w = _translate_z(radius)
    c2w = _rotate_x(np.deg2rad(phi_deg)) @ c2w
    c2w = _rotate_y(np.deg2rad(theta_deg)) @ c2w
    return _AXIS_FLIP @ c2w


def _ray_grid_np(h, w, focal, c2w):
    """Host-side pinhole ray grid (mirrors ops.rays.compute_rays, which
    mirrors reference main.py:19-46) — numpy so generation needs no jax."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    dirs = np.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                     -np.ones_like(x)], -1)
    dirs_w = np.einsum("hwk,jk->hwj", dirs, c2w[:3, :3])
    origins = np.broadcast_to(c2w[:3, -1], dirs_w.shape)
    return origins, dirs_w


def render_sphere_scene(h, w, focal, c2w, radius=1.0, texture="normals"):
    """Analytic render: an emissive sphere at the origin over white.

    ``texture="normals"`` colors by surface normal (smooth);
    ``texture="checker"`` adds a high-frequency checkerboard in spherical
    coordinates (stresses the upper positional-encoding bands).
    Returns float32 RGBA in [0, 1].
    """
    o, d = _ray_grid_np(h, w, focal, c2w)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    # |o + t d|^2 = r^2
    b = 2 * np.sum(o * d, -1)
    c = np.sum(o * o, -1) - radius ** 2
    disc = b ** 2 - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2, 0.0)
    p = o + t[..., None] * d
    normal = p / max(radius, 1e-9)
    rgb = np.clip(0.5 + 0.5 * normal, 0, 1).astype(np.float32)
    if texture == "checker":
        theta = np.arctan2(normal[..., 1], normal[..., 0])
        phi = np.arccos(np.clip(normal[..., 2], -1, 1))
        checker = ((np.floor(theta / np.pi * 8)
                    + np.floor(phi / np.pi * 8)) % 2)
        rgb = rgb * (0.35 + 0.65 * checker[..., None]).astype(np.float32)
    alpha = hit.astype(np.float32)[..., None]
    rgb = rgb * alpha  # premultiplied-style: background black under alpha 0
    return np.concatenate([rgb, alpha], -1)


def bench_scene(h, w):
    """The benchmark harnesses' 2-image synthetic scene, shape-identical to
    the lego training workload at ``(400, 400)``.

    Returns ``(images [2,h,w,3] float32, poses [2,3,4] float32)`` — a
    gradient+stripe texture, its vertical flip, and two identity-rotation
    cameras at z=4 (the blender-scene camera distance).
    """
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([xx / w, yy / h, ((xx + yy) % 40) / 40.0],
                   -1).astype(np.float32)
    images = np.stack([img, img[::-1].copy()], 0)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    return images, poses
