"""Camera-pose utilities: spherical render poses and the LLFF pose pipeline
(the port's own copy of the JAX package's ``data/poses.py``, bit for bit).

Parity targets: reference ``data_helpers.py:13-41`` (spherical poses for
Blender spiral videos) and ``data_helpers.py:199-259`` (view matrix, average
pose, recentering, spiral path). All host-side numpy — poses are tiny and
computed once per run.
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


def spherical_render_poses(n: int = 40, phi_deg: float = -30.0,
                           radius: float = 4.0) -> np.ndarray:
    """The reference's 360° video path: ``n`` poses, θ ∈ [-180, 180)
    (data_helpers.py:91)."""
    thetas = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([pose_spherical(t, phi_deg, radius) for t in thetas], 0)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] camera orientation from forward axis, up hint, and position
    (reference ``view_matrix``, data_helpers.py:199-213)."""
    z_axis = z / np.linalg.norm(z)
    x_axis = np.cross(up, z_axis)
    x_axis = x_axis / np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    y_axis = y_axis / np.linalg.norm(y_axis)
    return np.stack([x_axis, y_axis, z_axis, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """[3, 5] mean camera pose (+hwf column) of ``[N, 3, 5]`` poses
    (reference ``avg_poses``, data_helpers.py:215-233): mean center, summed
    z axis, summed up hint."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].sum(0)
    z = z / np.linalg.norm(z)
    up = poses[:, :3, 1].sum(0)
    m = view_matrix(z, up, center)
    return np.concatenate([m, hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses so the average pose becomes the identity
    (reference ``recenter``, data_helpers.py:235-245)."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]], dtype=poses.dtype)
    c2w = np.concatenate([average_pose(poses)[:3, :4], bottom], axis=0)
    hom = np.concatenate(
        [poses[:, :3, :4],
         np.broadcast_to(bottom, (poses.shape[0], 1, 4))], axis=1)
    hom = np.linalg.inv(c2w) @ hom
    out[:, :3, :4] = hom[:, :3, :4]
    return out


def spherify_poses(poses: np.ndarray, bounds: np.ndarray):
    """Recenter an inward-facing (360°) capture onto the unit sphere and
    build a circular render path.

    The reference parses a ``--spherify`` flag but never implements it
    (reference main.py:450, SURVEY.md §2.2 dead flags); this is the standard
    LLFF treatment, provided as a working extension: find the point closest
    to all camera optical axes (least squares), translate it to the origin,
    scale so the mean camera distance is 1, and orbit a circle of render
    cameras looking at the center.

    Args:
        poses: ``[N, 3, 5]`` recentered pose blocks (+hwf column).
        bounds: ``[N, 2]`` depth bounds.
    Returns:
        (poses [N,3,5], render_poses [120,3,5], bounds [N,2]), all float32.
    """
    dirs = poses[:, :3, 2]                       # camera optical axes
    origins = poses[:, :3, 3]
    # Point minimizing sum of squared distances to the lines o + t·d:
    # sum_i (I - d d^T) p = sum_i (I - d d^T) o.
    eye = np.eye(3)
    a = np.zeros((3, 3))
    rhs = np.zeros(3)
    for d, o in zip(dirs, origins):
        d = d / np.linalg.norm(d)
        m = eye - np.outer(d, d)
        a += m
        rhs += m @ o
    # pinv: for (near-)parallel optical axes — e.g. a forward-facing capture
    # passed through spherify — the system is singular along the shared
    # axis; the pseudo-inverse picks the minimum-norm center.
    center = np.linalg.pinv(a) @ rhs

    out = poses.copy().astype(np.float32)
    out[:, :3, 3] = origins - center
    scale = 1.0 / np.mean(np.linalg.norm(out[:, :3, 3], axis=-1))
    out[:, :3, 3] *= scale
    bounds = (bounds * scale).astype(np.float32)

    # Circular render path at the mean camera height, looking at the origin.
    radius = float(np.mean(np.linalg.norm(out[:, :3, 3][:, :2], axis=-1)))
    height = float(np.mean(out[:, 2, 3]))
    up = out[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    hwf = out[0, :3, 4:5]
    render = []
    for theta in np.linspace(0.0, 2 * np.pi, 121)[:-1]:
        pos = np.array([radius * np.cos(theta), radius * np.sin(theta),
                        height])
        z = pos / np.linalg.norm(pos)            # look at the origin
        render.append(np.concatenate([view_matrix(z, up, pos), hwf], 1))
    return out, np.stack(render, 0).astype(np.float32), bounds


def spiral_render_path(c2w: np.ndarray, up: np.ndarray, radii: np.ndarray,
                       focus_depth: float, zrate: float = 0.5,
                       rots: int = 2, n: int = 120) -> np.ndarray:
    """Spiral of ``n`` poses around the average camera for LLFF videos
    (reference ``render_path_spiral``, data_helpers.py:247-259).

    Each pose orbits the average camera at per-axis ``radii`` while looking
    at a point ``focus_depth`` in front of it; z oscillates at ``zrate``
    times the orbit frequency.
    """
    poses = []
    r = np.append(np.asarray(radii, dtype=np.float64), 1.0)
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        offs = np.array([np.cos(theta), -np.sin(theta),
                         -np.sin(theta * zrate), 1.0]) * r
        pos = c2w[:3, :4] @ offs
        look = c2w[:3, :4] @ np.array([0.0, 0.0, -focus_depth, 1.0])
        z = pos - look
        z = z / np.linalg.norm(z)
        poses.append(np.concatenate([view_matrix(z, up, pos), hwf], axis=1))
    return np.stack(poses, 0).astype(np.float32)
