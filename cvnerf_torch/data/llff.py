"""LLFF/COLMAP real-capture ingest (`poses_bounds.npy` + `images/`); the
port's own copy of the JAX package's ``data/llff.py``, reading PNGs through
``utils/png.py`` (other formats through ``imageio`` where it is installed)
and resizing through ``utils/resize.py``.

Parity targets: reference ``load_llff`` (data_helpers.py:114-197) and
``load_llff_data`` (data_helpers.py:261-324): the (N,17) poses_bounds layout,
factor downsampling, the [y, -x, z] axis-convention fixup, scene rescale by
``1/(min_bound*0.75)``, recentering to the average pose, the 120-pose spiral
render path, and the closest-to-mean holdout index.

Deliberate fixes over the reference (documented, SURVEY.md §2.3-8):
  * image filenames are **sorted** — the reference uses raw ``os.listdir``
    order, so pose↔image pairing there depends on filesystem enumeration
    order, which is wrong on most filesystems;
  * 4-channel PNGs are alpha-composited then kept in [0, 1] — the reference
    divides skimage's already-[0,1] ``rgba2rgb`` output by 255 again
    (data_helpers.py:165-166), crushing RGBA images to near-black.
"""

from __future__ import annotations

import os

import numpy as np

from cvnerf_torch.data.poses import (
    average_pose,
    recenter_poses,
    spherify_poses,
    spiral_render_path,
)
from cvnerf_torch.utils.png import read_image
from cvnerf_torch.utils.resize import area_resize

_IMAGE_EXTS = (".png", ".jpg", ".JPG", ".jpeg", ".PNG")


def _read_poses_bounds(topdir: str):
    """poses_bounds.npy → (poses [N,3,5], bounds [N,2]).

    File layout (reference data_helpers.py:115-132): each of N rows is a
    flattened 3×5 pose block (3×4 c2w + [H, W, focal] column) followed by the
    2 depth bounds.
    """
    raw = np.load(os.path.join(topdir, "poses_bounds.npy"))
    poses = raw[:, :-2].reshape(-1, 3, 5)
    bounds = raw[:, -2:]
    return poses.astype(np.float64), bounds.astype(np.float64)


def _read_images(topdir: str, factor: int | None):
    """Load ``images/*`` sorted by filename, optionally downsampled."""
    imgdir = os.path.join(topdir, "images")
    files = sorted(
        os.path.join(imgdir, f) for f in os.listdir(imgdir)
        if f.endswith(_IMAGE_EXTS))
    out = []
    for path in files:
        img = read_image(path)
        if factor:
            h, w = img.shape[:2]
            img = area_resize(img, (int(w / factor), int(h / factor)))
        img = img.astype(np.float32) / 255.0
        if img.ndim == 3 and img.shape[-1] == 4:
            # Composite over white in [0,1] (fixes the reference's double
            # normalization of rgba2rgb output, data_helpers.py:164-166).
            img = img[..., :3] * img[..., -1:] + (1.0 - img[..., -1:])
        out.append(img)
    return np.stack(out, 0)


def process_llff_poses(poses: np.ndarray, bounds: np.ndarray):
    """Pose pipeline shared by ``load_llff_data``: axis fixup, scene rescale,
    recentering, spiral path, holdout index.

    Separated from image loading so it can run (and be validated) on a bare
    ``poses_bounds.npy`` — e.g. the bundled real COLMAP skull capture, whose
    images are not committed (SURVEY.md §0).

    Args:
        poses: ``[N, 3, 5]`` raw LLFF pose blocks (c2w + hwf column).
        bounds: ``[N, 2]`` depth bounds.
    Returns:
        (poses [N,3,5] float32 recentered, render_poses [120,3,5] float32,
         bounds [N,2] float32 rescaled, i_test int).
    """
    # COLMAP/LLFF [x,y,z] → NeRF [y,-x,z] axis fixup
    # (reference data_helpers.py:270, done there in (3,5,N) layout).
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2)
    poses = poses.astype(np.float32)
    bounds = bounds.astype(np.float32)

    # Rescale so the nearest bound sits at ~1.33 (reference
    # data_helpers.py:276-278).
    scale = 1.0 / (bounds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale

    poses = recenter_poses(poses)

    # Spiral render path around the average pose (reference
    # data_helpers.py:283-302).
    c2w = average_pose(poses)
    up = poses[:, :3, 1].sum(0)
    up = up / np.linalg.norm(up)
    close_d, inf_d = bounds.min() * 0.9, bounds.max() * 5.0
    focus_depth = 1.0 / ((1.0 - 0.75) / close_d + 0.75 / inf_d)
    radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
    render_poses = spiral_render_path(c2w, up, radii, focus_depth,
                                      zrate=0.5, rots=2, n=120)

    # Holdout: the view closest to the average camera center (reference
    # data_helpers.py:304-306; overridden by the ::8 split downstream, as in
    # reference main.py:287).
    dist = np.sum((c2w[:3, 3] - poses[:, :3, 3]) ** 2, axis=-1)
    i_test = int(np.argmin(dist))
    return poses, render_poses, bounds, i_test


def load_llff_data(topdir: str, factor: int | None = 8,
                   spherify: bool = False):
    """Load an LLFF/COLMAP scene.

    Returns:
        (images [N,H,W,3] float32, poses [N,3,4] float32,
         render_poses [120,3,5] float32, hwf [3] float32, i_test int,
         bounds [N,2] float32).
    """
    poses, bounds = _read_poses_bounds(topdir)
    images = _read_images(topdir, factor)
    if images.shape[0] != poses.shape[0]:
        raise ValueError(
            f"{topdir}: {images.shape[0]} images but {poses.shape[0]} poses "
            "in poses_bounds.npy")

    if factor:
        # Rewrite the H,W rows and scale focal (reference
        # data_helpers.py:189-192).
        poses[:, :2, 4] = np.asarray(images.shape[1:3], np.float64)
        poses[:, 2, 4] = poses[:, 2, 4] / factor

    poses, render_poses, bounds, i_test = process_llff_poses(poses, bounds)
    if spherify:
        poses, render_poses, bounds = spherify_poses(poses, bounds)

    hwf = poses[0, :3, -1].copy()
    return (images.astype(np.float32), poses[:, :3, :4], render_poses, hwf,
            i_test, bounds)
