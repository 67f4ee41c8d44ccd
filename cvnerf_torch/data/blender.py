"""Blender-synthetic dataset ingest (`transforms_{train,val,test}.json`);
the port's own copy of the JAX package's ``data/blender.py``, reading PNGs
through ``utils/png.py`` and resizing through ``utils/resize.py`` (no
``imageio``, no ``cv2``).

Parity target: reference ``load_blender_data`` (data_helpers.py:45-109):
per-split frame lists with a test/val skip, /255 normalization, focal from
``camera_angle_x``, 40 spherical render poses, optional half-resolution via
area-interpolated resize, white-background alpha compositing, and the
hardcoded [2.0, 6.0] scene bounds.
"""

from __future__ import annotations

import json
import os

import numpy as np

from cvnerf_torch.data.poses import spherical_render_poses
from cvnerf_torch.utils.png import read_image
from cvnerf_torch.utils.resize import area_resize

SPLITS = ("train", "val", "test")
BLENDER_NEAR_FAR = (2.0, 6.0)  # reference data_helpers.py:109


def load_blender_data(basedir: str, half_res: bool = False,
                      testskip: int = 1, bkg: bool = False):
    """Load a Blender-format scene.

    Args:
        basedir: directory with ``transforms_{split}.json`` and image files.
        half_res: halve H/W/focal, resizing images with INTER_AREA
            (reference data_helpers.py:93-102).
        testskip: stride over val/test frames (train always loads all;
            0 means stride 1 — reference data_helpers.py:59-62).
        bkg: composite RGBA over white (``rgb*a + (1-a)``); otherwise the
            alpha channel is dropped (reference data_helpers.py:104-107).
    Returns:
        (images [N,H,W,3] float32, poses [N,4,4] float32,
         render_poses [40,4,4], (H, W, focal), i_split 3-list of index
         arrays, (near, far)).
    """
    metas = {}
    for s in SPLITS:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in SPLITS:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_image(fname))
            poses.append(np.asarray(frame["transform_matrix"],
                                    dtype=np.float32))
        imgs = (np.asarray(imgs) / 255.0).astype(np.float32)
        all_imgs.append(imgs)
        all_poses.append(np.stack(poses, 0) if poses
                         else np.zeros((0, 4, 4), np.float32))
        counts.append(counts[-1] + imgs.shape[0])

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    # An empty split (e.g. no val frames) stacks to shape (0,); drop those
    # from the concat so they don't poison the [N,H,W,C] layout (the
    # reference crashes on an empty split, data_helpers.py:78).
    imgs = np.concatenate([a for a in all_imgs if a.size], 0)
    poses = np.concatenate(all_poses, 0)

    height, width = imgs.shape[1:3]
    # Read intrinsics from the train split. The reference reads whichever
    # split's meta was loaded last (test; data_helpers.py:85-88) — identical
    # for well-formed scenes, but per-split intrinsics would diverge there;
    # the train split is the sane, deliberate choice here.
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)

    render_poses = spherical_render_poses(n=40, phi_deg=-30.0, radius=4.0)

    if half_res:
        height, width = height // 2, width // 2
        focal = focal / 2.0
        resized = np.zeros((imgs.shape[0], height, width, imgs.shape[-1]),
                           dtype=np.float32)
        for i, img in enumerate(imgs):
            resized[i] = area_resize(img, (width, height))
        imgs = resized

    if imgs.shape[-1] == 4:
        if bkg:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]

    return (imgs.astype(np.float32), poses, render_poses,
            (int(height), int(width), float(focal)), i_split,
            BLENDER_NEAR_FAR)
