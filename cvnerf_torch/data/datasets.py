"""Unified scene loading: dispatch, split construction, near/far bounds
(the port's own copy of the JAX package's ``data/datasets.py``).

Parity target: reference ``load_dataset`` (main.py:264-273) plus the split
and bounds logic inlined in ``main()`` (main.py:286-307): for LLFF scenes an
every-``llffhold``-th holdout split and NDC-dependent near/far; for Blender
the json-defined splits and the fixed [2, 6] bounds.

The reference parses an ``llffhold`` flag but hardcodes ``::8``
(main.py:287, SURVEY.md §2.2 dead flags); here the flag is honored.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cvnerf_torch.data.blender import load_blender_data
from cvnerf_torch.data.llff import load_llff_data


@dataclasses.dataclass
class SceneData:
    """Everything the trainer and renderer need about a scene."""
    images: np.ndarray        # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray         # [N, 3, 4] float32 camera-to-world
    render_poses: np.ndarray  # [M, >=3, >=4] video path
    height: int
    width: int
    focal: float
    near: float
    far: float
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    ndc: bool                 # whether rays should be NDC-warped
    dtype: str                # "blender" | "llff"


def load_scene(data_dir: str, dtype: str, *,
               half_res: bool = False, testskip: int = 8,
               white_bkg: bool = False, factor: int = 8,
               no_ndc: bool = False, llffhold: int = 8,
               spherify: bool = False) -> SceneData:
    """Load and normalize a scene for training."""
    if dtype == "blender":
        images, poses, render_poses, hwf, i_split, (near, far) = (
            load_blender_data(data_dir, half_res=half_res,
                              testskip=testskip, bkg=white_bkg))
        train_idx, val_idx, test_idx = i_split
        height, width, focal = hwf
        poses = poses[:, :3, :4]
        ndc = False
    elif dtype == "llff":
        images, poses, render_poses, hwf, i_holdout, bounds = (
            load_llff_data(data_dir, factor=factor, spherify=spherify))
        n = images.shape[0]
        if llffhold > 0:
            test_idx = np.arange(n)[::llffhold]
        else:
            # llffhold <= 0: the NeRF-lineage fallback — hold out the single
            # view closest to the average pose (the loader's i_test, which
            # the reference computes at data_helpers.py:304-306 and then
            # discards in favor of the ::8 split).
            test_idx = np.array([i_holdout])
        val_idx = test_idx
        test_set = set(test_idx.tolist())
        train_idx = np.array([i for i in range(n) if i not in test_set])
        if no_ndc or spherify:
            # Spherified (inward-facing) captures are not forward-facing, so
            # the NDC warp does not apply.
            near = float(bounds.min() * 0.9)
            far = float(bounds.max() * 1.0)
            ndc = False
        else:
            near, far = 0.0, 1.0
            ndc = True
        height, width, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    else:
        raise ValueError(
            f"invalid dtype {dtype!r}: must be 'llff' or 'blender'")

    return SceneData(
        images=np.ascontiguousarray(images, np.float32),
        poses=np.ascontiguousarray(poses[:, :3, :4], np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        height=int(height), width=int(width), focal=float(focal),
        near=float(near), far=float(far),
        train_idx=np.asarray(train_idx), val_idx=np.asarray(val_idx),
        test_idx=np.asarray(test_idx),
        ndc=ndc, dtype=dtype)
