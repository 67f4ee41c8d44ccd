"""Dataset ingest: Blender-synthetic and LLFF/COLMAP captures, and the
synthetic scenes."""

from cvnerf_torch.data.blender import load_blender_data
from cvnerf_torch.data.llff import load_llff_data
from cvnerf_torch.data.poses import (
    pose_spherical,
    spherical_render_poses,
    view_matrix,
    average_pose,
    recenter_poses,
    spiral_render_path,
)
from cvnerf_torch.data.datasets import SceneData, load_scene
from cvnerf_torch.data.synthetic import (
    make_blender_dataset,
    make_llff_dataset,
    make_llff_360_dataset,
)

__all__ = [
    "make_blender_dataset",
    "make_llff_dataset",
    "make_llff_360_dataset",
    "load_blender_data",
    "load_llff_data",
    "pose_spherical",
    "spherical_render_poses",
    "view_matrix",
    "average_pose",
    "recenter_poses",
    "spiral_render_path",
    "SceneData",
    "load_scene",
]
