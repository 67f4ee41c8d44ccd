"""Rendering: the coarse/fine volume renderer, full-frame orchestration and
mesh export."""

from cvnerf_torch.render.renderer import (RenderConfig, render_rays,
                                          render_rays_chunked)
from cvnerf_torch.render.frames import (render, render_image,
                                        render_poses_to_frames)
from cvnerf_torch.render.mesh import (extract_mesh, marching_tetrahedra,
                                      query_density_grid, save_obj)

__all__ = [
    "RenderConfig",
    "extract_mesh",
    "marching_tetrahedra",
    "query_density_grid",
    "render",
    "render_rays",
    "render_rays_chunked",
    "render_image",
    "render_poses_to_frames",
    "save_obj",
]
