"""Ray geometry, encoding, sampling, compositing and the fused MLP kernels."""

from cvnerf_torch.ops.encoding import freq_encode, encoding_dim
from cvnerf_torch.ops.rays import (
    camera_ray_directions,
    compute_rays,
    ray_grid,
    rays_for_pixels,
    ndc_rays,
)
from cvnerf_torch.ops.sampling import stratified_samples, sample_pdf
from cvnerf_torch.ops.compositing import volume_render

__all__ = [
    "freq_encode",
    "encoding_dim",
    "camera_ray_directions",
    "compute_rays",
    "ray_grid",
    "rays_for_pixels",
    "ndc_rays",
    "stratified_samples",
    "sample_pdf",
    "volume_render",
]
