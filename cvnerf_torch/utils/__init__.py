"""Host-side utilities: images, video, metrics, PSNR, checkpoint
conversion."""

from cvnerf_torch.utils.image import to_byte, psnr, write_png, write_video
from cvnerf_torch.utils.metrics import MetricsLogger

__all__ = ["to_byte", "psnr", "write_png", "write_video", "MetricsLogger"]
