"""Image and video output and quality metrics (port of the JAX package's
``utils/image.py``). PNGs go through the port's own codec
(``utils/png.py``); ``imageio`` and ``cv2`` are imported inside
``write_video`` only, to try an mp4 encoder. Neither is needed to train,
evaluate or serve.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from cvnerf_torch.utils import png


def to_byte(x: np.ndarray) -> np.ndarray:
    """[0, 1] float image → uint8."""
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def psnr(mse: float) -> float:
    """Peak signal-to-noise ratio in dB from mean squared error."""
    return float(-10.0 * np.log10(max(float(mse), 1e-12)))


def psnr_images(a: np.ndarray, b: np.ndarray) -> float:
    return psnr(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def ssim_images(a: np.ndarray, b: np.ndarray,
                data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004): 11×11 gaussian window (σ=1.5),
    per-channel, biased moments, reflect-padded borders."""
    from scipy.ndimage import gaussian_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def g(x):
        # sigma=1.5 with truncate=3.5 → radius 5 → the canonical 11-tap
        # window, applied over the two spatial axes only.
        sigmas = (1.5, 1.5) + (0,) * (x.ndim - 2)
        return gaussian_filter(x, sigmas, truncate=3.5, mode="reflect")

    mu_a, mu_b = g(a), g(b)
    var_a = g(a * a) - mu_a ** 2
    var_b = g(b * b) - mu_b ** 2
    cov = g(a * b) - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(ssim_map.mean())


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write a [0, 1] float image as an 8-bit PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png.write_png(path, to_byte(rgb))


def write_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """Write ``[N, H, W, 3]`` float frames to an mp4 at ``fps``.

    Tries ``imageio`` (ffmpeg backend) first, then OpenCV's mp4v writer,
    and falls back to a directory of PNG frames written by the port's own
    codec, so a host with neither library still gets every frame. Returns
    the path written.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames8 = to_byte(frames)
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, list(frames8), fps=fps, quality=8)
        return path
    except Exception:  # noqa: BLE001 — no imageio or no ffmpeg backend
        pass
    try:
        import cv2
        h, w = frames8.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames8:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception as e:  # noqa: BLE001 — degrade to PNG frames, loudly
        print(f"[WARN] mp4 encode failed for {path} ({e!r}); "
              "falling back to a PNG frame directory", file=sys.stderr)
    framedir = path + ".frames"
    os.makedirs(framedir, exist_ok=True)
    for i, f in enumerate(frames8):
        png.write_png(os.path.join(framedir, f"{i:03d}.png"), f)
    return framedir
