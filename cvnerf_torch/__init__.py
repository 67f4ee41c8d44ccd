"""cvnerf_torch: the PyTorch/CUDA port of the JAX NeRF package, for NVIDIA
Hopper.

The JAX package beside it is the reference this package is held
against; module names mirror it one to one. This package imports ``torch``
and never ``jax`` or the JAX package.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise when CUDA is missing — there is no silent CPU fallback.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is visible (entry points never fall back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: cvnerf_torch entry points default to "
            "device='cuda'; pass device='cpu' explicitly to run on the CPU")
    return dev


def staged(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, copied through pinned memory
    without making the host wait for the device's queue."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
