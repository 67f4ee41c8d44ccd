"""LPIPS perceptual distance (Zhang et al. 2018), AlexNet variant (port of
the JAX package's ``utils/lpips.py``).

Weights are pluggable: the AlexNet features and the LPIPS calibration load
from one ``.npz`` (the same keys and layout as the JAX package's loader),
exported once wherever torchvision and lpips are installed by the snippet
``export_weights_script()`` returns. No Pallas kernel computes LPIPS, so
the graph is PyTorch's own ``conv2d`` and ``max_pool2d``, on the device
the weights were loaded to, in full fp32 (no TF32).

Graph (``lpips.LPIPS(net='alex', spatial=False, lpips=True)``): inputs in
[0, 1] scaled to [-1, 1] and normalized by fixed shift/scale constants;
AlexNet's five conv→relu stages with 3×3/stride-2 max-pools before stages
2 and 3, each stage's output a tap; per tap: unit-normalize over channels,
squared difference, the non-negative per-channel calibration, spatial
mean; the sum over the five taps.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature-extractor layout: (out_ch, kernel, stride, padding).
_STAGES = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_BEFORE = (1, 2)          # a max-pool precedes these stage indices
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_WEIGHT_KEYS = tuple(
    [f"conv{i}_w" for i in range(5)] + [f"conv{i}_b" for i in range(5)]
    + [f"lin{i}" for i in range(5)])


def load_weights(path: str, device: str | torch.device = "cpu") -> dict:
    """Load an LPIPS weight bundle (``.npz``; see ``export_weights_script``)
    as float32 tensors on ``device``: conv weights in OIHW layout, the
    calibration as ``[C]`` non-negative vectors."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found: {path!r}. Export them once in any "
            "environment with torchvision+lpips installed — run the "
            "snippet from cvnerf_torch.utils.lpips.export_weights_script().")
    data = np.load(path)
    missing = [k for k in _WEIGHT_KEYS if k not in data]
    if missing:
        raise ValueError(f"{path}: missing LPIPS weight arrays {missing}")
    w = {k: torch.as_tensor(np.asarray(data[k], np.float32), device=device)
         for k in _WEIGHT_KEYS}
    for i, (ch, k, _, _) in enumerate(_STAGES):
        got = tuple(w[f"conv{i}_w"].shape)
        want_in = 3 if i == 0 else _STAGES[i - 1][0]
        if got != (ch, want_in, k, k):
            raise ValueError(f"conv{i}_w: expected {(ch, want_in, k, k)}, "
                             f"got {got}")
        if tuple(w[f"lin{i}"].shape) != (ch,):
            raise ValueError(f"lin{i}: expected ({ch},), "
                             f"got {tuple(w[f'lin{i}'].shape)}")
    return w


def export_weights_script() -> str:
    """The snippet that produces the ``.npz`` this module loads."""
    return (
        "import numpy as np, lpips\n"
        "m = lpips.LPIPS(net='alex')\n"
        "feats = m.net.slice1[0], m.net.slice2[1], m.net.slice3[1], \\\n"
        "        m.net.slice4[0], m.net.slice5[0]\n"
        "out = {}\n"
        "for i, c in enumerate(feats):\n"
        "    out[f'conv{i}_w'] = c.weight.detach().numpy()\n"
        "    out[f'conv{i}_b'] = c.bias.detach().numpy()\n"
        "for i, l in enumerate(m.lins):\n"
        "    out[f'lin{i}'] = l.model[-1].weight.detach().numpy()"
        ".reshape(-1)\n"
        "np.savez('lpips_alex.npz', **out)\n")


def _alexnet_taps(w: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """Post-relu feature maps of the five stages; ``x``: ``[N, 3, H, W]``."""
    taps = []
    for i, (_, _, stride, pad) in enumerate(_STAGES):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 3, 2)
        x = F.conv2d(x, w[f"conv{i}_w"], stride=stride, padding=pad)
        x = torch.relu(x + w[f"conv{i}_b"][None, :, None, None])
        taps.append(x)
    return taps


@torch.no_grad()
def _lpips_nchw(w: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dev = a.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]

    def prep(x):
        return ((2.0 * x - 1.0) - shift) / scale

    def unit(t):
        return t * torch.rsqrt(torch.sum(t * t, dim=1, keepdim=True) + 1e-10)

    total = 0.0
    for i, (ta, tb) in enumerate(zip(_alexnet_taps(w, prep(a)),
                                     _alexnet_taps(w, prep(b)))):
        diff2 = (unit(ta) - unit(tb)) ** 2
        lin = w[f"lin{i}"][None, :, None, None]
        total = total + torch.mean(torch.sum(diff2 * lin, dim=1),
                                   dim=(1, 2))
    return total


def lpips_images(a, b, weights: dict | str) -> float:
    """LPIPS distance between two ``[H, W, 3]`` float images in [0, 1]
    (numpy arrays or tensors), computed on the weights' device.

    ``weights``: a bundle from :func:`load_weights` or its path (loaded to
    the CPU). Images below 32×32 are refused: the stride-4 stem and the two
    valid pools leave an empty last feature map.
    """
    if isinstance(weights, str):
        weights = load_weights(weights)
    dev = weights["conv0_w"].device
    a = torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a)
                        else a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(np.asarray(b, np.float32) if not torch.is_tensor(b)
                        else b, dtype=torch.float32, device=dev)
    if a.shape != b.shape or a.dim() != 3 or a.shape[-1] != 3:
        raise ValueError(f"expected matching [H,W,3] images, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if min(a.shape[:2]) < 32:
        raise ValueError(f"image too small for AlexNet-LPIPS: "
                         f"{tuple(a.shape)}")
    na = a.permute(2, 0, 1)[None].contiguous()
    nb = b.permute(2, 0, 1)[None].contiguous()
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        return float(_lpips_nchw(weights, na, nb)[0])
