"""The work a model does, from its published layer widths, and the
published peaks of the card it is divided by. A step's and a frame's
operations are the configuration's family's (``families/<family>.py``);
the counts below are the NeRF MLP's, which that family and the NeRF
kernels' roofline readers use.

The counts are the algorithm's, whatever kernel computes them: a forward
pass is one multiply-add per weight a point (the bias and ReLU are not
counted); the least work of its backward is the weight gradients (one
multiply-add per weight) plus the input gradients of every layer whose
input is not a fixed encoding (the first layer's, the skip's encoding rows
of l6 and the view-direction rows of l10 need none). Operations are two a
multiply-add.
"""

from __future__ import annotations

import subprocess

from nerfbench import families

# NVIDIA H100 SXM data sheet, dense: FLOP/s or OP/s, and HBM bytes/s.
PEAKS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12, "int8": 1979e12,
         "hbm_bytes_per_s": 3.35e12}


def _widths(cfg: dict) -> tuple[int, int, int, int]:
    w = cfg["netwidth"]
    return w, w // 2, 3 + 6 * cfg["multires"], 3 + 6 * cfg["multires_views"]


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one net at one point: l1 .. l11 and the density
    head (593,408 at the published widths)."""
    w, h, xd, dd = _widths(cfg)
    return (xd * w + 4 * w * w + (w + xd) * w + 2 * w * w + w + w * w
            + (w + dd) * h + h * 3)


def forward_ops(cfg: dict) -> int:
    """Operations of one net's forward pass at one point (1,186,816)."""
    return 2 * forward_macs(cfg)


def backward_ops(cfg: dict) -> int:
    """Least operations of one net's backward pass at one point
    (2,302,208): the weight gradients, and the input gradients but those
    into l1, l6's encoding rows and l10's direction rows."""
    w, h, xd, dd = _widths(cfg)
    macs = forward_macs(cfg)
    return 2 * (macs + macs - xd * w - xd * w - dd * h)


def points_per_ray(cfg: dict) -> int:
    """Points an MLP evaluates a ray: the coarse samples through the coarse
    net, coarse and fine samples through the fine net."""
    return 2 * cfg["N_samples"] + cfg["N_importance"]


def step_ops(cfg: dict) -> int:
    """Model operations of one train step, by the configuration's family
    (NeRF: every point forward and back, 9.146e11 at 1024 rays)."""
    return families.get(cfg).step_ops(cfg)


def frame_ops(cfg: dict) -> int:
    """Model operations of one frame, by the configuration's family."""
    return families.get(cfg).frame_ops(cfg)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi said nothing (rc {out.returncode})"
