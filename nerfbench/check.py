"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and each has a limit of its own in the
cell's file (``cells/<workload>.json``, ``"limits"``), set between the
program's readings over a dozen seeds and the control's (``PERF.md``).

Training: the loss of each of the first steps and of the first block's
last step, relative to the reference's; each leaf's gradient norm at the
first step and each leaf's change after the first steps and after the
first block, as the gap between the program's norm and the reference's
over the larger of that leaf's reference norm and the median leaf's, the
worst leaf reported, and for the first gradient and change also the
median leaf (steady where rounding flips a few samples of one small leaf,
``PERF.md``). Serving: the mean absolute gap of a served frame's
8-bit pixels from the reference frame's, the worst sampled frame reported.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

# Leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone, and are left out of a change.
STILL_LEAF = 1e-3


def leaf_norms(leaves: list[torch.Tensor]) -> list[float]:
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def leaf_gaps(prog: list[float], ref: list[float],
              keep: list[bool] | None = None) -> list[float]:
    """Each (kept) leaf's ``|prog - ref| / max(ref, median ref)``."""
    med = statistics.median(ref)
    keep = keep or [True] * len(ref)
    return [abs(p - r) / max(r, med)
            for p, r, k in zip(prog, ref, keep) if k]


def moving(ref_grads: list[float]) -> list[bool]:
    """Which leaves count in a change: those whose reference gradient is at
    least ``STILL_LEAF`` of the median leaf's."""
    med = statistics.median(ref_grads)
    return [g >= STILL_LEAF * med for g in ref_grads]


def rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the first steps),
    ``block_loss``, ``grads1`` (the first step's gradient leaves),
    ``change`` (leaves after the first steps less the start) and
    ``block_change`` (after the first block); returns the compared
    numbers."""
    rg = leaf_norms(ref["grads1"])
    keep = moving(rg)
    grad = leaf_gaps(leaf_norms(prog["grads1"]), rg)
    change = leaf_gaps(leaf_norms(prog["change"]), leaf_norms(ref["change"]),
                       keep)
    return {
        "loss_gap": max(rel(p, r) for p, r in zip(prog["losses"],
                                                  ref["losses"])),
        "block_loss_gap": rel(prog["block_loss"], ref["block_loss"]),
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        "change_gap": max(change),
        "change_gap_median": statistics.median(change),
        "block_change_gap": max(leaf_gaps(
            leaf_norms(prog["block_change"]),
            leaf_norms(ref["block_change"]), keep)),
    }


def to_byte(rgb: torch.Tensor) -> np.ndarray:
    """A ``[0, 1]`` float frame as the 8-bit frame a server sends
    (``floor(255 clip(x))``)."""
    return (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8).cpu().numpy()


def frame_mae(served: np.ndarray, ref8: np.ndarray) -> float:
    """Mean absolute gap of two 8-bit frames, over 255. A small error of
    the colours moves a pixel across a level with a probability in
    proportion to it, so this mean grows with the error in proportion (a
    root mean square would grow with its square root)."""
    d = served.astype(np.float64) - ref8.astype(np.float64)
    return float(np.mean(np.abs(d)) / 255.0)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` (every number the cell compares within its limit) and
    each compared number beside its limit. A cell compares the numbers its
    ``limits`` name; one named with the limit None is read and printed
    but not compared (``PERF.md`` says why)."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items() if lim is not None}
    ok = bool(checks) and all(np.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
