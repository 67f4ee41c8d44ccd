"""Shared sizes of the benchmark's CPU tests: the configurations cut to a
few rays of a tiny frame, so the port runs its plain versions here."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
# Several test workers share the cores: a few threads each.
torch.set_num_threads(2)

TINY = dict(H=24, W=32, netwidth=32, multires=4, multires_views=2,
            N_samples=8, N_importance=8, N_rand=64, chunk=256)
# A short fit of the nets the cells start from (at the tests' learning
# rate, below, tiny nets leave uniform frames behind after it).
FIT = {"steps": 60, "rays": 256, "precrop_steps": 10, "noise_std": 1.0}


@pytest.fixture(autouse=True)
def tiny_fit(monkeypatch):
    """Every test fits the nets with ``FIT``."""
    from nerfbench import scene
    monkeypatch.setattr(scene, "FIT", FIT)


def tiny(cfg: dict, **extra) -> dict:
    """``cfg`` at the tests' size (focal scaled with the width), with a
    learning rate at which tiny nets fit a scene in tens of steps."""
    return {**cfg, **TINY, "focal": cfg["focal"] * TINY["W"] / cfg["W"],
            "lrate": 5e-3,
            "n_views": 6 if cfg["ndc"] else 8,
            "test_views": [0] if cfg["ndc"] else [], **extra}
