"""Model families: a configuration names the model it runs by its
``"family"`` key (``"nerf"`` where it has none), and the cells reach that
model only through the module ``nerfbench.families.<family>``: the port's
training configuration and renderer, the starting weights and their fit,
the plain reference's steps and frames, and the operations a step and a
frame do. ``nerf.py`` documents the functions a family module defines.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "nerf"


def present() -> list[str]:
    """The families that have a module under ``nerfbench/families/``."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def get(cfg: dict):
    """The family module of configuration ``cfg``; ``SystemExit`` naming
    the families present where it names none of them."""
    name = cfg.get("family", DEFAULT)
    module = f"{__name__}.{name}"
    if isinstance(name, str) and name.isidentifier():
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as err:
            if err.name != module:
                raise
    raise SystemExit(f"no model family {name!r}: nerfbench/families/ "
                     f"holds {', '.join(present())}")
