"""The port imports neither ``jax`` nor the JAX package, and imports
``imageio``, ``cv2``, ``PIL`` and ``tensorboardX`` only inside functions
(the card's host has none of them).

``tests/conftest.py`` imports jax into this process, so the import check
runs in a fresh subprocess. A static scan backs it up for code paths no
import reaches (lazy imports inside functions).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cvnerf_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import cvnerf_torch
names = ["cvnerf_torch"] + [m.name for m in pkgutil.walk_packages(
    cvnerf_torch.__path__, "cvnerf_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke   # its __main__ guard keeps it from running
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "cvnerf_tpu")))
bad += sorted(m for m in sys.modules
              if m.split(".")[0] in ("imageio", "cv2", "PIL", "tensorboardX"))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    counted, names = res.stdout.splitlines()[:2]
    assert int(counted.split()[0]) >= 40   # every module was imported
    assert {"cvnerf_torch.render.occupancy", "cvnerf_torch.render.mesh",
            "cvnerf_torch.utils.lpips"} <= set(names.split())


def _sources():
    files = (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
             + sorted(PORT.rglob("*.cuh")))
    assert len(files) >= 30
    return files


def test_port_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)|cvnerf_tpu", re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in _sources() for m in pattern.finditer(p.read_text())]
    assert not hits, hits


def test_optional_libraries_are_imported_only_inside_functions():
    pattern = re.compile(
        r"^(import|from)\s+(imageio|cv2|PIL|tensorboardX)\b", re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0)}"
            for p in _sources() if p.suffix == ".py"
            for m in pattern.finditer(p.read_text())]
    text = (ROOT / "chip_smoke.py").read_text()
    hits += [m.group(0) for m in pattern.finditer(text)]
    assert not hits, hits


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` names the replaced TPU kernel's file in its report,
    so its scan looks at import statements only."""
    pattern = re.compile(
        r"^\s*(import\s+(jax|cvnerf_tpu)\b|from\s+(jax|cvnerf_tpu)\b)"
        r"|import_module\(\s*['\"](jax|cvnerf_tpu)", re.M)
    text = (ROOT / "chip_smoke.py").read_text()
    assert not pattern.search(text)
