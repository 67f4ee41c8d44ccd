"""The build of the CUDA kernels: each ``csrc/*.cu``, by stem in
``SOURCES``, is compiled by ``nvcc`` at first use (never at import) into
``build/cvnerf_torch_kernels/<stem>_<hash>.so`` and bound by its wrapper
in ``ops/`` (:func:`load_library`), so a new kernel is its ``.cu`` and its
wrapper."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {p.stem: p for p in sorted(_CSRC.glob("*.cu"))}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cvnerf_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_lib_lock = threading.Lock()


def nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the kernels are built from "
                       f"{_CSRC} on a machine with the CUDA toolkit")


def build_library(name: str, verbose: bool = False) -> Path:
    """Compile the kernel source ``SOURCES[name]`` into a shared library (if
    this source and header hash has not been built yet) and return its
    path. Safe to call from several processes and threads: each compiles
    to a temporary file and renames it. ``verbose`` builds with
    ``-Xptxas -v``, prints the report (registers, stack, spills per kernel)
    and keeps it beside the library (:func:`ptxas_log`)."""
    source = SOURCES[name]
    blob = source.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"{name}_{digest[:16]}.so"
    if out.exists():
        return out
    compiler = nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):"
                           f"\n{res.stderr}")
    if verbose:
        if res.stderr:
            print(res.stderr, flush=True)
        ptxas_log(out).write_text(res.stderr)
    os.replace(tmp, out)
    return out


def ptxas_log(library: Path) -> Path:
    """Where a verbose build keeps the ptxas report of ``library``."""
    return library.with_suffix(".ptxas.txt")


def load_library(name: str, bind) -> ctypes.CDLL:
    """The built library ``name``, loaded once; ``bind(lib)`` sets its
    functions' ctypes signatures on first load."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_library(name)))
            bind(lib)
            _libs[name] = lib
        return _libs[name]
