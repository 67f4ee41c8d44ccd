"""Instant-NGP's multiresolution hash encoding (Müller et al. 2022,
arXiv:2201.05989): the CUDA kernels' wrappers (``csrc/hash_encode.cu``),
their plain PyTorch versions and the ``torch.autograd.Function`` that
makes the encoding differentiable in its tables.

It replaces no TPU kernel: the JAX package has no hash-grid field. It was
added for the Instant-NGP field (``models/ngp_field.py``), whose work a
sample is 128 corner gathers forward and 128 scatter-adds backward beside
9,408 multiply-adds of small MLPs. What bounds it on this card: bytes
forward (the gathered table entries, 8 B each, and 128 B of features out
a sample; the whole table, 48.8 MB at the published widths, is about the
H100's L2), atomic throughput backward (128 ``float2`` adds a sample into
an fp32 gradient table). The first kernels are correct and simple: one
thread a (sample, level), the level on the grid's y axis.

The geometry is tiny-cuda-nn's ``grid.h``, written once here
(:func:`grid_levels`, :func:`corner_index`, :func:`corner_weights`) and
repeated op for op in the kernel: level ``l`` has scale ``s_l = N_min ·
b^l - 1`` (``b = (N_max / N_min)^(1 / (L - 1))``) and resolution
``ceil(s_l) + 1``; its table holds ``min(T, res^3 rounded up to 8)``
entries of ``F = 2`` features. A unit position ``x`` (clamped to [0, 1])
sits at ``pos = x · s_l + 0.5`` (two roundings), ``floor(pos)`` is its
cell, ``pos - floor(pos)`` its fraction. Corner ``c`` (bit ``d`` of ``c``:
the upper corner in dimension ``d``) has weight ``Π_d (frac_d or 1 -
frac_d)``, multiplied in order ``d = 0, 1, 2``, and index ``x₀ + x₁·res +
x₂·res²`` on a dense level (``res³ <= T``), else the uint32 hash ``x₀ ⊕
x₁·2654435761 ⊕ x₂·805459861`` (products that wrap), either taken modulo
the level's entries. A level's two features are ``Σ_c w_c · e_c`` over the
corners in order ``c = 0..7``, each product and sum rounded once.

Tables are one ``[entries, 2]`` float32 leaf a level. :func:`hash_encode`
takes unit positions ``[n, 3]`` and the level tables and returns ``[n, 2L]``
features, level-major, in float32 or bfloat16: CPU tensors run the plain
version, card tensors launch the kernel (or raise; ``plain=True`` runs the
plain version on the card). The forward is bitwise the plain version's on the same card; the
backward's atomic adds sum in no fixed order, so its gradients agree with
the plain version's to float32 rounding. ``stats`` counts the kernels'
launches and the samples and corner lookups encoded (by kernel or plain
version), as ``GraphProgram.stats`` counts: at eager calls and at captures,
not at replays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from cvnerf_torch.utils.kernels import load_library

_M32 = 0xFFFFFFFF
PRIMES = (1, 2654435761, 805459861)
FEATURES = 2
CORNERS = 8
# The levels one launch takes (csrc/hash_encode.cu kMaxLevels).
MAX_LEVELS = 32

stats = {"fwd_launches": 0, "bwd_launches": 0, "plain_calls": 0,
         "samples": 0, "lookups": 0}


@dataclasses.dataclass(frozen=True)
class GridLevel:
    """One level: its scale (float32), resolution, table entries, whether
    it is indexed densely, and its first entry in the levels' concatenation
    (the gradient buffer)."""
    scale: float
    res: int
    entries: int
    dense: bool
    offset: int


def grid_levels(n_levels: int, log2_table: int, base_res: int,
                max_res: int) -> tuple[GridLevel, ...]:
    """The levels of a grid, as tiny-cuda-nn forms them (the scale in
    float64, rounded once to float32)."""
    if n_levels > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {n_levels}")
    growth = (math.log2(max_res / base_res) / (n_levels - 1)
              if n_levels > 1 else 0.0)
    table = 1 << log2_table
    out, offset = [], 0
    for level in range(n_levels):
        scale = float(np.float32(2.0 ** (level * growth) * base_res - 1.0))
        res = math.ceil(scale) + 1
        entries = min(table, -(-res ** 3 // 8) * 8)
        out.append(GridLevel(scale, res, entries, res ** 3 <= entries,
                             offset))
        offset += entries
    return tuple(out)


def total_entries(levels: tuple[GridLevel, ...]) -> int:
    return levels[-1].offset + levels[-1].entries


def corner_index(level: GridLevel, q: torch.Tensor) -> torch.Tensor:
    """Table index of integer corners ``q [..., 3]`` (int64) on ``level``:
    dense or hashed, modulo the level's entries."""
    x0, x1, x2 = q.unbind(-1)
    if level.dense:
        idx = x0 + x1 * level.res + x2 * (level.res * level.res)
    else:
        idx = (x0 * PRIMES[0]) ^ ((x1 * PRIMES[1]) & _M32) \
            ^ ((x2 * PRIMES[2]) & _M32)
    return idx % level.entries


def corner_weights(unit: torch.Tensor, level: GridLevel
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 8 corners of each position's cell on ``level``: table indices
    ``[n, 8]`` (int64) and trilinear weights ``[n, 8]`` (float32), corner
    ``c`` upper in dimension ``d`` where bit ``d`` of ``c`` is set."""
    pos = unit.clamp(0.0, 1.0) * level.scale + 0.5
    cell = torch.floor(pos)
    frac = pos - cell
    cell = cell.to(torch.int64)
    idx, wts = [], []
    for c in range(CORNERS):
        w = torch.ones_like(frac[:, 0])
        q = []
        for d in range(3):
            if c >> d & 1:
                w = w * frac[:, d]
                q.append(cell[:, d] + 1)
            else:
                w = w * (1.0 - frac[:, d])
                q.append(cell[:, d])
        idx.append(corner_index(level, torch.stack(q, -1)))
        wts.append(w)
    return torch.stack(idx, -1), torch.stack(wts, -1)


def _count(n: int, levels) -> None:
    stats["samples"] += n
    stats["lookups"] += n * len(levels) * CORNERS


def hash_encode_plain(unit: torch.Tensor, tables: list,
                      levels: tuple[GridLevel, ...],
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the forward kernel: ``[n, 2L]`` features of
    unit positions ``[n, 3]``, on their device."""
    stats["plain_calls"] += 1
    _count(unit.shape[0], levels)
    feats = []
    for level, table in zip(levels, tables):
        idx, w = corner_weights(unit, level)
        vals = table.detach()[idx]                           # [n, 8, 2]
        acc = torch.zeros_like(vals[:, 0])
        for c in range(CORNERS):
            acc = acc + w[:, c, None] * vals[:, c]
        feats.append(acc)
    return torch.cat(feats, -1).to(out_dtype)


def hash_encode_bwd_plain(unit: torch.Tensor, grad: torch.Tensor,
                          levels: tuple[GridLevel, ...]) -> torch.Tensor:
    """The plain version of the backward kernel: the gradient of every
    level's table, ``[total entries, 2]`` float32 (level ``l`` at rows
    ``offset_l ..``), from the features' gradient ``grad [n, 2L]``."""
    stats["plain_calls"] += 1
    out = torch.zeros(total_entries(levels), FEATURES, dtype=torch.float32,
                      device=unit.device)
    for k, level in enumerate(levels):
        idx, w = corner_weights(unit, level)
        g = grad[:, FEATURES * k:FEATURES * (k + 1)]
        out.index_add_(0, (idx + level.offset).reshape(-1),
                       (w[:, :, None] * g[:, None, :]).reshape(-1, FEATURES))
    return out


def _bind(lib) -> None:
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.cvnerf_hash_encode_fwd, lib.cvnerf_hash_encode_bwd):
        fn.argtypes = [p, p, q, p, p, p, p, p, i, i, p]
        fn.restype = i


def _level_arrays(levels) -> list[np.ndarray]:
    return [np.array([lv.entries for lv in levels], np.int32),
            np.array([lv.res for lv in levels], np.int32),
            np.array([lv.scale for lv in levels], np.float32),
            np.array([int(lv.dense) for lv in levels], np.int32)]


def _check_positions(unit: torch.Tensor) -> None:
    if (unit.dtype != torch.float32 or unit.dim() != 2
            or unit.shape[1] != 3 or not unit.is_contiguous()):
        raise ValueError(f"positions must be contiguous float32 [n, 3], got "
                         f"{unit.dtype} {list(unit.shape)}")


def _check(unit: torch.Tensor, tables: list, levels) -> torch.device:
    dev = unit.device
    _check_positions(unit)
    if len(tables) != len(levels):
        raise ValueError(f"{len(tables)} tables for {len(levels)} levels")
    for k, (t, lv) in enumerate(zip(tables, levels)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (lv.entries, FEATURES)
                or not t.is_contiguous()):
            raise ValueError(
                f"table {k} must be contiguous float32 [{lv.entries}, "
                f"{FEATURES}] on {dev}, got {t.dtype} {list(t.shape)} on "
                f"{t.device}")
    return dev


def _launch(fn_name: str, unit, ptrs, levels, out_ptr, extra: int,
            dev) -> None:
    n = unit.shape[0]
    if n == 0:
        return
    lib = load_library("hash_encode", _bind)
    ents, res, scale, dense = _level_arrays(levels)
    tp = np.array(ptrs, dtype=np.int64)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            unit.data_ptr(), out_ptr, n, tp.ctypes.data, ents.ctypes.data,
            res.ctypes.data, scale.ctypes.data, dense.ctypes.data,
            len(levels), extra, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def hash_encode_fwd(unit: torch.Tensor, tables: list,
                    levels: tuple[GridLevel, ...],
                    out_dtype: torch.dtype = torch.float32,
                    plain: bool = False) -> torch.Tensor:
    """``[n, 2L]`` features (float32 or bfloat16) of unit positions ``[n,
    3]``: the kernel ``hash_encode_fwd`` for card tensors, the plain
    version for CPU tensors or with ``plain``."""
    if unit.device.type == "cpu" or plain:
        return hash_encode_plain(unit, tables, levels, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features are float32 or bfloat16, not {out_dtype}")
    dev = _check(unit, tables, levels)
    out = torch.empty(unit.shape[0], FEATURES * len(levels), dtype=out_dtype,
                      device=dev)
    _launch("cvnerf_hash_encode_fwd", unit, [t.data_ptr() for t in tables],
            levels, out.data_ptr(), int(out_dtype == torch.bfloat16), dev)
    stats["fwd_launches"] += 1
    _count(unit.shape[0], levels)
    return out


def hash_encode_bwd(unit: torch.Tensor, grad: torch.Tensor,
                    levels: tuple[GridLevel, ...],
                    plain: bool = False) -> torch.Tensor:
    """The tables' gradient ``[total entries, 2]`` float32 from the
    features' gradient ``grad [n, 2L]``: zeroed, then the kernel
    ``hash_encode_bwd``'s atomic adds, for card tensors; the plain version
    for CPU tensors or with ``plain``."""
    grad = grad.float().contiguous()
    if unit.device.type == "cpu" or plain:
        return hash_encode_bwd_plain(unit, grad, levels)
    _check_positions(unit)
    if tuple(grad.shape) != (unit.shape[0], FEATURES * len(levels)):
        raise ValueError(f"gradient {list(grad.shape)} for {unit.shape[0]} "
                         f"positions of {len(levels)} levels")
    out = torch.zeros(total_entries(levels), FEATURES, dtype=torch.float32,
                      device=unit.device)
    ptrs = [out[lv.offset].data_ptr() for lv in levels]
    _launch("cvnerf_hash_encode_bwd", unit, ptrs, levels, grad.data_ptr(),
            0, unit.device)
    stats["bwd_launches"] += 1
    return out


class HashEncode(torch.autograd.Function):
    """The encoding, differentiable in its tables (positions are data: the
    renderer detaches sample depths, so their gradient is None). The
    backward's level gradients are views of one buffer."""

    @staticmethod
    def forward(ctx, unit, levels, out_dtype, plain, *tables):
        ctx.save_for_backward(unit)
        ctx.levels, ctx.plain = levels, plain
        return hash_encode_fwd(unit, list(tables), levels, out_dtype, plain)

    @staticmethod
    def backward(ctx, g):
        (unit,) = ctx.saved_tensors
        flat = hash_encode_bwd(unit, g, ctx.levels, plain=ctx.plain)
        return (None, None, None, None,
                *(flat[lv.offset:lv.offset + lv.entries]
                  for lv in ctx.levels))


def hash_encode(unit: torch.Tensor, tables: list,
                levels: tuple[GridLevel, ...],
                out_dtype: torch.dtype = torch.float32,
                plain: bool = False) -> torch.Tensor:
    """``[n, 2L]`` features of unit positions ``[n, 3]`` in ``out_dtype``
    (float32, or bfloat16 for a first layer that reads bfloat16: each
    feature rounded once from its float32 sum), differentiable in
    ``tables`` (:class:`HashEncode`)."""
    return HashEncode.apply(unit.contiguous(), levels, out_dtype, plain,
                            *tables)
