"""Adam's update of every leaf in one launch: the CUDA kernel's wrapper and
its plain PyTorch version (``csrc/adam.cu``).

It replaces no TPU kernel: the JAX package's optimizer is optax's adam in
plain jnp, which XLA fuses into its step. Two per-leaf rules serve the
Instant-NGP field (``models/ngp_field.py``): ``l2``, a factor whose
multiple of the leaf is added to its gradient (the paper's L2 on the MLP
weights), and ``skip_zero``, which leaves a value, its moments and all,
untouched where its gradient is exactly 0 (table entries no sample
touched); a leaf with neither updates as before, bitwise. In PyTorch the
update written per leaf is 14 elementwise launches a leaf (672 a step over
the lego nets' 48 leaves); the kernel does all of them in one.

:func:`fused_adam` takes the leaves as lists of float32 tensors and returns
new ones, leaving its inputs as they were: leaves on the CPU run
:func:`adam_plain`, leaves on a card launch the kernel (or raise). Both give
the same bits: the kernel rounds each of the plain version's ops once, in its
order. The step's scalars ``(-lr, 1 - b1^t, 1 - b2^t)`` are a float32
``[3]`` tensor on the leaves' device (``Adam.scalars``), read there, so a
captured step reads each replay's own values.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cvnerf_torch.utils.kernels import load_library

# The leaves one launch takes (csrc/adam.cu kLeaves: the most whose table of
# 7 pointers and 2 counts a leaf fits the kernel's 4 KB of parameters).
TABLE_LEAVES = 56
THREADS = 256
BLOCKS_PER_SM = 4


def adam_plain(params: list, grads: list, mu: list, nu: list,
               scalars: torch.Tensor, b1: float, b2: float, eps: float,
               skip_zero: list | None = None,
               l2: list | None = None) -> tuple[list, list, list]:
    """The plain version of :func:`fused_adam`, on the leaves' device: ``g
    += l2·p`` on a leaf with an ``l2`` factor, then ``m' = (1 - b1)·g +
    b1·m``, ``v' = (1 - b2)·g² + b2·v``, ``p' = p + step·((m' / bc1) /
    (sqrt(v' / bc2) + eps))``, one PyTorch op at a time; on a ``skip_zero``
    leaf the values whose gradient is exactly 0 keep ``p``, ``m`` and
    ``v``."""
    adam_plain.calls += 1
    n = len(params)
    skip_zero = skip_zero or [False] * n
    l2 = l2 or [0.0] * n
    step, bc1, bc2 = scalars.unbind(0)
    grads = [g + f * p.detach() if f else g
             for g, p, f in zip(grads, params, l2)]
    m_new = [(1 - b1) * g + b1 * m for g, m in zip(grads, mu)]
    v_new = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
    p_new = [p.detach() + step * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
             for p, m, v in zip(params, m_new, v_new)]
    for i in (i for i in range(n) if skip_zero[i]):
        keep = grads[i] == 0
        p_new[i] = torch.where(keep, params[i].detach(), p_new[i])
        m_new[i] = torch.where(keep, mu[i], m_new[i])
        v_new[i] = torch.where(keep, nu[i], v_new[i])
    return p_new, m_new, v_new


adam_plain.calls = 0


def launch_plan(numels: list[int], aligned: list[bool]) -> list[list[tuple]]:
    """The tables of a launch over leaves of ``numels`` values: leaves in
    order, ``TABLE_LEAVES`` a table, each ``(leaf, nvec, nsingle)``: units
    of four values (16-byte loads, only where every pointer of the leaf is
    16-byte aligned) and of one value (the rest)."""
    entries = []
    for i, (n, ok) in enumerate(zip(numels, aligned)):
        nvec = n // 4 if ok else 0
        entries.append((i, nvec, n - 4 * nvec))
    return [entries[i:i + TABLE_LEAVES]
            for i in range(0, len(entries), TABLE_LEAVES)]


def out_offsets(numels: list[int]) -> list[int]:
    """Where each new leaf starts in its third of the output buffer, in
    values, and the third's length last: every leaf at a multiple of four
    values, so that an aligned buffer keeps every leaf 16-byte aligned."""
    out = [0]
    for n in numels:
        out.append(out[-1] + -(-n // 4) * 4)
    return out


def grid_size(units: int, sms: int) -> int:
    """Blocks of a launch over ``units`` work units: one unit a thread, at
    most ``BLOCKS_PER_SM`` blocks an SM (the threads then stride)."""
    return max(1, min(-(-units // THREADS), BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cvnerf_fused_adam.argtypes = [p, p, p, p, p, i, p, f, f, f, f, f, i,
                                      p]
    lib.cvnerf_fused_adam.restype = i
    lib.cvnerf_fused_adam_table_leaves.argtypes = []
    lib.cvnerf_fused_adam_table_leaves.restype = i


def _check(groups: dict, scalars: torch.Tensor) -> torch.device:
    """The one device of every leaf and the scalars; raises on a leaf that
    the kernel does not take."""
    dev = scalars.device
    if (scalars.dtype != torch.float32 or scalars.numel() != 3
            or not scalars.is_contiguous()):
        raise ValueError("scalars must be a contiguous float32 [3] tensor")
    n = len(groups["params"])
    for name, ts in groups.items():
        if len(ts) != n:
            raise ValueError(f"{len(ts)} {name} for {n} params")
        for i, t in enumerate(ts):
            if t.device != dev:
                raise ValueError(f"{name}[{i}] is on {t.device}, the "
                                 f"scalars on {dev}: one device only")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}[{i}] must be contiguous float32, "
                                 f"got {t.dtype}, strides {t.stride()}")
    for i, ts in enumerate(zip(*groups.values())):
        if len({t.shape for t in ts}) != 1:
            raise ValueError(f"leaf {i}: shapes differ "
                             f"{[tuple(t.shape) for t in ts]}")
    return dev


def fused_adam(params: list, grads: list, mu: list, nu: list,
               scalars: torch.Tensor, b1: float, b2: float, eps: float,
               skip_zero: list | None = None,
               l2: list | None = None) -> tuple[list, list, list]:
    """One Adam update of every leaf: ``(new params, new mu, new nu)``,
    each a list in the order of ``params``. Every leaf and ``scalars``
    (float32 ``[-lr, bc1, bc2]``) lie on one device. On the CPU this runs
    :func:`adam_plain`; on a card it launches the kernel once a table of
    ``TABLE_LEAVES`` leaves (count in ``fused_adam.launches``) and raises
    on a leaf that is not contiguous float32 on the scalars' device. The
    new leaves are views of one new buffer, each 16-byte aligned.
    ``skip_zero`` (a flag a leaf) and ``l2`` (a factor a leaf, 0 for none)
    are the rules of :func:`adam_plain`, applied inside the same launch."""
    groups = {"params": params, "grads": grads, "mu": mu, "nu": nu}
    if all(t.device.type == "cpu" for ts in (params, grads, mu, nu, [scalars])
           for t in ts):
        return adam_plain(params, grads, mu, nu, scalars, b1, b2, eps,
                          skip_zero, l2)
    dev = _check(groups, scalars)
    skip_zero = skip_zero or [False] * len(params)
    l2 = [float(np.float32(f)) for f in (l2 or [0.0] * len(params))]
    sizes = [t.numel() for t in params]
    offsets = out_offsets(sizes)
    width = offsets[-1]
    buf = torch.empty(3 * width, dtype=torch.float32, device=dev)
    outs = [[buf[k * width + o:k * width + o + n].view(t.shape)
             for o, n, t in zip(offsets, sizes, params)] for k in range(3)]
    ins = list(groups.values())
    ptrs = [[t.data_ptr() for t in leaf]
            for leaf in zip(*ins, *outs)]
    aligned = [all(p % 16 == 0 for p in leaf) for leaf in ptrs]
    # PyTorch's float32 casts of the plain version's Python scalars.
    c1, c2, f1, f2, fe = (float(np.float32(x))
                          for x in (1 - b1, 1 - b2, b1, b2, eps))
    lib = load_library("adam", _bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for table in launch_plan(sizes, aligned):
        units = sum(nvec + nsingle for _, nvec, nsingle in table)
        if units == 0:
            continue
        tp = np.array([ptrs[i] for i, _, _ in table], dtype=np.int64)
        nvec = np.array([e[1] for e in table], dtype=np.int64)
        nsingle = np.array([e[2] for e in table], dtype=np.int64)
        skip = np.array([skip_zero[i] for i, _, _ in table], dtype=np.int32)
        factors = np.array([l2[i] for i, _, _ in table], dtype=np.float32)
        with torch.cuda.device(dev):
            err = lib.cvnerf_fused_adam(
                tp.ctypes.data, nvec.ctypes.data, nsingle.ctypes.data,
                skip.ctypes.data, factors.ctypes.data, len(table),
                scalars.data_ptr(), c1, f1, c2, f2, fe,
                grid_size(units, _sms(dev.index)), stream)
        if err != 0:
            raise RuntimeError(f"fused_adam kernel launch failed: CUDA error "
                               f"{err}")
        fused_adam.launches += 1
    return outs[0], outs[1], outs[2]


fused_adam.launches = 0
