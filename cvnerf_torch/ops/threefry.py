"""Threefry-2x32 counter grids and the keyed Feistel draw: the CUDA
kernels' wrappers and their plain PyTorch versions (``csrc/threefry.cu``).

Neither replaces a TPU kernel: the JAX package draws in plain jnp (its
``ops/rng.py``), which XLA fuses into its step. In PyTorch each
draw was a chain of ~130 elementwise ops a threefry, and the Feistel pixel
draw ran on the host; these two kernels make each draw one launch that
reads its key from device memory, so the train step draws on the card and
can be captured in a CUDA graph (``train/loop.py::make_train_scan``).

A key is a ``[2]`` ``int64`` tensor of 32-bit words on any device.
:func:`threefry_bits` and :func:`feistel_draw` launch their kernel for a
key on a card (or raise) and run the plain version for a key on the CPU.
Both are the JAX draws bit for bit: threefry is integer arithmetic, words
are ``uint32`` in the kernel and ``int64`` masked to 32 bits in the plain
versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cvnerf_torch.utils.kernels import load_library

_M32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
# Output layouts of threefry_bits, the kernel's enum Layout.
LAYOUTS = {"pair": 0, "xor": 1, "split": 2}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11; the hash under
    ``jax.random``). Keys are Python ints or int64 tensors, counters int64
    tensors of 32-bit words, all broadcastable against the counters;
    returns the two output words as int64 tensors in ``[0, 2^32)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for block in range(5):
        for r in range(4):
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, _ROTATIONS[(4 * block + r) % 8]) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def check_key(key: torch.Tensor) -> None:
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is a [2] int64 tensor of words, got "
                         f"{key.dtype} {list(key.shape)}")


def _bind(lib) -> None:
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cvnerf_threefry_bits.argtypes = [p, p, p, q, q, q, i, q, p, p]
    lib.cvnerf_threefry_bits.restype = ctypes.c_int
    lib.cvnerf_feistel_draw.argtypes = [p, q, q, i, i, p, p]
    lib.cvnerf_feistel_draw.restype = ctypes.c_int


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _out_shape(rows: int, cols: int, layout: str, width: int) -> tuple:
    return {"pair": (rows, cols, 2), "xor": (rows, cols),
            "split": (rows, width)}[layout]


def threefry_bits_plain(key: torch.Tensor, rows: int, cols: int,
                        c0: torch.Tensor | None = None,
                        c1: torch.Tensor | int = 0, layout: str = "pair",
                        width: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`threefry_bits`, on the key's
    device."""
    threefry_bits_plain.calls += 1
    dev = key.device
    k = key & _M32
    j = torch.arange(cols, dtype=torch.int64, device=dev)
    x1 = ((c1.reshape(1) if torch.is_tensor(c1) else c1) + j) & _M32
    x0 = (c0.to(torch.int64) & _M32 if c0 is not None
          else torch.zeros(rows, dtype=torch.int64, device=dev))
    o0, o1 = threefry2x32(k[0], k[1], x0[:, None].expand(rows, cols),
                          x1[None, :].expand(rows, cols))
    if layout == "pair":
        return torch.stack([o0, o1], dim=-1)
    if layout == "xor":
        return o0 ^ o1
    return torch.cat([o0, o1], dim=-1)[:, :width]


threefry_bits_plain.calls = 0


def threefry_bits(key: torch.Tensor, rows: int, cols: int,
                  c0: torch.Tensor | None = None,
                  c1: torch.Tensor | int = 0, layout: str = "pair",
                  width: int | None = None) -> torch.Tensor:
    """Threefry of ``key`` over the counter grid ``(c0[r], c1 + j)``, ``r
    < rows``, ``j < cols`` (int64 words): ``c0`` an int64 ``[rows]``
    tensor or None for 0, ``c1`` a Python int or an int64 ``[1]`` tensor
    (read on the device). ``layout``: ``"pair"`` ``[rows, cols, 2]`` both
    words; ``"xor"`` ``[rows, cols]`` their xor (``jax.random.bits``);
    ``"split"`` ``[rows, width]`` with ``o0`` at ``j`` and ``o1`` at ``cols
    + j`` where that is ``< width`` (the per-ray streams). A key on a card
    launches the kernel (count in ``threefry_bits.launches``), on the CPU
    runs :func:`threefry_bits_plain`."""
    check_key(key)
    if layout not in LAYOUTS:
        raise ValueError(f"bad layout {layout!r}")
    if layout == "split" and not cols <= (width or 0) <= 2 * cols:
        raise ValueError(f"split width {width} outside [{cols}, {2 * cols}]")
    if key.device.type == "cpu":
        return threefry_bits_plain(key, rows, cols, c0, c1, layout, width)
    dev = key.device
    for name, t in (("c0", c0), ("c1", c1)):
        if torch.is_tensor(t) and (t.device != dev or t.dtype != torch.int64
                                   or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int64 on the key's "
                             f"device {dev}")
    if c0 is not None and c0.numel() != rows:
        raise ValueError(f"c0 has {c0.numel()} rows, expected {rows}")
    if torch.is_tensor(c1) and c1.numel() != 1:
        raise ValueError("c1 must be one value")
    key = key.contiguous()
    out = torch.empty(_out_shape(rows, cols, layout, width),
                      dtype=torch.int64, device=dev)
    lib = load_library("threefry", _bind)
    with torch.cuda.device(dev):
        err = lib.cvnerf_threefry_bits(
            key.data_ptr(), c0.data_ptr() if c0 is not None else None,
            c1.data_ptr() if torch.is_tensor(c1) else None,
            0 if torch.is_tensor(c1) else int(c1), rows * cols, max(cols, 1),
            LAYOUTS[layout], width or 0, out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"threefry_bits kernel launch failed: CUDA error "
                           f"{err}")
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0


def feistel_plan(m: int) -> tuple[int, int]:
    """``(hb, passes)`` of a draw from ``[0, m)``, ``m > 2``: half the even
    Feistel width in bits, and the static cycle-walk pass count of the JAX
    package, ``ceil(-40·ln 2 / ln(1 - p))`` with ``p = m / 2^(2 hb)`` (0
    when ``m`` is a power of two), which leaves an element out of range
    with probability at most 2^-40."""
    total_bits = max(2, (m - 1).bit_length())
    total_bits += total_bits % 2
    p = m / float(1 << total_bits)
    passes = (0 if p >= 1.0
              else int(np.ceil(-40.0 * np.log(2.0) / np.log1p(-p))))
    return total_bits // 2, passes


def feistel_draw_plain(key: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`feistel_draw`, on the key's
    device: the JAX package's ``fori_loop`` to the static pass count, each
    pass re-encrypting the values still out of range, then the guard."""
    feistel_draw_plain.calls += 1
    hb, passes = feistel_plan(m)
    mask = (1 << hb) - 1
    k = key & _M32
    k0, k1 = k[0], k[1]

    def encrypt(x):
        left = (x >> hb) & mask
        right = x & mask
        for rnd in range(4):
            f, _ = threefry2x32(k0 ^ rnd, k1, right,
                                torch.full_like(right, rnd))
            left, right = right, (left ^ f) & mask
        return (left << hb) | right

    base = torch.arange(n, dtype=torch.int64, device=key.device)
    y = encrypt(base)
    for _ in range(passes):
        y = torch.where(y < m, y, encrypt(y))
    return torch.where(y < m, y, base)


feistel_draw_plain.calls = 0


def feistel_draw(key: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``n`` distinct indices in ``[0, m)`` (int64, on the key's device),
    ``2 < m < 2^32``: a keyed 4-round Feistel permutation of ``[0,
    2^(2 hb))`` at ``0..n-1``, made domain-exact by cycle walking (see
    :func:`feistel_plan`). A key on a card launches the kernel (count in
    ``feistel_draw.launches``), on the CPU runs :func:`feistel_draw_plain`."""
    check_key(key)
    if not 0 <= n <= m or not 2 < m < 2 ** 32:
        raise ValueError(f"feistel_draw needs 0 <= n <= m and 2 < m < 2^32, "
                         f"got n={n}, m={m}")
    if key.device.type == "cpu":
        return feistel_draw_plain(key, n, m)
    dev = key.device
    hb, passes = feistel_plan(m)
    key = key.contiguous()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    lib = load_library("threefry", _bind)
    with torch.cuda.device(dev):
        err = lib.cvnerf_feistel_draw(key.data_ptr(), n, m, hb, passes,
                                      out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"feistel_draw kernel launch failed: CUDA error "
                           f"{err}")
    feistel_draw.launches += 1
    return out


feistel_draw.launches = 0
