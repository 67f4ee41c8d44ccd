"""Frozen copies of the draws a NeRF train step makes, in numpy ``uint32``.

These are ``jax.random``'s threefry-2x32 key derivations (``PRNGKey``,
``fold_in``, ``split``, ``bits``, ``randint``) with the partitionable
layout, the per-ray counter streams keyed by ``(key, tag, ray id)`` (tag 1
the stratified jitter, 2 the sorted resample uniforms, 3 and 4 the coarse
and fine density noise) and the keyed 4-round Feistel permutation that
draws a step's pixels without replacement. They are written here from the
algorithms, independently of the program under test, so the reference can
follow the program's train steps draw for draw.

A key is a ``uint32[2]`` array. Every function is integer arithmetic on the
host; the uniforms are float32 (numpy, or torch on the CPU where the
float arithmetic follows: ``sorted_uniforms``, ``normals``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)
_BELOW_ONE = np.nextafter(np.float32(1.0), np.float32(0.0))
_ABOVE_MINUS_ONE = np.nextafter(np.float32(-1.0), np.float32(0.0))
_SQRT2 = np.float32(np.sqrt(2.0))


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def threefry2x32(k0, k1, c0, c1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) of the counter
    ``(c0, c1)`` under the key ``(k0, k1)``; every argument broadcasts,
    words wrap at 2^32."""
    k0, k1 = _u32(k0), _u32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    c0, c1 = np.broadcast_arrays(_u32(c0), _u32(c1))
    with np.errstate(over="ignore"):
        x0 = c0 + k0
        x1 = c1 + k1
        for block in range(5):
            for r in range(4):
                rot = np.uint32(_ROTATIONS[(4 * block + r) % 8])
                x0 = x0 + x1
                x1 = ((x1 << rot) | (x1 >> (np.uint32(32) - rot))) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)`` for an int32 seed: the words ``(0, seed mod 2^32)``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """The key of ``data``: threefry of the counter ``(0, data)``."""
    o0, o1 = threefry2x32(key[0], key[1], 0, int(data) & 0xFFFFFFFF)
    return np.array([o0, o1], np.uint32).reshape(2)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` keys: key ``i`` is threefry of the counter ``(0, i)``."""
    o0, o1 = threefry2x32(key[0], key[1], 0, np.arange(num))
    return np.stack([o0, o1], -1)


def bits(key: np.ndarray, n: int) -> np.ndarray:
    """``n`` 32-bit words: the xor of the threefry pair of ``(0, i)``."""
    o0, o1 = threefry2x32(key[0], key[1], 0, np.arange(n))
    return o0 ^ o1


def randint(key: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """``n`` integers in ``[minval, maxval)`` from two words each (the
    higher and the lower draw of ``split(key)``), reduced modulo the span
    with 32-bit wrap-around."""
    k1, k2 = split(key)
    higher = bits(k1, n).astype(np.uint64)
    lower = bits(k2, n).astype(np.uint64)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & 0xFFFFFFFF) % span
    off = (((higher % span) * mult) & 0xFFFFFFFF) + lower % span
    off = (off & 0xFFFFFFFF) % span
    return minval + off.astype(np.int64)


def ray_bits(key: np.ndarray, tag: int, ray_ids: np.ndarray,
             n: int) -> np.ndarray:
    """``[len(ray_ids), n]`` words: counters ``(ray id, j)`` for ``j <
    ceil(n / 2)`` under ``fold_in(key, tag)``, laid out ``[o0 | o1][:n]``."""
    k = fold_in(key, tag)
    m = (n + 1) // 2
    o0, o1 = threefry2x32(k[0], k[1], np.asarray(ray_ids)[:, None],
                          np.arange(m)[None, :])
    return np.concatenate([o0, o1], -1)[:, :n]


def unit_floats(words: np.ndarray) -> np.ndarray:
    """Words → float32 uniforms in ``[0, 1)``: the top 23 bits as the
    mantissa of a float in ``[1, 2)``, minus 1."""
    f = ((words >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniforms(key, tag, ray_ids, n) -> np.ndarray:
    """``[len(ray_ids), n]`` float32 uniforms of stream ``tag``."""
    return unit_floats(ray_bits(key, tag, ray_ids, n))


def sorted_uniforms(key, tag, ray_ids, n) -> torch.Tensor:
    """``[len(ray_ids), n]`` ascending float32 uniforms a ray: the
    exponential-spacings construction from ``n + 1`` uniforms, clamped one
    ulp below 1 (float32 torch on the CPU)."""
    u = torch.from_numpy(uniforms(key, tag, ray_ids, n + 1))
    s = torch.cumsum(-torch.log1p(-u), dim=-1)
    total = torch.clamp(s[..., -1:], min=1e-37)
    return torch.clamp(s[..., :n] / total, max=float(_BELOW_ONE))


def normals(key, tag, ray_ids, n) -> torch.Tensor:
    """``[len(ray_ids), n]`` float32 standard normals, ``sqrt(2)
    erfinv(2u - 1)`` with the lower end one ulp inside -1 (erfinv in
    float64, rounded once)."""
    u = torch.from_numpy(uniforms(key, tag, ray_ids, n))
    v = torch.clamp(2.0 * u - 1.0, min=float(_ABOVE_MINUS_ONE))
    return float(_SQRT2) * torch.special.erfinv(v.double()).float()


def feistel_plan(m: int) -> tuple[int, int]:
    """``(half width in bits, cycle-walk passes)`` of a draw from ``[0,
    m)``: the even width that covers ``m``, and the pass count that leaves
    an element out of range with probability at most 2^-40."""
    total = max(2, (m - 1).bit_length())
    total += total % 2
    p = m / float(1 << total)
    passes = 0 if p >= 1.0 else int(math.ceil(-40.0 * math.log(2.0)
                                              / math.log1p(-p)))
    return total // 2, passes


def without_replacement(key: np.ndarray, n: int, m: int) -> np.ndarray:
    """``n`` distinct indices in ``[0, m)``, ``m > 2``: a 4-round Feistel
    permutation keyed by ``key`` at ``0 .. n-1``, each value out of range
    encrypted again, up to the plan's passes, then left at its index."""
    hb, passes = feistel_plan(m)
    mask = np.uint32((1 << hb) - 1)
    k0, k1 = _u32(key[0]), _u32(key[1])

    def encrypt(x):
        left, right = (x >> np.uint32(hb)) & mask, x & mask
        for rnd in range(4):
            f, _ = threefry2x32(k0 ^ np.uint32(rnd), k1, right, rnd)
            left, right = right, (left ^ f) & mask
        return (left << np.uint32(hb)) | right

    base = np.arange(n, dtype=np.uint32)
    y = encrypt(base)
    for _ in range(passes):
        y = np.where(y < m, y, encrypt(y))
    return np.where(y < m, y, base).astype(np.int64)
