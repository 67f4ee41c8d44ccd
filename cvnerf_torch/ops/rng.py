"""Counter-based per-ray RNG and the key derivations of ``jax.random``,
bit for bit (port of the JAX package's ``ops/rng.py``).

A key is an ``int64`` tensor of its two 32-bit words, exactly the
``uint32[2]`` data of a JAX ``PRNGKey``, on any device. Every stream here
equals the one the JAX package draws from the same key: the renderer's
per-ray jitter, resample and noise (``ray_uniform`` / ``ray_sorted_uniform``
/ ``ray_normal``, keyed by ``(key, tag, global ray id)``), the trainer's
pixel draws (``sample_without_replacement``, and ``permutation`` /
``choice_without_replacement`` for its ``"parity"`` sampling), the key
derivations the train step uses (``PRNGKey``, ``fold_in``, ``split``,
``randint``, ``bernoulli``) and the int8 calibration's draws (``uniform``,
``randint``, ``normal``), as JAX 0.9.0 computes them with
``jax_threefry_partitionable`` on (its default).

Every function takes the key words from the tensor on the key's own device
and draws there (``device=`` moves the key first): on a card the threefry
and Feistel kernels of ``ops/threefry.py`` read the words from device
memory, so no draw or key derivation reads a device value back to the host
and a train step can be captured in a CUDA graph; on the CPU their plain
versions run. PyTorch has no full uint32 arithmetic, so the plain versions
hold words in ``int64`` masked to 32 bits after every add and shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cvnerf_torch.ops.threefry import (check_key, feistel_draw, threefry2x32,
                                       threefry_bits)

__all__ = ["PRNGKey", "key_on", "fold_in", "split", "random_bits",
           "uniform", "normal", "bernoulli", "randint", "ray_uniform",
           "ray_sorted_uniform", "ray_normal", "sample_without_replacement",
           "permutation", "choice_without_replacement", "threefry2x32"]

_M32 = 0xFFFFFFFF


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: the key
    words are ``(0, seed mod 2^32)``, on the CPU."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def key_on(key: torch.Tensor,
           device: str | torch.device | None = None) -> torch.Tensor:
    """``key`` on ``device`` (itself when it lies there or ``device`` is
    None). A key on the host goes to a card through pinned memory, without
    waiting for the card's queue."""
    check_key(key)
    if device is None:
        return key
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if key.device == dev:
        return key
    if key.device.type == "cpu" and dev.type == "cuda":
        return key.pin_memory().to(dev, non_blocking=True)
    return key.to(dev)


def fold_in(key: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the seed words ``(0, data)``.
    ``data`` is a Python int or a one-value int64 tensor on the key's
    device (read there: a step index inside a captured block)."""
    if torch.is_tensor(data):
        return threefry_bits(key, 1, 1, c1=data.reshape(1)).reshape(2)
    return threefry_bits(key, 1, 1, c1=int(data) & _M32).reshape(2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): key ``i`` is the
    threefry pair of counter ``(0, i)``. Returns ``[num, 2]``."""
    return threefry_bits(key, 1, num).reshape(num, 2)


def random_bits(key: torch.Tensor, shape: tuple[int, ...],
                device: str | torch.device | None = None) -> torch.Tensor:
    """32-bit ``jax.random.bits`` (partitionable layout): the threefry
    pair of the flat index ``(hi, lo)``, xor-ed."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError("at most 2^32 - 1 values per draw")
    return threefry_bits(key_on(key, device), 1, size,
                         layout="xor").reshape(shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words → float32 uniforms in ``[0, 1)``: the top 23 bits into
    the mantissa of ``[1, 2)``, minus 1 (``jax.random.uniform``'s
    construction)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: tuple[int, ...],
            device: str | torch.device | None = None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` over ``[minval, maxval)`` in float32: the unit
    floats as ``floats * (maxval - minval) + minval``, held at ``minval``
    from below, the bounds and their difference in float32. XLA fuses the
    multiply-add into one FMA (one rounding); the product and the sum are
    exact in float64, so forming them there and rounding once is that
    FMA."""
    floats = _bits_to_unit_float(random_bits(key, shape, device))
    # Filled on the device (no host copy): the same float32 roundings.
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    fma = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fma.float())


_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_ABOVE_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _erfinv(v: torch.Tensor) -> torch.Tensor:
    """``erfinv`` of float32 ``v``, formed in float64 and rounded once. On the
    CPU torch splits the float32 op over threads, and one thread's share
    has been seen to come out with about 16 correct bits (a relative error
    of 2e-5 to 7e-5 against float64, the other shares 1e-7), a run in 75;
    through float64 every share keeps float32 accuracy."""
    return torch.special.erfinv(v.double()).float()


def normal(key: torch.Tensor, shape: tuple[int, ...],
           device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2)·erfinv(u)`` of uniforms
    over ``[nextafter(-1, 0), 1)`` (bit for bit JAX's)."""
    return _SQRT2 * _erfinv(uniform(key, shape, device, _ABOVE_MINUS_ONE, 1.0))


def bernoulli(key: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)`` for one scalar draw: a 0-d bool
    tensor on the key's device."""
    return uniform(key, ()) < torch.full((), p, dtype=torch.float32,
                                         device=key.device)


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int, device: str | torch.device | None = None
            ) -> torch.Tensor:
    """``jax.random.randint`` into int32 ``[minval, maxval)``: two 32-bit
    draws from ``split(key)`` combined modulo the span, with uint32
    wrap-around where JAX's arithmetic wraps."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key_on(key, device))
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((higher % span) * mult) & _M32) + lower % span
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


def _ray_bits(key: torch.Tensor, tag: int, ray_ids: torch.Tensor,
              n: int) -> torch.Tensor:
    """``[len(ray_ids), n]`` 32-bit words, entry ``(i, j)`` a function of
    ``(key, tag, ray_ids[i], j, n)``: counters ``(ray_id, 0..m-1)`` with
    ``m = ceil(n/2)``, output words laid out ``[o0 | o1][:n]`` — streams
    are stable per ``(tag, n)``, not prefix-stable across ``n``. Drawn on
    the ray ids' device."""
    key = fold_in(key_on(key, ray_ids.device), tag)
    ids = ray_ids.to(torch.int64).contiguous()
    return threefry_bits(key, ids.shape[0], (n + 1) // 2, c0=ids,
                         layout="split", width=n)


def ray_uniform(key: torch.Tensor, tag: int, ray_ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``[len(ray_ids), n]`` float32 uniforms in ``[0, 1)``; row ``i``
    depends only on ``(key, tag, ray_ids[i])``."""
    return _bits_to_unit_float(_ray_bits(key, tag, ray_ids, n))


def ray_sorted_uniform(key: torch.Tensor, tag: int, ray_ids: torch.Tensor,
                       n: int) -> torch.Tensor:
    """``[len(ray_ids), n]`` float32 uniforms, ascending per ray: the
    exponential-spacings construction of ``n`` order statistics from
    ``n + 1`` uniforms, clamped one ulp below 1."""
    u = ray_uniform(key, tag, ray_ids, n + 1)
    e = -torch.log1p(-u)
    s = torch.cumsum(e, dim=-1)
    total = torch.clamp(s[..., -1:], min=1e-37)
    return torch.clamp(s[..., :n] / total, max=_BELOW_ONE)


def ray_normal(key: torch.Tensor, tag: int, ray_ids: torch.Tensor,
               n: int) -> torch.Tensor:
    """``[len(ray_ids), n]`` float32 standard normals,
    ``sqrt(2)·erfinv(2u - 1)`` with the lower end held one ulp inside -1."""
    u = ray_uniform(key, tag, ray_ids, n)
    v = torch.clamp(2.0 * u - 1.0, min=_ABOVE_MINUS_ONE)
    return _SQRT2 * _erfinv(v)


def sample_without_replacement(key: torch.Tensor, n: int, m: int,
                               device: str | torch.device | None = None
                               ) -> torch.Tensor:
    """``n`` distinct indices in ``[0, m)`` (int64, on the key's device): a
    keyed 4-round Feistel permutation of ``[0, 2^bits)`` evaluated at
    ``0..n-1`` and made domain-exact by cycle walking, with the JAX
    package's static pass count (``ops/threefry.py::feistel_draw``, one
    kernel launch on a card)."""
    if n > m:
        raise ValueError(f"cannot draw {n} distinct values from [0, {m})")
    key = key_on(key, device)
    if m > 2:
        return feistel_draw(key, n, m)
    base = torch.arange(n, dtype=torch.int64, device=key.device)
    if m == 2:
        return torch.where(bernoulli(key), 1 - base, base)
    return base


def permutation(key: torch.Tensor, n: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): JAX's ``_shuffle`` of
    ``arange(n)``, ``ceil(3·ln n / ln(2^32 - 1))`` rounds (1 up to n =
    1,625, 2 up to about 2.6 M, 3 beyond), each splitting the key, drawing
    one 32-bit word per element and sorting the elements by their words
    with a stable sort, so equal words keep their order as in
    ``lax.sort_key_val``. The words are compared as unsigned (they are held
    in int64). Runs on the key's device (``device`` moves it first)."""
    key = key_on(key, device)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        words = random_bits(sub, (n,))
        x = x[torch.sort(words, stable=True).indices]
    return x


def choice_without_replacement(key: torch.Tensor, n: int, m: int,
                               device: str | torch.device | None = None
                               ) -> torch.Tensor:
    """``jax.random.choice(key, m, (n,), replace=False)``: the first ``n``
    entries of ``permutation(key, m)`` (int64, on the key's device or
    ``device``)."""
    if n > m:
        raise ValueError(f"cannot draw {n} distinct values from [0, {m})")
    return permutation(key, m, device)[:n]
