"""Counter-based per-ray RNG and the key derivations of ``jax.random``,
bit for bit (port of the JAX package's ``ops/rng.py``).

A key is a CPU ``int64`` tensor of its two 32-bit words, exactly the
``uint32[2]`` data of a JAX ``PRNGKey``. Every stream here equals the one
the JAX package draws from the same key: the renderer's per-ray jitter,
resample and noise (``ray_uniform`` / ``ray_sorted_uniform`` /
``ray_normal``, keyed by ``(key, tag, global ray id)``), the trainer's pixel
draws (``sample_without_replacement``, and ``permutation`` /
``choice_without_replacement`` for its ``"parity"`` sampling), the key derivations the
train step uses (``PRNGKey``, ``fold_in``, ``split``, ``randint``,
``bernoulli``) and the int8 calibration's draws (``uniform``, ``randint``,
``normal``), as JAX 0.9.0 computes them with
``jax_threefry_partitionable`` on (its default).

PyTorch has no full uint32 arithmetic, so words are held in ``int64`` and
masked to 32 bits after every add and shift. Draws run on the device of
the ray ids; key derivations are a few scalars and run on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11; the hash under
    ``jax.random``). Keys are Python ints or int64 tensors, counters int64
    tensors of 32-bit words, all broadcastable against the counters; returns the two output
    words as int64 tensors in ``[0, 2^32)``."""
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


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: the key
    words are ``(0, seed mod 2^32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two 32-bit words of a key as Python ints."""
    if key.shape != (2,):
        raise ValueError(f"a key is a [2] tensor of words, got "
                         f"{list(key.shape)}")
    k = key.tolist()
    return int(k[0]) & _M32, int(k[1]) & _M32


def _key(w0, w1) -> torch.Tensor:
    return torch.tensor([int(w0), int(w1)], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the seed words ``(0, data)``."""
    k0, k1 = key_words(key)
    o0, o1 = threefry2x32(k0, k1, torch.tensor(0),
                          torch.tensor(int(data) & _M32))
    return _key(o0, o1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): key ``i`` is the
    threefry pair of counter ``(0, i)``. Returns ``[num, 2]``."""
    k0, k1 = key_words(key)
    o0, o1 = threefry2x32(k0, k1, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...],
                device: str | torch.device = "cpu") -> torch.Tensor:
    """32-bit ``jax.random.bits`` (partitionable layout): the threefry
    pair of the flat index ``(hi, lo)``, xor-ed."""
    k0, k1 = key_words(key)
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError("at most 2^32 - 1 values per draw")
    idx = torch.arange(size, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return (o0 ^ o1).reshape(shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words → float32 uniforms in ``[0, 1)``: the top 23 bits into
    the mantissa of ``[1, 2)``, minus 1 (``jax.random.uniform``'s
    construction)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: tuple[int, ...],
            device: str | torch.device = "cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` over ``[minval, maxval)`` in float32: the unit
    floats as ``floats * (maxval - minval) + minval``, held at ``minval``
    from below, the bounds and their difference in float32. XLA fuses the
    multiply-add into one FMA (one rounding); the product and the sum are
    exact in float64, so forming them there and rounding once is that
    FMA."""
    floats = _bits_to_unit_float(random_bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
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
           device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2)·erfinv(u)`` of uniforms
    over ``[nextafter(-1, 0), 1)`` (bit for bit JAX's)."""
    return _SQRT2 * _erfinv(uniform(key, shape, device, _ABOVE_MINUS_ONE, 1.0))


def bernoulli(key: torch.Tensor, p: float = 0.5) -> bool:
    """``jax.random.bernoulli(key, p)`` for one scalar draw."""
    return bool(uniform(key, ()) < torch.tensor(p, dtype=torch.float32))


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.randint`` into int32 ``[minval, maxval)``: two 32-bit
    draws from ``split(key)`` combined modulo the span, with uint32
    wrap-around where JAX's arithmetic wraps."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
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
    are stable per ``(tag, n)``, not prefix-stable across ``n``."""
    k0, k1 = key_words(fold_in(key, tag))
    m = (n + 1) // 2
    ids = ray_ids.to(torch.int64) & _M32
    c0 = ids[:, None].expand(ids.shape[0], m)
    c1 = torch.arange(m, dtype=torch.int64, device=ids.device)[None, :]
    o0, o1 = threefry2x32(k0, k1, c0, c1.expand_as(c0))
    return torch.cat([o0, o1], dim=-1)[:, :n]


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
                               device: str | torch.device = "cpu"
                               ) -> torch.Tensor:
    """``n`` distinct indices in ``[0, m)`` (int64): a keyed 4-round
    Feistel permutation of ``[0, 2^bits)`` evaluated at ``0..n-1`` and made
    domain-exact by cycle walking, with the JAX package's static pass count.
    An element stays put once in range, so a pass only re-encrypts the
    elements still out of range and the walk stops when none are left —
    the same values as the JAX ``fori_loop``, which re-encrypts every
    out-of-range element on each of its passes."""
    if n > m:
        raise ValueError(f"cannot draw {n} distinct values from [0, {m})")
    base = torch.arange(n, dtype=torch.int64, device=device)
    if m <= 2:
        if m == 2 and bernoulli(key):
            return 1 - base
        return base
    total_bits = max(2, (m - 1).bit_length())
    total_bits += total_bits % 2
    hb = total_bits // 2
    mask = (1 << hb) - 1
    k0, k1 = key_words(key)

    def encrypt(x):
        left = (x >> hb) & mask
        right = x & mask
        for rnd in range(4):
            f, _ = threefry2x32(k0 ^ rnd, k1, right,
                                torch.full_like(right, rnd))
            left, right = right, (left ^ f) & mask
        return (left << hb) | right

    y = encrypt(base)
    p = m / float(1 << total_bits)
    passes = (0 if p >= 1.0
              else int(np.ceil(-40.0 * np.log(2.0) / np.log1p(-p))))
    for _ in range(passes):
        out = y >= m
        if not bool(out.any()):
            break
        y = torch.where(out, encrypt(y), y)
    return torch.where(y < m, y, base)


def permutation(key: torch.Tensor, n: int,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): JAX's ``_shuffle`` of
    ``arange(n)``, ``ceil(3·ln n / ln(2^32 - 1))`` rounds (1 up to n =
    1,625, 2 up to about 2.6 M, 3 beyond), each splitting the key, drawing
    one 32-bit word per element and sorting the elements by their words
    with a stable sort, so equal words keep their order as in
    ``lax.sort_key_val``. The words are compared as unsigned (they are held
    in int64). Runs on ``device``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        words = random_bits(sub, (n,), device)
        x = x[torch.sort(words, stable=True).indices]
    return x


def choice_without_replacement(key: torch.Tensor, n: int, m: int,
                               device: str | torch.device = "cpu"
                               ) -> torch.Tensor:
    """``jax.random.choice(key, m, (n,), replace=False)``: the first ``n``
    entries of ``permutation(key, m)`` (int64, on ``device``)."""
    if n > m:
        raise ValueError(f"cannot draw {n} distinct values from [0, {m})")
    return permutation(key, m, device)[:n]
