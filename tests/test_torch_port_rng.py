"""The port's RNG (``cvnerf_torch/ops/rng.py``) against JAX 0.9.0 and the
JAX package's ``ops/rng.py``.

Key derivations, raw words and uniforms are compared **bitwise** (the same
integer arithmetic); ``ray_sorted_uniform`` (log1p, cumsum, divide) at 2e-7
absolute and ``ray_normal`` (erfinv) at 1e-5 absolute plus 1e-5 relative
(its tails, where erfinv is steep), since the two frameworks'
transcendentals and summation orders round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.ops import rng as jrng
from cvnerf_torch.ops import rng as trng

SEEDS = [0, 3, 12345, 2 ** 31 - 1, -7]


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivations_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for data in (0, 1, 5, 2 ** 31 + 9):
        np.testing.assert_array_equal(trng.fold_in(tk, data).numpy(),
                                      _u32(jax.random.fold_in(jk, data)))
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(trng.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    for shape in ((), (1,), (5,), (3, 4)):
        np.testing.assert_array_equal(trng.random_bits(tk, shape).numpy(),
                                      _u32(jax.random.bits(jk, shape)))
    assert trng.bernoulli(tk) == bool(jax.random.bernoulli(jk))


@pytest.mark.parametrize("shape,lo,hi", [((), 0, 2), ((), 0, 7),
                                         ((9,), 0, 160000), ((3, 5), -4, 1000),
                                         ((6,), 0, 2 ** 31 - 1), ((4,), 3, 3)])
def test_randint_bitwise(shape, lo, hi):
    for seed in SEEDS[::2]:
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        got = trng.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(jk, shape, lo, hi)))


def test_threefry_bitwise():
    rng = np.random.RandomState(0)
    k = rng.randint(0, 2 ** 32, size=(2, 33), dtype=np.uint64)
    c = rng.randint(0, 2 ** 32, size=(2, 33), dtype=np.uint64)
    want = jrng.threefry2x32(*(jnp.asarray(x.astype(np.uint32))
                               for x in (k[0], k[1], c[0], c[1])))
    got = trng.threefry2x32(*(torch.from_numpy(x.astype(np.int64))
                              for x in (k[0], k[1], c[0], c[1])))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _u32(b))


@pytest.mark.parametrize("tag,n", [(1, 64), (2, 129), (3, 1), (4, 7)])
def test_ray_bits_and_uniforms_bitwise(tag, n):
    ids = np.array([0, 1, 5, 1023, 70000, 2 ** 31 - 1], np.int32)
    for seed in SEEDS[:3]:
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        tid = torch.from_numpy(ids.astype(np.int64))
        np.testing.assert_array_equal(
            trng._ray_bits(tk, tag, tid, n).numpy(),
            _u32(jrng._ray_bits(jk, tag, jnp.asarray(ids), n)))
        np.testing.assert_array_equal(
            trng.ray_uniform(tk, tag, tid, n).numpy(),
            np.asarray(jrng.ray_uniform(jk, tag, jnp.asarray(ids), n)))
        np.testing.assert_array_equal(
            trng.uniform(tk, (3, n)).numpy(),
            np.asarray(jax.random.uniform(jk, (3, n))))


@pytest.mark.parametrize("tag,n", [(2, 128), (2, 9), (4, 192)])
def test_sorted_uniform_and_normal_close(tag, n):
    ids = np.arange(50, dtype=np.int32) * 7
    jk, tk = jax.random.PRNGKey(11), trng.PRNGKey(11)
    tid = torch.from_numpy(ids.astype(np.int64))
    s = trng.ray_sorted_uniform(tk, tag, tid, n)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jrng.ray_sorted_uniform(jk, tag,
                                                      jnp.asarray(ids), n)),
        rtol=0, atol=2e-7)
    assert (s.diff(dim=-1) >= 0).all() and (s < 1).all()
    np.testing.assert_allclose(
        trng.ray_normal(tk, tag, tid, n).numpy(),
        np.asarray(jrng.ray_normal(jk, tag, jnp.asarray(ids), n)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(1, 1), (1, 2), (2, 2), (256, 256),
                                 (100, 257), (1024, 160000)])
def test_sample_without_replacement_bitwise(n, m):
    """Powers of two (no cycle walk), just above one (the longest walk),
    m <= 2 (the bernoulli branch) and the lego shapes."""
    for seed in SEEDS[:3]:
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        got = trng.sample_without_replacement(tk, n, m)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jrng.sample_without_replacement(jk, n, m)))
        assert len(set(got.tolist())) == n and 0 <= got.min() <= got.max() < m
    with pytest.raises(ValueError, match="distinct"):
        trng.sample_without_replacement(trng.PRNGKey(0), 5, 4)


@pytest.mark.parametrize("lo,hi", [(-0.1259881556, 0.1259881556),
                                   (2.0, 6.0), (-3.5, 0.25)])
def test_uniform_with_bounds_bitwise(lo, hi):
    """``jax.random.uniform(key, shape, minval=, maxval=)``, whose
    multiply-add XLA fuses into one FMA, bit for bit."""
    for seed in SEEDS[:3]:
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        lo32, hi32 = np.float32(lo), np.float32(hi)
        np.testing.assert_array_equal(
            trng.uniform(tk, (17, 33), "cpu", float(lo32), float(hi32))
            .numpy(),
            np.asarray(jax.random.uniform(jk, (17, 33), jnp.float32,
                                          lo32, hi32)))
