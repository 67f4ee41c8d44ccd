"""The port's draw kernels (``cvnerf_torch/ops/threefry.py``: the threefry
counter grid and the Feistel draw) and the device-keyed ``ops/rng.py``
draws built on them, against JAX 0.9.0 and the JAX package's
``ops/rng.py``.

Every comparison is **bitwise**: the draws are integer arithmetic. On the
CPU the keys lie on the CPU and the wrappers run their plain versions; the
tests marked ``cuda`` hold the kernels against those plain versions (and
JAX's words) with the keys on the card, and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.ops import rng as jrng
from cvnerf_torch.ops import rng as trng
from cvnerf_torch.ops import threefry as tf

SEEDS = [0, 3, 2 ** 31 - 1]


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Elementwise chains of small tensors: one torch thread is as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_reads_its_step_from_a_tensor(seed):
    """``fold_in(key, data)`` with ``data`` a one-value int64 tensor (a
    captured block's step index) is the Python-int fold and JAX's."""
    jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
    for data in (0, 1, 12, 2 ** 31 + 9, 2 ** 32 - 1):
        want = _u32(jax.random.fold_in(jk, data))
        np.testing.assert_array_equal(trng.fold_in(tk, data).numpy(), want)
        np.testing.assert_array_equal(
            trng.fold_in(tk, torch.tensor([data], dtype=torch.int64))
            .numpy(), want)


@pytest.mark.parametrize("layout", ["pair", "xor", "split"])
def test_threefry_bits_layouts_are_jax_threefry(layout):
    """The counter grid ``(c0[r], c1 + j)`` in each output layout, against
    the JAX package's ``threefry2x32`` of the same counters."""
    rng = np.random.RandomState(1)
    rows, cols = 5, 7
    k = rng.randint(0, 2 ** 32, size=2, dtype=np.uint64)
    c0 = rng.randint(0, 2 ** 32, size=rows, dtype=np.uint64)
    c1 = 4_000_000_000
    cc0 = np.repeat(c0, cols)
    cc1 = (c1 + np.tile(np.arange(cols, dtype=np.uint64), rows)) % 2 ** 32
    o0, o1 = (_u32(x).reshape(rows, cols) for x in jrng.threefry2x32(
        *(jnp.asarray(x.astype(np.uint32)) for x in (k[0], k[1], cc0, cc1))))
    key = torch.from_numpy(k.astype(np.int64))
    width = 2 * cols - 1
    got = tf.threefry_bits(key, rows, cols,
                           c0=torch.from_numpy(c0.astype(np.int64)), c1=c1,
                           layout=layout, width=width)
    want = {"pair": np.stack([o0, o1], -1), "xor": o0 ^ o1,
            "split": np.concatenate([o0, o1], -1)[:, :width]}[layout]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="split width"):
        tf.threefry_bits(key, rows, cols, layout="split", width=2 * cols + 1)
    with pytest.raises(ValueError, match=r"\[2\] int64"):
        tf.threefry_bits(key.to(torch.int32), rows, cols)


# The Feistel draw's domains: powers of two (no cycle walk), one above and
# below (the longest walks), the lego pixel grids (200x200, 400x400,
# 800x800) and the ray-batching pool of 8 views of 800x800.
DRAWS = [(1024, 1024), (1023, 1023), (1025, 1025), (1024, 2 ** 20),
         (1024, 2 ** 20 + 1), (1024, 2 ** 20 - 1), (1024, 40_000),
         (4096, 160_000), (1024, 640_000), (1024, 8 * 800 * 800)]


@pytest.mark.parametrize("n,m", DRAWS)
def test_feistel_draw_is_jax_sample_without_replacement(n, m):
    for seed in SEEDS[:2]:
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        got = trng.sample_without_replacement(tk, n, m)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jrng.sample_without_replacement(jk, n, m)))
        assert got.unique().numel() == n and 0 <= int(got.min()) \
            and int(got.max()) < m


def test_feistel_plan_is_the_static_pass_bound():
    """The pass count leaves an element out of range with probability at
    most 2^-40 and one pass fewer would not; powers of two need no walk."""
    for m in (3, 5, 257, 1025, 40_000, 160_000, 640_000, 8 * 800 * 800):
        hb, passes = tf.feistel_plan(m)
        p = m / float(1 << (2 * hb))
        assert 2 * hb >= (m - 1).bit_length() and 0.25 < p < 1.0
        assert (1 - p) ** passes <= 2.0 ** -40 * (1 + 1e-12)
        assert 2.0 ** -40 < (1 - p) ** (passes - 1)
    for m in (4, 16, 1024, 2 ** 20):
        assert tf.feistel_plan(m)[1] == 0
    with pytest.raises(ValueError, match="2 < m < 2"):
        tf.feistel_draw(trng.PRNGKey(0), 2, 2)


def test_bernoulli_is_a_device_tensor():
    """``bernoulli`` returns a 0-d bool tensor on the key's device (no host
    bool); the ``m == 2`` draw selects with it through ``torch.where``."""
    for seed in range(6):
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        b = trng.bernoulli(tk)
        assert b.dtype == torch.bool and b.shape == ()
        assert b.device == tk.device
        np.testing.assert_array_equal(b.numpy(),
                                      np.asarray(jax.random.bernoulli(jk)))
        for n in (1, 2):
            np.testing.assert_array_equal(
                trng.sample_without_replacement(tk, n, 2).numpy(),
                np.asarray(jrng.sample_without_replacement(jk, n, 2)))


def test_plain_versions_run_for_keys_on_the_cpu():
    """A CPU key runs the plain versions (counted as calls), never the
    kernels; ``key_on`` leaves a key where it already lies."""
    key = trng.PRNGKey(5)
    assert trng.key_on(key, "cpu") is key and trng.key_on(key) is key
    launches = (tf.threefry_bits.launches, tf.feistel_draw.launches)
    calls = (tf.threefry_bits_plain.calls, tf.feistel_draw_plain.calls)
    trng.split(key, 3)
    trng.sample_without_replacement(key, 10, 1000)
    assert (tf.threefry_bits.launches, tf.feistel_draw.launches) == launches
    assert tf.threefry_bits_plain.calls == calls[0] + 1
    assert tf.feistel_draw_plain.calls == calls[1] + 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_card(cuda_device):
    """Keys on the card: the key derivations, raw bits, randint, the ray
    streams (the lego step's shapes) and the Feistel draws launch the
    kernels and equal the plain versions on the same card and JAX's words,
    bitwise, over two launches."""
    ids = torch.arange(1024, dtype=torch.int64, device=cuda_device)
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        tk = trng.PRNGKey(seed).to(cuda_device)
        before = tf.threefry_bits.launches
        np.testing.assert_array_equal(trng.fold_in(tk, 7).cpu().numpy(),
                                      _u32(jax.random.fold_in(jk, 7)))
        np.testing.assert_array_equal(trng.split(tk, 3).cpu().numpy(),
                                      _u32(jax.random.split(jk, 3)))
        np.testing.assert_array_equal(
            trng.random_bits(tk, (3, 5)).cpu().numpy(),
            _u32(jax.random.bits(jk, (3, 5))))
        np.testing.assert_array_equal(
            trng.randint(tk, (9,), 0, 160_000).cpu().numpy(),
            np.asarray(jax.random.randint(jk, (9,), 0, 160_000)))
        assert tf.threefry_bits.launches == before + 6
        for tag, n in ((1, 64), (2, 129), (4, 192)):
            got = trng._ray_bits(tk, tag, ids, n)
            again = trng._ray_bits(tk, tag, ids, n)
            want = tf.threefry_bits_plain(trng.fold_in(tk, tag), 1024,
                                          (n + 1) // 2, c0=ids,
                                          layout="split", width=n)
            assert torch.equal(got, again) and torch.equal(got, want)
        for n, m in DRAWS:
            got = tf.feistel_draw(tk, n, m)
            assert torch.equal(got, tf.feistel_draw(tk, n, m))
            assert torch.equal(got, tf.feistel_draw_plain(tk, n, m))
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                np.asarray(jrng.sample_without_replacement(jk, n, m)))
