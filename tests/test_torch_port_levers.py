"""The JAX trainer's levers in the port, against the JAX package: the
parity pixel draw (``jax.random.choice(replace=False)``) bit for bit,
``rays_for_pixels_batched``, the distortion and occlusion regularizers,
``RenderConfig.return_weights``, the EMA update and the step-dependent
schedules.

Tolerances: integer draws bitwise; the float ops 1e-6 (both sides run the
same float32 arithmetic in a different summation order); the distortion
loss's O(S) prefix-sum form against the pairwise double sum 1e-6 relative;
renders as ``test_torch_port_render.py`` holds them (rgb/acc/weights 1e-4,
depth and t 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.ops.compositing import distortion_loss as jax_distortion
from cvnerf_tpu.ops.compositing import occlusion_loss as jax_occlusion
from cvnerf_tpu.ops.rays import rays_for_pixels_batched as jax_batched
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.render.renderer import render_rays as jax_render_rays
from cvnerf_tpu.train.loop import TrainConfig as JaxTrain
from cvnerf_tpu.train.loop import _sample_pixels as jax_sample_pixels
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import rng as trng
from cvnerf_torch.ops.compositing import distortion_loss, occlusion_loss
from cvnerf_torch.ops.rays import rays_for_pixels_batched
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.train.loop import TrainConfig, _sample_pixels, schedules
from cvnerf_torch.train.state import create_train_state, ema_update
from cvnerf_torch.utils.convert import params_from_jax
from cvnerf_torch.utils.tree import tree_leaves

SIZES = [1, 2, 1625, 1626, 40_000, 160_000]
DRAWS = [(m, n) for m in SIZES for n in (1, 1024) if n <= m]


def _rounds(m):
    return int(np.ceil(3 * np.log(max(1, m)) / np.log(2 ** 32 - 1)))


def test_round_counts_straddle_the_boundary():
    """1,625 takes one sort round and 1,626 two: the listed sizes cover
    both sides (and N = 1 none)."""
    assert [_rounds(m) for m in SIZES] == [0, 1, 1, 2, 2, 2]


@pytest.mark.parametrize("m,n", DRAWS, ids=[f"N{m}-n{n}" for m, n in DRAWS])
def test_parity_draw_is_jax_choice_bitwise(m, n):
    """``choice_without_replacement`` is ``jax.random.choice(key, N, (n,),
    replace=False)``, and ``permutation`` the whole of JAX's, bit for bit
    (at N = 160,000 about 3 pairs of equal sort words a round, which only a
    stable sort keeps in JAX's order)."""
    for seed in (0, 7):
        jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
        want = np.asarray(jax.random.choice(jk, m, (n,), replace=False))
        got = trng.choice_without_replacement(tk, n, m).numpy()
        np.testing.assert_array_equal(got, want)
    if n == 1:
        np.testing.assert_array_equal(
            trng.permutation(tk, m).numpy(),
            np.asarray(jax.random.permutation(jk, m)))


def test_the_largest_grid_has_ties_that_a_stable_sort_resolves():
    """At N = 160,000 a round's sort words collide; an unstable order of
    the tied elements would break the match above."""
    key = trng.split(trng.PRNGKey(0))[1]
    words = trng.random_bits(key, (160_000,))
    assert len(torch.unique(words)) < 160_000


@pytest.mark.parametrize("precrop", [False, True])
def test_parity_pixels_match_jax(precrop):
    """``_sample_pixels(pixel_sampling="parity")``, with and without the
    centre crop, gives the JAX step's pixels."""
    kw = dict(height=40, width=50, focal=40.0, near=2.0, far=6.0,
              n_rays=256, pixel_sampling="parity", precrop_frac=0.5)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    jy, jx = jax_sample_pixels(key, JaxTrain(**kw), precrop)
    ty, tx = _sample_pixels(trng.fold_in(trng.PRNGKey(3), 5),
                            TrainConfig(**kw), precrop,
                            torch.device("cpu"))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_rays_for_pixels_batched_matches_jax():
    rng = np.random.RandomState(0)
    px = rng.randint(0, 50, 300).astype(np.int32)
    py = rng.randint(0, 40, 300).astype(np.int32)
    c2w = rng.randn(300, 3, 4).astype(np.float32)
    jo, jd = jax_batched(jnp.asarray(px), jnp.asarray(py), 50, 40, 45.0,
                         jnp.asarray(c2w))
    to, td = rays_for_pixels_batched(torch.from_numpy(px),
                                     torch.from_numpy(py), 50, 40, 45.0,
                                     torch.from_numpy(c2w))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def _weights(n_rays=64, n=24, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.rand(n_rays, n).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * rng.uniform(1.0, 3.0, (n_rays, 1))
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, n)), -1).astype(np.float32)
    near = np.full(n_rays, 2.0, np.float32)
    far = np.full(n_rays, 6.0, np.float32)
    return w, t, near, far


def test_distortion_loss_matches_jax_and_the_pairwise_sum():
    w, t, near, far = _weights()
    got = distortion_loss(*map(torch.from_numpy, (w, t, near, far))).numpy()
    want = np.asarray(jax_distortion(*map(jnp.asarray, (w, t, near, far))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    s = (t.astype(np.float64) - 2.0) / 4.0
    w64 = w.astype(np.float64)
    pair = np.einsum("ri,rj,rij->r", w64, w64,
                     np.abs(s[:, :, None] - s[:, None, :]))
    brute = pair + np.sum(w64[:, :-1] ** 2 * np.diff(s, axis=-1), -1) / 3
    np.testing.assert_allclose(got, brute, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_occlusion_loss_matches_jax(frac):
    w, t, near, far = _weights(seed=1)
    got = occlusion_loss(*map(torch.from_numpy, (w, t, near, far)), frac)
    want = jax_occlusion(*map(jnp.asarray, (w, t, near, far)), frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.sum() > 0


def test_regularizers_are_differentiable_in_the_weights():
    w, t, near, far = map(torch.from_numpy, _weights(seed=2))
    w.requires_grad_()
    (distortion_loss(w, t, near, far).sum()
     + occlusion_loss(w, t, near, far, 0.2).sum()).backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)


def test_return_weights_matches_jax_and_stays_off_by_default():
    from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
    from cvnerf_tpu.train.state import create_train_state as jax_create
    p = jax.tree.map(np.asarray, jax_create(jax.random.PRNGKey(1),
                                            mlp=JaxCfg(**TINY)).params)
    rng = np.random.RandomState(0)
    o = (rng.randn(16, 3) * 0.2 + [0, 0, 4]).astype(np.float32)
    d = (rng.randn(16, 3) * 0.2 + [0, 0, -1]).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full(16, 2.0, np.float32), np.full(16, 6.0, np.float32)
    kw = dict(n_coarse=8, n_fine=8, perturb=True, white_bkg=True)
    want = jax.jit(jax_render_rays, static_argnames=("cfg",))(
        jax.random.PRNGKey(2), p, *map(jnp.asarray, (o, d, v, near, far)),
        cfg=JaxRender(mlp=JaxCfg(**TINY), pallas="off", return_weights=True,
                      **kw))
    cfg = RenderConfig(mlp=NerfMLPConfig(**TINY), return_weights=True, **kw)
    args = (params_from_jax(p), *map(torch.from_numpy, (o, d, v, near, far)))
    got = render_rays(*args, cfg, key=trng.PRNGKey(2))
    assert got["weights"].shape == got["t"].shape == (16, 16)
    np.testing.assert_allclose(got["weights"].detach().numpy(),
                               np.asarray(want["weights"]), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               atol=1e-3)
    plain = render_rays(*args, dataclasses.replace(cfg, return_weights=False),
                        key=trng.PRNGKey(2))
    assert sorted(plain) == ["acc", "depth", "rgb", "rgb_coarse"]


def test_ema_update_is_the_jax_order_of_operations():
    """``e·d + p·(1 - d)`` with ``d`` and ``1 - d`` in float32, leaf for
    leaf, as the JAX step's tree map computes it."""
    st = create_train_state(trng.PRNGKey(0),
                            mlp=NerfMLPConfig(**TINY), device="cpu", ema=True)
    new = {k: {n: {q: t + 0.01 for q, t in lay.items()}
               for n, lay in net.items()} for k, net in st.params.items()}
    got = ema_update(st.ema_params, new, 0.999)
    d = jnp.float32(0.999)
    for g, e, p in zip(tree_leaves(got), tree_leaves(st.ema_params),
                       tree_leaves(new)):
        want = jnp.asarray(e.numpy()) * d + jnp.asarray(p.numpy()) * (1.0 - d)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)
    # The fresh slot is a copy of the params, sharing no storage.
    for a, b in zip(tree_leaves(st.ema_params), tree_leaves(st.params)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("step", [0, 1, 37, 99, 100, 250])
def test_schedules_are_the_jax_float32_values(step):
    cfg = TrainConfig(height=8, width=8, focal=10.0, near=2.0, far=6.0,
                      noise_decay=100, freq_anneal=77, distortion_start=20,
                      distortion_ramp=60)
    s = jnp.int32(step).astype(jnp.float32)
    want = (jnp.clip(1.0 - s / 100, 0.0, 1.0), jnp.clip(s / 77, 0.0, 1.0),
            jnp.clip((s - 20) / max(60, 1), 0.0, 1.0))
    assert schedules(cfg, step) == tuple(float(x) for x in want)
