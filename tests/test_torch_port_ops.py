"""The port's encoding, MLP and ray ops against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the port
runs on the CPU. fp32 tolerances are 1e-4 where only the summation order
differs (encoding, MLP) and 1e-5/1e-6 where the arithmetic is elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models import nerf_mlp as jmlp
from cvnerf_tpu.ops import compositing as jcomp
from cvnerf_tpu.ops import encoding as jenc
from cvnerf_tpu.ops import rays as jrays
from cvnerf_tpu.ops import rng as jrng
from cvnerf_tpu.ops import sampling as jsamp
from cvnerf_torch.models import nerf_mlp as tmlp
from cvnerf_torch.ops import compositing as tcomp
from cvnerf_torch.ops import encoding as tenc
from cvnerf_torch.ops import rays as trays
from cvnerf_torch.ops import rng as trng
from cvnerf_torch.ops import sampling as tsamp
from cvnerf_torch.utils.convert import params_from_jax


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_freq_encode_matches_jax(n_freqs):
    x = np.random.RandomState(0).randn(50, 3).astype(np.float32) * 3
    assert tenc.encoding_dim(3, n_freqs) == jenc.encoding_dim(3, n_freqs)
    _close(tenc.freq_encode(_t(x), n_freqs),
           jenc.freq_encode(jnp.asarray(x), n_freqs), 1e-4)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg))


def _mlp_inputs(n, cfg, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32) * 2
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xe = jenc.freq_encode(jnp.asarray(pts), cfg.xyz_freqs)
    de = jenc.freq_encode(jnp.asarray(dirs), cfg.dir_freqs)
    return pts, dirs, xe, de


def test_apply_nerf_full_width_fp32_matches_jax():
    jcfg, tcfg = jmlp.NerfMLPConfig(), tmlp.NerfMLPConfig()
    assert (tcfg.xyz_dim, tcfg.dir_dim) == (jcfg.xyz_dim, jcfg.dir_dim)
    assert tmlp._layer_dims(tcfg) == jmlp._layer_dims(jcfg)
    jp = _jax_params(jcfg)
    pts, dirs, xe, de = _mlp_inputs(64, jcfg)
    want = jmlp.apply_nerf(jp, xe, de, jcfg)
    got = tmlp.apply_nerf(params_from_jax(jp),
                          tenc.freq_encode(_t(pts), 10),
                          tenc.freq_encode(_t(dirs), 4), tcfg)
    assert got.shape == (64, 4) and got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_apply_nerf_bf16_matches_jax_bf16():
    """Both round the operands to bf16 and accumulate in fp32; only the
    summation order differs, which can flip one activation's bf16
    rounding (2^-8 relative) — hence 2e-2 max-abs."""
    jcfg = jmlp.NerfMLPConfig(xyz_freqs=4, dir_freqs=2, trunk_width=64,
                              head_width=32)
    tcfg = tmlp.NerfMLPConfig(4, 2, 64, 32)
    jp = _jax_params(jcfg)
    pts, dirs, xe, de = _mlp_inputs(200, jcfg)
    want = np.asarray(jmlp.apply_nerf(jp, xe, de, jcfg,
                                      compute_dtype=jnp.bfloat16))
    got = tmlp.apply_nerf(params_from_jax(jp), _t(xe), _t(de), tcfg,
                          compute_dtype=torch.bfloat16).numpy()
    assert np.abs(got - want).max() < 2e-2


def test_init_nerf_params_shapes_and_bounds():
    cfg = tmlp.NerfMLPConfig()
    p = tmlp.init_nerf_params(trng.PRNGKey(0), cfg)
    jp = _jax_params(jmlp.NerfMLPConfig())
    for name, fan_in, fan_out in tmlp._layer_dims(cfg):
        assert p[name]["w"].shape == jp[name]["w"].shape == (fan_in, fan_out)
        assert p[name]["b"].shape == (fan_out,)
        assert p[name]["w"].abs().max() <= fan_in ** -0.5
    again = tmlp.init_nerf_params(trng.PRNGKey(0), cfg)
    assert torch.equal(p["l6"]["w"], again["l6"]["w"])


@pytest.mark.parametrize("progress", [0.0, 0.35, 1.0])
def test_anneal_matches_jax(progress):
    jcfg = jmlp.NerfMLPConfig(xyz_freqs=4, dir_freqs=2, trunk_width=32,
                              head_width=16)
    jp = _jax_params(jcfg)
    want = jax.tree.map(np.asarray,
                        jmlp.anneal_nerf_params(jp, jcfg, progress))
    got = tmlp.anneal_nerf_params(params_from_jax(jp),
                                  tmlp.NerfMLPConfig(4, 2, 32, 16), progress)
    for name in want:
        _close(got[name]["w"], want[name]["w"], 1e-6)
        _close(got[name]["b"], want[name]["b"], 1e-6)


def _pose():
    return np.array([[0.96, -0.1, 0.26, 0.4], [0.2, 0.9, -0.39, -1.1],
                     [-0.19, 0.42, 0.89, 3.7]], np.float32)


def test_ray_grid_matches_jax():
    c2w = _pose()
    jo, jd = jrays.ray_grid(5, 7, 6.5, jnp.asarray(c2w))
    to, td = trays.ray_grid(5, 7, 6.5, _t(c2w))
    assert to.shape == td.shape == (5, 7, 3)
    _close(to, jo, 1e-6)
    _close(td, jd, 1e-6)


@pytest.mark.parametrize("variant", ["canonical", "reference"])
def test_ndc_rays_matches_jax(variant):
    rng = np.random.RandomState(2)
    o = rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32)
    o[:, 2] += 0.5
    d = rng.randn(40, 3).astype(np.float32) * 0.3
    d[:, 2] = -1.0
    jo, jd = jrays.ndc_rays(30, 40, 35.0, 1.0, jnp.asarray(o), jnp.asarray(d),
                            variant=variant)
    to, td = trays.ndc_rays(30, 40, 35.0, 1.0, _t(o), _t(d), variant=variant)
    _close(to, jo, 1e-5)
    _close(td, jd, 1e-5)
    with pytest.raises(ValueError):
        trays.ndc_rays(30, 40, 35.0, 1.0, _t(o), _t(d), variant="nope")


@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_samples_matches_jax(perturb):
    rng = np.random.RandomState(3)
    near = rng.uniform(1, 2, 9).astype(np.float32)
    far = near + rng.uniform(1, 4, 9).astype(np.float32)
    u = rng.uniform(size=(9, 16)).astype(np.float32) if perturb else None
    want = jsamp.stratified_samples(None, jnp.asarray(near), jnp.asarray(far),
                                    16, 9, perturb,
                                    u=None if u is None else jnp.asarray(u))
    got = tsamp.stratified_samples(_t(near), _t(far), 16, 9, perturb,
                                   u=None if u is None else _t(u))
    _close(got, want, 1e-6)
    # scalar bounds broadcast too
    _close(tsamp.stratified_samples(2.0, 6.0, 8, 3, False),
           jsamp.stratified_samples(None, 2.0, 6.0, 8, 3, False), 1e-6)


def test_merge_sorted_matches_jax():
    rng = np.random.RandomState(4)
    a = np.sort(rng.uniform(size=(6, 64)), -1).astype(np.float32)
    b = np.sort(rng.uniform(size=(6, 128)), -1).astype(np.float32)
    b[:, :5] = a[:, 10:15]          # ties between the two inputs
    b = np.sort(b, -1)
    want = jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(tsamp.merge_sorted(_t(a), _t(b)).numpy(),
                                  np.asarray(want))


def _pdf_inputs(seed=5, n=7, nb=20, degenerate=True):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(2, 6, (n, nb + 1)), -1).astype(np.float32)
    w = rng.uniform(size=(n, nb)).astype(np.float32)
    w[0] = 0.0                      # an all-empty ray: eps-uniform pdf
    if degenerate:
        w[1, 5:] = 0.0              # zero bins: degenerate-bin guard
    return bins, w


def test_sample_pdf_deterministic_matches_jax():
    """The deterministic u = linspace(0, 1) ends at u = 1, which meets
    cdf[-1] ≈ 1 from either side depending on each framework's cumsum
    rounding. Without a run of near-empty bins at the end, both brackets
    land within rounding of bins[-1]; with one (a degenerate tail), they
    can land one bin apart — why the renders' depth has the looser 1e-3."""
    bins, w = _pdf_inputs(degenerate=False)
    want = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 33,
                            deterministic=True)
    got = tsamp.sample_pdf(_t(bins), _t(w), 33, deterministic=True)
    assert got.shape == (7, 33)
    _close(got, want, 1e-5)


def test_sample_pdf_given_u_matches_jax():
    bins, w = _pdf_inputs(seed=6)
    u = np.random.RandomState(7).uniform(size=(7, 25)).astype(np.float32)
    u[:, 0] = 0.0
    want = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 25,
                            u=jnp.asarray(u))
    _close(tsamp.sample_pdf(_t(bins), _t(w), 25, u=_t(u)), want, 1e-5)


def test_sample_pdf_u_past_every_cdf_clamps_to_last_bin():
    """u >= every cdf (u = 1 meets cdf[-1] ≈ 1 from either side of the
    rounding) is clamped to the last bin, as in the JAX package."""
    bins, w = _pdf_inputs(seed=8)
    u = np.full((7, 4), 1.0001, np.float32)   # past cdf[-1]'s rounding
    u[:, 1] = 1.5
    u[2:, 2] = 1.0                            # rays without a degenerate tail
    u[:2, 2] = 0.5
    want = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins),
                                       jnp.asarray(w), 4, u=jnp.asarray(u)))
    got = tsamp.sample_pdf(_t(bins), _t(w), 4, u=_t(u)).numpy()
    _close(got, want, 1e-5)
    assert np.isfinite(got).all()
    with pytest.raises(ValueError, match="one wider"):
        tsamp.sample_pdf(_t(bins[:, :-1]), _t(w), 4, u=_t(u))


@pytest.mark.parametrize("white_bkg", [False, True])
def test_volume_render_matches_jax(white_bkg):
    rng = np.random.RandomState(9)
    raw = rng.randn(11, 24, 4).astype(np.float32) * 3
    t = np.sort(rng.uniform(2, 6, (11, 24)), -1).astype(np.float32)
    d = rng.randn(11, 3).astype(np.float32)
    want = jcomp.volume_render(jnp.asarray(raw), jnp.asarray(t),
                               jnp.asarray(d), white_bkg=white_bkg)
    got = tcomp.volume_render(_t(raw), _t(t), _t(d), white_bkg=white_bkg)
    for k in ("rgb", "weights", "acc", "depth"):
        _close(got[k], want[k], 1e-5)
    noise = rng.randn(11, 24).astype(np.float32)
    want = jcomp.volume_render(jnp.asarray(raw), jnp.asarray(t),
                               jnp.asarray(d), noise_std=0.5,
                               white_bkg=white_bkg, noise=jnp.asarray(noise))
    got = tcomp.volume_render(_t(raw), _t(t), _t(d), noise_std=0.5,
                              white_bkg=white_bkg, noise=_t(noise))
    _close(got["rgb"], want["rgb"], 1e-5)


def test_random_draws_come_from_the_rng_and_match_jax():
    """The renderer's draws (port ``ops.rng``, bitwise the JAX stream) fed
    to the stratified jitter, the stochastic resample and the density
    noise give the JAX results (1e-5: the ops' own arithmetic); an op that
    needs a draw it was not given raises."""
    ids = np.arange(7, dtype=np.int32) + 100
    jk = jax.random.PRNGKey(3)
    tk = trng.PRNGKey(3)
    u_j = jrng.ray_uniform(jk, 1, jnp.asarray(ids), 16)
    u_t = trng.ray_uniform(tk, 1, torch.from_numpy(ids), 16)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    _close(tsamp.stratified_samples(2.0, 6.0, 16, 7, True, u=u_t),
           jsamp.stratified_samples(None, 2.0, 6.0, 16, 7, True, u=u_j), 1e-6)
    bins, w = _pdf_inputs(seed=10)
    v_j = jrng.ray_sorted_uniform(jk, 2, jnp.asarray(ids), 25)
    v_t = trng.ray_sorted_uniform(tk, 2, torch.from_numpy(ids), 25)
    want = jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 25,
                            u=v_j)
    _close(tsamp.sample_pdf(_t(bins), _t(w), 25, u=v_t), want, 1e-5)
    raw = np.random.RandomState(11).randn(7, 16, 4).astype(np.float32)
    t = np.sort(np.random.RandomState(12).uniform(2, 6, (7, 16)),
                -1).astype(np.float32)
    d = np.ones((7, 3), np.float32)
    want = jcomp.volume_render(jnp.asarray(raw), jnp.asarray(t),
                               jnp.asarray(d), noise_std=1.0,
                               noise=jrng.ray_normal(jk, 3, jnp.asarray(ids),
                                                     16))
    got = tcomp.volume_render(_t(raw), _t(t), _t(d), noise_std=1.0,
                              noise=trng.ray_normal(tk, 3,
                                                    torch.from_numpy(ids), 16))
    _close(got["rgb"], want["rgb"], 1e-5)
    with pytest.raises(ValueError, match="uniforms u"):
        tsamp.sample_pdf(_t(bins), _t(w), 4)
    with pytest.raises(ValueError, match="uniforms u"):
        tsamp.stratified_samples(2.0, 6.0, 8, 3, True)
    with pytest.raises(ValueError, match="normals"):
        tcomp.volume_render(torch.zeros(2, 4, 4), torch.ones(2, 4),
                            torch.ones(2, 3), noise_std=1.0)


@pytest.mark.parametrize("white_bkg", [False, True])
def test_volume_render_autograd_matches_jax_grad(white_bkg):
    """d(sum of rgb, acc and depth)/d(raw) through the port's
    ``volume_render`` (torch autograd) equals ``jax.grad`` of the JAX one
    (1e-5)."""
    rng = np.random.RandomState(13)
    raw = rng.randn(5, 12, 4).astype(np.float32) * 2
    t = np.sort(rng.uniform(2, 6, (5, 12)), -1).astype(np.float32)
    d = rng.randn(5, 3).astype(np.float32)
    noise = rng.randn(5, 12).astype(np.float32)

    def j_loss(r):
        out = jcomp.volume_render(r, jnp.asarray(t), jnp.asarray(d),
                                  noise_std=0.5, white_bkg=white_bkg,
                                  noise=jnp.asarray(noise))
        return out["rgb"].sum() + out["acc"].sum() + 0.1 * out["depth"].sum()

    want = jax.grad(j_loss)(jnp.asarray(raw))
    r = _t(raw).requires_grad_()
    out = tcomp.volume_render(r, _t(t), _t(d), noise_std=0.5,
                              white_bkg=white_bkg, noise=_t(noise))
    (out["rgb"].sum() + out["acc"].sum() + 0.1 * out["depth"].sum()).backward()
    _close(r.grad, want, 1e-5)
