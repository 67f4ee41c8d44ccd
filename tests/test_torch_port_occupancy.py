"""The port's occupancy grids (``cvnerf_torch/render/occupancy.py``) and
the renderer's occupancy modes against the JAX package.

The same numpy-seeded nets (``params_from_jax``), points and rays go
through JAX ``render/occupancy.py`` / ``render_rays(occupancy=)`` and the
port on the CPU. A grid baked by JAX is handed to the port as it is, so the
render tests compare the renderers alone. Tolerances: the bake 1e-5 (the
same lattice, bitwise; the MLP's fp32 sums differ in order); the nearest
probe bitwise, the trilinear one 1e-6; the ray bounds exactly, apart from rays whose probe
transmittance lies within a few ulps of ``eps`` (counted, none here);
renders 1e-5 on rgb/acc and 1e-3 on depth where the resample's
deterministic ``u = 1`` meets ``cdf[-1] ≈ 1`` (``test_torch_port_render``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.render import occupancy as jocc
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.render.renderer import render_rays as jax_render_rays
from cvnerf_tpu.render.renderer import \
    render_rays_chunked as jax_render_rays_chunked
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render import occupancy as occ
from cvnerf_torch.render.renderer import (RenderConfig, render_rays,
                                          render_rays_chunked)
from cvnerf_torch.utils.convert import params_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)


def _params(seed=11, alpha_bias=-0.1):
    cfg = JaxCfg(**TINY)
    p = {"coarse": jax_init(jax.random.PRNGKey(seed), cfg),
         "fine": jax_init(jax.random.PRNGKey(seed + 1), cfg)}
    for net in p.values():   # density of both signs: a grid with structure
        net["alpha"]["b"] = net["alpha"]["b"] + alpha_bias
    return jax.tree.map(np.asarray, p)


def _sphere_grid(res=12):
    """A JAX grid holding a dense ball (sigma 40) in empty space: rays
    meet empty space, then the surface, then saturate."""
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.where(x * x + y * y + z * z < 0.36, 40.0, 0.0).astype(
        np.float32)
    return jocc.OccupancyGrid(values=jnp.asarray(vals),
                              bbox_min=jnp.full((3,), -1.0, jnp.float32),
                              inv_spacing=jnp.full((3,), (res - 1) / 2.0,
                                                   jnp.float32))


def grid_from_jax(g) -> occ.OccupancyGrid:
    return occ.OccupancyGrid(
        values=torch.from_numpy(np.array(g.values)),
        bbox_min=torch.from_numpy(np.array(g.bbox_min)),
        inv_spacing=torch.from_numpy(np.array(g.inv_spacing)))


@pytest.mark.parametrize("res,dilate,mode", [
    (9, 0, "off"), (9, 1, "off"), (7, 1, "interpret"), ((5, 6, 7), 1, "off"),
    (8, 2, "off"), (7, 0, "interpret")])
def test_bake_matches_jax(res, dilate, mode):
    """The port's bake, through the kernel's plain version (``kernels="on"``
    on CPU tensors) and through ``apply_nerf`` (``"off"``), against the
    JAX bake (the jnp oracle, or the Pallas kernel in the interpreter);
    a chunk that splits the lattice unevenly."""
    p = _params()
    lo, hi = (-1.2, -1.0, -0.8), (1.0, 1.1, 0.9)
    want = jocc.bake_occupancy(p["fine"], JaxCfg(**TINY), lo, hi,
                               resolution=res, dilate=dilate, chunk=64,
                               pallas=mode)
    tp = params_from_jax(p)["fine"]
    for kernels in ("on", "off"):
        calls = fm.fused_nerf_plain.calls
        got = occ.bake_occupancy(tp, NerfMLPConfig(**TINY), lo, hi,
                                 resolution=res, dilate=dilate, chunk=100,
                                 kernels=kernels)
        n = int(np.prod(np.broadcast_to(res, (3,))))
        assert fm.fused_nerf_plain.calls - calls == (
            -(-n // 100) if kernels == "on" else 0)
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.bbox_min.numpy(),
                                      np.asarray(want.bbox_min))
        np.testing.assert_array_equal(got.inv_spacing.numpy(),
                                      np.asarray(want.inv_spacing))
    assert (got.values > 0).any() and (dilate or (got.values == 0).any())


@pytest.mark.parametrize("res", [2, 9, 192, (3, 77, 256)])
def test_lattice_is_np_linspace_bitwise(res):
    """The device lattice equals ``np.linspace(lo, hi, res)`` per axis in
    ``ij`` order, bit for bit (the mesh extractor's host lattice), over a
    window that crosses rows."""
    r, lo, hi = occ.grid_spec((-1.5, -0.3, 0.0), (1.5, 2.1, 1.0), res)
    axes = [np.linspace(lo[a], hi[a], r[a], dtype=np.float32)
            for a in range(3)]
    n = r[0] * r[1] * r[2]
    start = max(0, n // 2 - 300)
    count = min(n - start, 1000)
    ii = np.arange(start, start + count)
    i, j, k = ii // (r[1] * r[2]), (ii // r[2]) % r[1], ii % r[2]
    want = np.stack([axes[0][i], axes[1][j], axes[2][k]], -1)
    got = occ.lattice_points(r, lo, hi, start, count, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_bake_refuses_bad_specs():
    tp = params_from_jax(_params())["fine"]
    cfg = NerfMLPConfig(**TINY)
    with pytest.raises(ValueError, match="bad grid spec"):
        occ.bake_occupancy(tp, cfg, (0, 0, 0), (1, 1, 0), resolution=5)
    with pytest.raises(ValueError, match="bad grid spec"):
        occ.bake_occupancy(tp, cfg, (0, 0, 0), (1, 1, 1), resolution=1)
    with pytest.raises(ValueError, match="kernels"):
        occ.bake_occupancy(tp, cfg, (0, 0, 0), (1, 1, 1), resolution=3,
                           kernels="auto")


def test_scene_bake_picks_the_net_and_box():
    """``bake_scene_occupancy``: the fine net unless ``n_fine == 0``, the NDC
    box for NDC scenes, else the ``±bound`` cube; ``occupied_fraction`` as
    JAX computes it."""
    p = _params()
    tp = params_from_jax(p)
    cfg = NerfMLPConfig(**TINY)
    for ndc, n_fine in ((False, 4), (True, 4), (False, 0)):
        want = jocc.bake_scene_occupancy(p, JaxCfg(**TINY), ndc=ndc,
                                         bound=1.3, n_fine=n_fine,
                                         resolution=6, pallas="off")
        got = occ.bake_scene_occupancy(tp, cfg, ndc=ndc, bound=1.3,
                                       n_fine=n_fine, resolution=6)
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.bbox_min.numpy(),
                                      np.asarray(want.bbox_min))
        assert occ.occupied_fraction(got) == jocc.occupied_fraction(want)
    assert occ.scene_bbox(True, 9.0) == jocc.scene_bbox(True, 9.0)
    assert occ.scene_bbox(False, 2.0) == jocc.scene_bbox(False, 2.0)


def _probe_points(grid, n=4000, seed=0):
    """Points inside and outside the box, on lattice vertices and on ties
    at half a cell (the rounding's halfway cases)."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(grid.bbox_min)
    sp = 1.0 / np.asarray(grid.inv_spacing)
    r = np.asarray(grid.values.shape)
    inside = lo + rng.rand(n, 3).astype(np.float32) * (r - 1) * sp
    outside = lo + (rng.rand(n // 4, 3).astype(np.float32) * 1.6 - 0.3) \
        * (r - 1) * sp
    verts = lo + rng.randint(0, r, (n // 4, 3)) * sp
    halves = lo + (rng.randint(0, r - 1, (n // 4, 3)) + 0.5) * sp
    return np.concatenate([inside, outside, verts, halves]).astype(
        np.float32).reshape(-1, 5, 3)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_probes_match_jax_bitwise(interp):
    """The nearest probe is a gather: bitwise. The trilinear probe's z lerp
    is JAX's one-hot contraction with two nonzero terms, which XLA may
    sum with a fused multiply-add: 1e-6 stated (it reads 0 here)."""
    p = _params()
    g = jocc.bake_occupancy(p["fine"], JaxCfg(**TINY), (-1.0, -0.9, -1.1),
                            (1.0, 1.2, 0.8), resolution=(7, 8, 9), dilate=1,
                            pallas="off")
    pts = _probe_points(g)
    want = np.asarray(jocc.probe_sigma(g, jnp.asarray(pts), interp))
    got = occ.probe_sigma(grid_from_jax(g), torch.from_numpy(pts), interp)
    assert got.shape == want.shape == pts.shape[:-1]
    if interp == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="interp"):
        occ.probe_sigma(grid_from_jax(g), torch.from_numpy(pts), "cubic")


def test_half_cell_ties_round_to_even():
    """A point exactly half a cell from two vertices takes the even index
    (``jnp.round`` and ``torch.round``), and a probe outside the box clamps
    to the boundary vertex."""
    values = torch.arange(4, dtype=torch.float32).reshape(4, 1, 1).expand(
        4, 2, 2).contiguous()
    g = occ.OccupancyGrid(values, torch.zeros(3), torch.ones(3))
    pts = torch.tensor([[0.5, 0, 0], [1.5, 0, 0], [2.5, 0, 0], [9.0, 0, 0],
                        [-3.0, 0, 0]])
    assert occ.occupancy_sigma(g, pts).tolist() == [0.0, 2.0, 2.0, 3.0, 0.0]


def test_ray_bounds_match_jax():
    g = _sphere_grid()
    rng = np.random.RandomState(3)
    o = (rng.randn(300, 3) * 0.3 + [0, 0, 3]).astype(np.float32)
    d = (rng.randn(300, 3) * 0.3 + [0, 0, -1]).astype(np.float32)
    near = np.full(300, 1.0, np.float32)
    far = np.full(300, 5.0, np.float32)
    for eps in (1e-3, 0.5):
        jn, jf = jocc.occupancy_ray_bounds(g, *map(jnp.asarray,
                                                   (o, d, near, far)),
                                           eps=eps, n_probe=64)
        tn, tf = occ.occupancy_ray_bounds(grid_from_jax(g),
                                          *map(torch.from_numpy,
                                               (o, d, near, far)),
                                          eps=eps, n_probe=64)
        # JAX's transmittance within a few ulps of eps could move a
        # threshold one probe: count those rays, compare the rest exactly.
        step = (far - near) / 63
        t = near[:, None] + step[:, None] * np.arange(64, dtype=np.float32)
        sig = np.asarray(jocc.occupancy_sigma(
            g, jnp.asarray(o[:, None] + d[:, None] * t[..., None])))
        delta = step[:, None] * np.linalg.norm(d, axis=-1, keepdims=True)
        trans = np.cumprod(1 - (1 - np.exp(-np.maximum(sig, 0) * delta))
                           + 1e-10, -1)
        near_eps = (np.abs(trans - eps) <= 8 * np.spacing(np.float32(eps))
                    ).any(-1)
        assert near_eps.sum() == 0
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert (tn.numpy() > near).any() and (tf.numpy() < far).any()


def _render_inputs(n=40, seed=0):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.2 + [0, 0, 3]).astype(np.float32)
    d = (rng.randn(n, 3) * 0.2 + [0, 0, -1]).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, v


OCC_MODES = {
    "merge": dict(),
    "merge_trilinear": dict(occupancy_interp="trilinear"),
    "full": dict(occupancy_mode="full"),
    "full_floor": dict(occupancy_mode="full", occ_floor=5),
    "term": dict(occupancy_mode="full", occupancy_termination=1e-3,
                 termination_probes=32),
    "merge_noise_iid": dict(noise_std=0.5, sorted_resample=False),
}


@pytest.mark.parametrize("mode", list(OCC_MODES))
def test_render_rays_through_a_grid_matches_jax(mode):
    """``render_rays`` with a JAX-baked grid, perturb on (the stratified,
    resample and floor draws are the JAX streams bit for bit): rgb and acc
    1e-5, depth 1e-5; ``rgb_coarse`` is the fine map and the coarse net
    is never read."""
    p = _params(alpha_bias=2.0)
    change = dict(OCC_MODES[mode], perturb=True)
    g = _sphere_grid()
    jcfg = dataclasses.replace(JaxRender(n_coarse=12, n_fine=16,
                                         mlp=JaxCfg(**TINY), pallas="off",
                                         white_bkg=True), **change)
    tcfg = dataclasses.replace(RenderConfig(n_coarse=12, n_fine=16,
                                            mlp=NerfMLPConfig(**TINY),
                                            white_bkg=True), **change)
    o, d, v = _render_inputs()
    near, far = np.full(40, 1.5, np.float32), np.full(40, 4.5, np.float32)
    want = jax.jit(jax_render_rays, static_argnames=("cfg",))(
        jax.random.PRNGKey(4), p, *map(jnp.asarray, (o, d, v, near, far)),
        cfg=jcfg, occupancy=g)
    tp = params_from_jax(p)
    tp["coarse"] = None          # the occupancy path never reads it
    got = render_rays(tp, *map(torch.from_numpy, (o, d, v, near, far)), tcfg,
                      key=PRNGKey(4), occupancy=grid_from_jax(g))
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got["rgb_coarse"] is got["rgb"]


@pytest.mark.parametrize("mode", ["merge", "full_floor", "term"])
def test_chunked_render_through_a_grid_is_chunk_invariant(mode):
    """``render_rays_chunked`` with a grid, against JAX's and across chunk
    sizes (the draws are keyed by global ray ids), deterministic resample
    (depth 1e-3)."""
    p = _params(alpha_bias=2.0)
    g = _sphere_grid()
    change = dict(OCC_MODES[mode], deterministic_resample=True)
    jcfg = dataclasses.replace(JaxRender(n_coarse=12, n_fine=16,
                                         mlp=JaxCfg(**TINY), pallas="off"),
                               **change).eval_mode()
    tcfg = dataclasses.replace(RenderConfig(n_coarse=12, n_fine=16,
                                            mlp=NerfMLPConfig(**TINY)),
                               **change).eval_mode()
    o, d, v = _render_inputs(n=37, seed=2)
    want = jax_render_rays_chunked(jax.random.PRNGKey(1), p,
                                   *map(jnp.asarray, (o, d, v)), 1.5, 4.5,
                                   jcfg, chunk=16, occupancy=g)
    tp, tg = params_from_jax(p), grid_from_jax(g)
    outs = [render_rays_chunked(tp, *map(torch.from_numpy, (o, d, v)), 1.5,
                                4.5, tcfg, chunk=c, occupancy=tg)
            for c in (16, 7)]
    for k in ("rgb", "acc", "depth"):
        tol = 1e-3 if k == "depth" else 1e-5
        np.testing.assert_allclose(outs[0][k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def test_occ_floor_must_leave_cdf_samples():
    p = params_from_jax(_params())
    g = occ.bake_occupancy(p["fine"], NerfMLPConfig(**TINY), (-1.0,) * 3,
                           (1.0,) * 3, resolution=4)
    cfg = RenderConfig(n_coarse=4, n_fine=4, mlp=NerfMLPConfig(**TINY),
                       occupancy_mode="full", occ_floor=4,
                       deterministic_resample=True).eval_mode()
    o, d, v = map(torch.from_numpy, _render_inputs(n=3))
    with pytest.raises(ValueError, match="occ_floor=4 must be in"):
        render_rays(p, o, d, v, 2.0, 4.0, cfg, occupancy=g)
