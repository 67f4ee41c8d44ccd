"""The port's renderer and frame rendering against the JAX package.

The same params (converted with ``params_from_jax``) and the same pose go
through JAX ``render_image(pallas="off")`` and the port on the CPU, in the
serving configuration (eval mode, deterministic resample) and with the
random draws on (same key). Tolerances:
rgb/acc 1e-4, depth 1e-3 — the deterministic ``u = 1`` meets ``cdf[-1] ≈
1``, whose rounding differs between the frameworks' cumsums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.render.frames import render_image as jax_render_image
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.render.renderer import render_rays as jax_render_rays
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.frames import render_image, render_poses_to_frames
from cvnerf_torch.render.renderer import (RenderConfig, render_rays,
                                          render_rays_chunked)
from cvnerf_torch.utils.convert import params_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
KEYS = ("rgb", "rgb_coarse", "acc", "depth")


def _params(kw):
    cfg = JaxCfg(**kw)
    p = {"coarse": jax_init(jax.random.PRNGKey(0), cfg),
         "fine": jax_init(jax.random.PRNGKey(1), cfg)}
    for net in p.values():   # some opacity, so the resample has structure
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
    return jax.tree.map(np.asarray, p)


def _cfgs(kw, n_coarse=8, n_fine=16, white_bkg=True):
    jcfg = JaxRender(n_coarse=n_coarse, n_fine=n_fine, white_bkg=white_bkg,
                     mlp=JaxCfg(**kw), pallas="off",
                     deterministic_resample=True).eval_mode()
    tcfg = RenderConfig(n_coarse=n_coarse, n_fine=n_fine, white_bkg=white_bkg,
                        mlp=NerfMLPConfig(**kw),
                        deterministic_resample=True).eval_mode()
    return jcfg, tcfg


def _check(got, want):
    for k in KEYS:
        tol = 1e-3 if k == "depth" else 1e-4
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


POSE = np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4], [0, 0.6, 0.8, 3.2]],
                np.float32)
NDC_POSE = np.array([[1, 0, 0, 0.05], [0, 1, 0, 0.02], [0, 0, 1, 0.1]],
                    np.float32)


@pytest.mark.parametrize("white_bkg", [False, True])
def test_render_rays_matches_jax(white_bkg):
    p = _params(TINY)
    jcfg, tcfg = _cfgs(TINY, white_bkg=white_bkg)
    rng = np.random.RandomState(0)
    o = rng.randn(20, 3).astype(np.float32) * 0.2 + [0, 0, 4]
    d = rng.randn(20, 3).astype(np.float32) * 0.2 + [0, 0, -1]
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full(20, 2.0, np.float32), np.full(20, 6.0, np.float32)
    render = jax.jit(jax_render_rays, static_argnames=("cfg",))
    want = render(jax.random.PRNGKey(0), p, *map(jnp.asarray,
                                                 (o, d, v, near, far)),
                  cfg=jcfg)
    got = render_rays(params_from_jax(p), *map(torch.from_numpy,
                                               (o, d, v, near, far)), tcfg)
    _check(got, want)


@pytest.mark.parametrize("kw,ndc", [(TINY, False), (TINY, True), ({}, False)])
def test_render_image_matches_jax(kw, ndc):
    p = _params(kw)
    jcfg, tcfg = _cfgs(kw)
    pose, near, far = (NDC_POSE, 0.0, 1.0) if ndc else (POSE, 2.0, 6.0)
    h, w = (6, 8) if kw else (4, 5)
    want = jax_render_image(jax.random.PRNGKey(2), p, h, w, 7.0,
                            jnp.asarray(pose), near, far, jcfg, ndc=ndc,
                            chunk=16)
    got = render_image(params_from_jax(p), h, w, 7.0, torch.from_numpy(pose),
                       near, far, tcfg, ndc=ndc, chunk=16)
    assert got["rgb"].shape == (h, w, 3) and got["depth"].shape == (h, w)
    _check(got, want)


def test_kernel_path_on_cpu_equals_kernels_off_and_is_chunk_invariant():
    """With kernels on, CPU tensors take the kernel's plain version, which
    equals the kernels-off path; padding the ragged last chunk with zero
    rays changes no pixel."""
    tp = params_from_jax(_params(TINY))
    _, on = _cfgs(TINY)
    off = dataclasses.replace(on, kernels="off")
    pose = torch.from_numpy(POSE)
    plain_calls = fm.fused_nerf_plain.calls
    a = render_image(tp, 6, 8, 7.0, pose, 2.0, 6.0, on, chunk=16)
    assert fm.fused_nerf_plain.calls == plain_calls + 2 * 3   # 3 chunks
    b = render_image(tp, 6, 8, 7.0, pose, 2.0, 6.0, off, chunk=16)
    c = render_image(tp, 6, 8, 7.0, pose, 2.0, 6.0, off, chunk=48)
    for k in KEYS:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        torch.testing.assert_close(b[k], c[k], rtol=1e-6, atol=1e-6)


def test_render_poses_to_frames_matches_render_image():
    tp = params_from_jax(_params(TINY))
    _, cfg = _cfgs(TINY)
    poses = np.stack([POSE, NDC_POSE + [[0, 0, 0, 0], [0, 0, 0, 0],
                                        [0, 0, 0, 3]]])
    seen = []
    out = render_poses_to_frames(tp, poses, 6, 8, 7.0, 2.0, 6.0, cfg,
                                 chunk=16, frame_keys=("rgb", "depth"),
                                 on_frame=lambda i, f: seen.append(i),
                                 device="cpu")
    assert seen == [0, 1] and out["rgb"].shape == (2, 6, 8, 3)
    for i, pose in enumerate(poses):
        one = render_image(tp, 6, 8, 7.0, torch.from_numpy(pose), 2.0, 6.0,
                           cfg, chunk=16)
        np.testing.assert_array_equal(out["rgb"][i], one["rgb"].numpy())
        np.testing.assert_array_equal(out["depth"][i], one["depth"].numpy())
    half = render_poses_to_frames(tp, poses[:1], 6, 8, 7.0, 2.0, 6.0, cfg,
                                  chunk=16, factor=2, device="cpu")
    assert half.shape == (1, 3, 4, 3)
    assert render_poses_to_frames(tp, [], 6, 8, 7.0, 2.0, 6.0, cfg,
                                  device="cpu").shape == (0, 6, 8, 3)
    with pytest.raises(ValueError, match="requires on_frame"):
        render_poses_to_frames(tp, poses, 6, 8, 7.0, 2.0, 6.0, cfg,
                               collect=False, device="cpu")


@pytest.mark.parametrize("change", [dict(perturb=True),
                                    dict(noise_std=1.0),
                                    dict(deterministic_resample=False)])
def test_stochastic_configs_match_jax(change):
    """The configurations that draw random numbers render as JAX
    ``render_image`` does from the same key (the port's RNG is the JAX
    stream bit for bit); tolerances as above. Without a key they raise."""
    p = _params(TINY)
    jcfg, tcfg = _cfgs(TINY)
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    want = jax_render_image(jax.random.PRNGKey(5), p, 6, 8, 7.0,
                            jnp.asarray(POSE), 2.0, 6.0, jcfg, chunk=16)
    got = render_image(params_from_jax(p), 6, 8, 7.0, torch.from_numpy(POSE),
                       2.0, 6.0, tcfg, chunk=16, key=PRNGKey(5))
    _check(got, want)
    o = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="pass key="):
        render_rays_chunked(params_from_jax(p), o, o + 1, o + 1, 2.0, 6.0,
                            tcfg)
    with pytest.raises(ValueError, match="kernels"):
        dataclasses.replace(tcfg, kernels="auto").check_supported()


# ---------- the reference-shaped API (tests/test_render_api.py) ----------

API = dict(xyz_freqs=4, dir_freqs=2, trunk_width=64, head_width=32)
API_C2W = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 4.0]],
                   np.float32)


def _api_params():
    p = {"coarse": jax_init(jax.random.PRNGKey(0), JaxCfg(**API)),
         "fine": jax_init(jax.random.PRNGKey(1), JaxCfg(**API))}
    return p, params_from_jax(jax.tree.map(np.asarray, p))


def test_compute_rays_alias_and_the_reexports():
    """``ops.compute_rays`` is ``ray_grid``, as in the JAX package, and each
    subpackage re-exports the JAX subpackage's public names."""
    import importlib
    from cvnerf_torch.ops import compute_rays, ray_grid
    c2w = torch.eye(4)[:3]
    a, b = compute_rays(4, 6, 8.0, c2w), ray_grid(4, 6, 8.0, c2w)
    assert torch.equal(a[1], b[1]) and compute_rays is ray_grid
    for sub in ("ops", "render", "models", "train", "data", "parallel",
                "utils"):
        want = importlib.import_module(f"cvnerf_tpu.{sub}").__all__
        got = importlib.import_module(f"cvnerf_torch.{sub}")
        assert set(want) <= set(got.__all__), (sub, set(want) - set(
            got.__all__))
        assert all(hasattr(got, name) for name in got.__all__), sub


@pytest.mark.parametrize("source", ["c2w", "rays"])
def test_render_matches_the_jax_render(source):
    """``render`` with ``c2w=`` or with the frame's ``rays=`` (shaped
    ``[H, W, 3]``) against the JAX ``render`` of the same key: rgb and the
    extras' shapes, and the ray batch equal to the frame."""
    from cvnerf_tpu.ops import ray_grid as jax_ray_grid
    from cvnerf_tpu.render import render as jax_render
    from cvnerf_torch.ops import ray_grid
    from cvnerf_torch.render import render
    jp, tp = _api_params()
    jcfg = JaxRender(n_coarse=8, n_fine=8, mlp=JaxCfg(**API), pallas="off"
                     ).eval_mode()
    tcfg = RenderConfig(n_coarse=8, n_fine=8, mlp=NerfMLPConfig(**API)
                        ).eval_mode()
    kw = dict(chunk=64, ndc=False, near=2.0, far=6.0)
    if source == "c2w":
        want = jax_render(jax.random.PRNGKey(0), jp, 8, 10, 9.0,
                          c2w=jnp.asarray(API_C2W), cfg=jcfg, **kw)
        got = render(tp, 8, 10, 9.0, c2w=API_C2W, cfg=tcfg,
                     key=PRNGKey(0), **kw)
    else:
        want = jax_render(jax.random.PRNGKey(0), jp, 8, 10, 9.0,
                          rays=jax_ray_grid(8, 10, 9.0,
                                            jnp.asarray(API_C2W)),
                          cfg=jcfg, **kw)
        got = render(tp, 8, 10, 9.0,
                     rays=ray_grid(8, 10, 9.0, torch.from_numpy(API_C2W)),
                     cfg=tcfg, key=PRNGKey(0), **kw)
        frame, _ = render(tp, 8, 10, 9.0, c2w=API_C2W, cfg=tcfg,
                          key=PRNGKey(0), **kw)
        np.testing.assert_allclose(got[0].numpy(), frame.numpy(),
                                   rtol=1e-4, atol=1e-5)
    (rgb, extras), (jrgb, jextras) = got, want
    assert rgb.shape == (8, 10, 3) and extras["acc"].shape == (8, 10)
    assert extras["rgb_coarse"].shape == (8, 10, 3)
    assert set(extras) == set(jextras)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4,
                               atol=1e-4)


def test_render_requires_exactly_one_source_and_defaults_to_ndc():
    """``render`` refuses both or neither of ``rays=``/``c2w=``, and its
    ``ndc`` defaults to True, as the reference's does."""
    from cvnerf_torch.render import render
    _, tp = _api_params()
    cfg = RenderConfig(n_coarse=4, n_fine=0, mlp=NerfMLPConfig(**API)
                       ).eval_mode()
    with pytest.raises(ValueError, match="exactly one"):
        render(tp, 8, 8, 9.0, cfg=cfg)
    with pytest.raises(ValueError, match="exactly one"):
        render(tp, 8, 8, 9.0, cfg=cfg, c2w=API_C2W,
               rays=ray_grid_np(8, 8, 9.0))
    c2w = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0.0]],
                   np.float32)
    default, _ = render(tp, 8, 8, 10.0, chunk=64, c2w=c2w, cfg=cfg)
    ndc, _ = render(tp, 8, 8, 10.0, chunk=64, c2w=c2w, ndc=True, cfg=cfg)
    plain, _ = render(tp, 8, 8, 10.0, chunk=64, c2w=c2w, ndc=False,
                      cfg=cfg)
    assert torch.equal(default, ndc) and not torch.allclose(default, plain)


def ray_grid_np(h, w, focal):
    from cvnerf_torch.ops import ray_grid
    return ray_grid(h, w, focal, torch.from_numpy(API_C2W))


@pytest.mark.parametrize("kw", [{}, TINY], ids=["reference", "tiny"])
def test_nerf_param_count_matches_jax(kw):
    """``nerf_param_count`` of the port's net is the JAX count (the
    reference net: 11 linear layers + the alpha head, ``tests/
    test_mlp.py:30``)."""
    from cvnerf_tpu.models import nerf_param_count as jax_count
    from cvnerf_torch.models import nerf_param_count
    want = jax_init(jax.random.PRNGKey(0), JaxCfg(**kw))
    got = nerf_param_count(params_from_jax(jax.tree.map(np.asarray, want)))
    assert got == jax_count(want)
    if not kw:
        assert got == sum(i * o + o for i, o in [
            (63, 256), (256, 256), (256, 256), (256, 256), (256, 256),
            (319, 256), (256, 256), (256, 256), (256, 256), (256, 1),
            (283, 128), (128, 3)])
