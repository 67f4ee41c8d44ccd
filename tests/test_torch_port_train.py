"""The port's training slice against the JAX package: the stochastic
renderer, the Adam schedule, three consecutive train steps, and the
``Trainer`` on a micro-scene.

Both packages get the same numpy-seeded params (``params_from_jax``), the
same PRNG key and the same data; JAX runs with ``pallas="off"``, the port
on the CPU (its kernels' plain versions). Tolerances:
  * renders: rgb/acc 1e-4, depth 1e-3 (``test_torch_port_render.py``; the
    sorted resample's log1p/cumsum and the noise's erfinv round apart by
    ~1e-7);
  * train metrics ``loss``/``mse_fine``/``psnr``/``grad_norm``: rtol 1e-4;
  * gradients, read through Adam's first moment (``0.1·g`` after the first
    step): 1e-3 of each leaf's largest, or of 1e-2 of its net's largest
    where the leaf's own is smaller (a leaf whose gradient cancels to 1e-4
    of its net's, as the fine l1 does here, keeps only the fp32 summation
    noise of its sums: measured 1.0e-3 of itself, 1e-9 absolute);
  * updated params: Adam's first step moves a weight by ~lr·sign(g), so a
    weight whose gradient is within rounding of zero may differ by up to
    2·lr; where |g| exceeds 1e-4 of its leaf's largest (and 1e-5, far
    above Adam's eps) they agree to 1e-6. From the second step on
    m̂/sqrt(v̂) is no longer ±1 and a gradient's relative error moves the
    weight by that fraction of lr (measured 1% on a fine-l6 weight whose
    gradient is a cancelled sum 50x below its leaf's largest), so there the
    bound holds where |g| exceeds 0.1 of its leaf's largest, widened by
    the gradient bound (1e-3) times lr for each step after the first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvnerf_tpu.data.synthetic import bench_scene as jax_bench_scene
from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.render.renderer import render_rays as jax_render_rays
from cvnerf_tpu.render.renderer import \
    render_rays_chunked as jax_render_rays_chunked
from cvnerf_tpu.train.loop import TrainConfig as JaxTrain
from cvnerf_tpu.train.loop import make_train_step as jax_make_train_step
from cvnerf_tpu.train.state import create_train_state as jax_create_state
from cvnerf_tpu.train.state import make_lr_schedule
from cvnerf_torch.data.synthetic import (bench_scene, pose_spherical,
                                         render_sphere_scene)
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey, fold_in
from cvnerf_torch.parallel.mesh import make_mesh
from cvnerf_torch.render.renderer import (RenderConfig, render_rays,
                                          render_rays_chunked)
from cvnerf_torch.train.loop import TrainConfig, Trainer, make_train_step
from cvnerf_torch.train.state import Adam, create_train_state
from cvnerf_torch.utils.convert import params_from_jax, train_state_from_jax
from cvnerf_torch.utils.tree import tree_leaves

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these steps are many small ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(seed=0):
    state = jax_create_state(jax.random.PRNGKey(seed), mlp=JaxCfg(**TINY))
    p = _np(state.params)
    for net in p.values():   # some opacity, so the resample has structure
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
    return p


def _rays(n=24, seed=0):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.2 + [0, 0, 4]).astype(np.float32)
    d = (rng.randn(n, 3) * 0.2 + [0, 0, -1]).astype(np.float32)
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, v


def _check(got, want):
    for k in ("rgb", "rgb_coarse", "acc", "depth"):
        tol = 1e-3 if k == "depth" else 1e-4
        np.testing.assert_allclose(np.asarray(got[k].detach()),
                                   np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("sorted_resample", [True, False])
def test_stochastic_render_rays_matches_jax(sorted_resample):
    """perturb + density noise + the stochastic resample (sorted uniforms
    or iid then sort), same key and global ray ids."""
    p = _jax_params()
    kw = dict(n_coarse=8, n_fine=16, perturb=True, noise_std=1.0,
              white_bkg=True, sorted_resample=sorted_resample)
    jcfg = JaxRender(mlp=JaxCfg(**TINY), pallas="off", **kw)
    tcfg = RenderConfig(mlp=NerfMLPConfig(**TINY), **kw)
    o, d, v = _rays()
    ids = np.arange(24, dtype=np.int32) * 3 + 1000
    near, far = np.full(24, 2.0, np.float32), np.full(24, 6.0, np.float32)
    want = jax.jit(jax_render_rays, static_argnames=("cfg",))(
        jax.random.PRNGKey(4), p, *map(jnp.asarray, (o, d, v, near, far)),
        cfg=jcfg, ray_ids=jnp.asarray(ids), noise_scale=0.5)
    got = render_rays(params_from_jax(p), *map(torch.from_numpy,
                                               (o, d, v, near, far)),
                      tcfg, key=PRNGKey(4),
                      ray_ids=torch.from_numpy(ids.astype(np.int64)),
                      noise_scale=0.5)
    _check(got, want)


def test_stochastic_chunked_render_is_chunk_invariant_and_matches_jax():
    """Draws are keyed by global ray id: two chunk sizes give the same
    stochastic render (1e-6), which is JAX ``render_rays_chunked``'s."""
    p = _jax_params(1)
    kw = dict(n_coarse=8, n_fine=8, perturb=True, noise_std=1.0)
    jcfg = JaxRender(mlp=JaxCfg(**TINY), pallas="off", **kw)
    tcfg = RenderConfig(mlp=NerfMLPConfig(**TINY), **kw)
    o, d, v = _rays(30, seed=1)
    tp = params_from_jax(p)
    a = render_rays_chunked(tp, *map(torch.from_numpy, (o, d, v)), 2.0, 6.0,
                            tcfg, chunk=8, key=PRNGKey(6))
    b = render_rays_chunked(tp, *map(torch.from_numpy, (o, d, v)), 2.0, 6.0,
                            tcfg, chunk=32, key=PRNGKey(6))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)
    want = jax_render_rays_chunked(jax.random.PRNGKey(6), p,
                                   *map(jnp.asarray, (o, d, v)), 2.0, 6.0,
                                   jcfg, chunk=16)
    _check(a, want)


@pytest.mark.parametrize("lr_decay", [1, 250])
def test_lr_schedule_matches_optax(lr_decay):
    adam = Adam(lr=5e-4, lr_decay=lr_decay)
    sched = make_lr_schedule(5e-4, lr_decay)
    for k in (0, 1, 1000, 123_456):
        np.testing.assert_allclose(float(adam.learning_rate(k)),
                                   float(sched(k)), rtol=1e-6, atol=0)
    assert float(adam.learning_rate(0)) == float(np.float32(5e-4))


def _compare_states(jstate, tstate, lr, step):
    jp, jm = _np(jstate.params), _np(jstate.opt_state[0].mu)
    worst_g = worst_any = worst_big = 0.0
    for net in jp:
        net_scale = max(np.abs(x).max() for x in jax.tree.leaves(jm[net]))
        for layer in jp[net]:
            for q in ("w", "b"):
                g = jm[net][layer][q]
                gt = tstate.opt_state.mu[net][layer][q].numpy()
                scale = max(np.abs(g).max(), 1e-30)
                worst_g = max(worst_g, np.abs(gt - g).max()
                              / max(scale, 1e-2 * net_scale))
                diff = np.abs(tstate.params[net][layer][q].numpy()
                              - jp[net][layer][q])
                worst_any = max(worst_any, diff.max())
                frac = 1e-4 if step == 1 else 0.1
                big = (np.abs(g) > frac * scale) & (np.abs(g) > 1e-6)
                if big.any():
                    worst_big = max(worst_big, diff[big].max())
                if jstate.ema_params is not None:
                    # The averages start equal, so each stays a convex
                    # mix of params that differ within the bounds above.
                    ediff = np.abs(
                        tstate.ema_params[net][layer][q].numpy()
                        - np.asarray(jstate.ema_params[net][layer][q]))
                    worst_any = max(worst_any, ediff.max())
                    if big.any():
                        worst_big = max(worst_big, ediff[big].max())
    assert (jstate.ema_params is None) == (tstate.ema_params is None)
    assert worst_g <= 1e-3, worst_g
    assert worst_any <= 2 * lr + 1e-7, worst_any
    assert worst_big <= 1e-6 + (step - 1) * 1e-3 * lr, worst_big


LEVER_CASES = {
    "prp": {}, "precrop": dict(precrop_iters=10),
    "replace": dict(pixel_sampling="replace"),
    "ema_decay": dict(ema_decay=0.9),
    "noise_decay": dict(noise_decay=2),
    "freq_anneal": dict(freq_anneal=4),
    "distortion_loss": dict(distortion_loss=0.01, distortion_start=1,
                            distortion_ramp=2),
    "occlusion_loss": dict(occlusion_loss=0.01),
    "ray_batching": dict(ray_batching=True),
    "parity": dict(pixel_sampling="parity"),
    "parity_precrop": dict(pixel_sampling="parity", precrop_iters=10),
}


@pytest.mark.parametrize("extra", list(LEVER_CASES.values()),
                         ids=list(LEVER_CASES))
def test_three_train_steps_match_jax(extra):
    """Three consecutive steps from one JAX state (carried over with
    ``train_state_from_jax``) and the trainer's per-step keys, plain and
    with each lever alone: the schedules move within the three steps
    (noise 1, 0.5, 0; anneal 0, 0.25, 0.5; distortion weight 0, 0, 0.5),
    and the EMA slot is compared as the params are."""
    images, poses = jax_bench_scene(32, 32)
    rkw = dict(n_coarse=8, n_fine=8, perturb=True, noise_std=1.0,
               white_bkg=True)
    tkw = dict(height=32, width=32, focal=40.0, near=2.0, far=6.0,
               n_rays=64, lr=5e-4, lr_decay=1, **extra)
    jcfg = JaxTrain(render=JaxRender(mlp=JaxCfg(**TINY), pallas="off",
                                     **rkw), **tkw)
    tcfg = TrainConfig(render=RenderConfig(mlp=NerfMLPConfig(**TINY), **rkw),
                       **tkw)
    jstate = jax_create_state(jax.random.PRNGKey(2), lr=5e-4, lr_decay=1,
                              mlp=JaxCfg(**TINY),
                              ema=bool(extra.get("ema_decay")))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    jstep, tstep = jax_make_train_step(jcfg), make_train_step(tcfg)
    precrop = bool(extra.get("precrop_iters"))
    idx = np.array([0, 1])
    for i in (1, 2, 3):
        jstate, jm = jstep(jstate, jax.random.fold_in(jax.random.PRNGKey(0),
                                                      i),
                           jnp.asarray(images), jnp.asarray(poses),
                           jnp.asarray(idx), precrop=precrop)
        tstate, tm = tstep(tstate, fold_in(PRNGKey(0), i),
                           torch.from_numpy(images), torch.from_numpy(poses),
                           torch.from_numpy(idx), precrop)
        for k in ("loss", "mse_fine", "psnr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert tstate.step == int(jstate.step) == i
        assert tstate.opt_state.count == int(jstate.opt_state[0].count)
        _compare_states(jstate, tstate, tcfg.lr, i)


@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "full"])
def test_create_train_state_from_a_key_is_the_jax_init(cfg):
    """From a ``PRNGKey`` the nets are the JAX package's
    ``create_train_state(key)`` nets bit for bit (the CLI starts there)."""
    for seed in (0, 3) if cfg else (0,):
        want = jax_create_state(jax.random.PRNGKey(seed), mlp=JaxCfg(**cfg))
        got = create_train_state(PRNGKey(seed), mlp=NerfMLPConfig(**cfg),
                                 device="cpu", ema=True)
        for net, layers in want.params.items():
            for layer, leaves in layers.items():
                for q, w in leaves.items():
                    np.testing.assert_array_equal(
                        got.params[net][layer][q].numpy(), np.asarray(w))
                    np.testing.assert_array_equal(
                        got.ema_params[net][layer][q].numpy(), np.asarray(w))


def test_train_state_from_jax_carries_everything():
    js = jax_create_state(jax.random.PRNGKey(3), mlp=JaxCfg(**TINY))
    ts = train_state_from_jax(_np(js))
    assert ts.step == 0 and ts.opt_state.count == 0
    np.testing.assert_array_equal(ts.params["fine"]["l3"]["w"].numpy(),
                                  np.asarray(js.params["fine"]["l3"]["w"]))
    assert all(float(t.abs().max()) == 0
               for t in tree_leaves(ts.opt_state.nu))
    # the optax state the JAX step carries: adam then the schedule's count
    assert isinstance(js.opt_state[1], optax.ScaleByScheduleState)


def test_trainer_overfits_a_micro_scene():
    """The port's ``Trainer`` on its own analytic sphere render (one 16x16
    view over white, CPU, TINY): the mean loss of the last 10 of 300 steps
    is at most half the first 10's (measured 0.39), the metrics are finite,
    and the callbacks fire on their steps."""
    pose = pose_spherical(30.0, -30.0, 4.0)[:3]
    rgba = render_sphere_scene(16, 16, 20.0, pose)
    images = (rgba[..., :3] + (1.0 - rgba[..., 3:]))[None]
    mlp = NerfMLPConfig(**TINY)
    cfg = TrainConfig(height=16, width=16, focal=20.0, near=2.0, far=6.0,
                      n_rays=64, lr=3e-3, lr_decay=1,
                      render=RenderConfig(n_coarse=8, n_fine=8,
                                          white_bkg=True, mlp=mlp))
    state = create_train_state(PRNGKey(0), lr=cfg.lr,
                               lr_decay=cfg.lr_decay, mlp=mlp, device="cpu")
    tr = Trainer(cfg, state, images, pose[None], [0], seed=0)
    losses, fired = [], []
    tr.add_callback(1, lambda i, t, m: losses.append(m["loss"]))
    tr.add_callback(100, lambda i, t, m: fired.append(i))
    tr.add_callback(0, lambda i, t, m: fired.append(-1))   # disabled
    m = tr.run(1, 301)
    assert fired == [100, 200, 300] and len(losses) == 300
    assert tr.state.step == 300 and tr.state.opt_state.count == 300
    assert all(np.isfinite(v) for v in m.values()) and m["rays_per_sec"] > 0
    assert np.mean(losses[-10:]) <= 0.5 * np.mean(losses[:10]), (
        np.mean(losses[:10]), np.mean(losses[-10:]))


def test_trainer_steps_match_the_step_function():
    """``Trainer.run`` draws step i with ``fold_in(PRNGKey(seed), i)``;
    ``steps_per_call`` groups nothing (the same single steps)."""
    images, poses = bench_scene(16, 16)
    cfg = TrainConfig(height=16, width=16, focal=20.0, near=2.0, far=6.0,
                      n_rays=32, render=RenderConfig(
                          n_coarse=4, n_fine=4, mlp=NerfMLPConfig(**TINY)))

    def fresh():
        return create_train_state(PRNGKey(1),
                                  mlp=NerfMLPConfig(**TINY), device="cpu")

    tr = Trainer(cfg, fresh(), images, poses, [0, 1], seed=7,
                 steps_per_call=4)
    tr.run(1, 4)
    step, state = make_train_step(cfg), fresh()
    for i in (1, 2, 3):
        state, _ = step(state, fold_in(PRNGKey(7), i),
                        torch.from_numpy(images), torch.from_numpy(poses),
                        torch.tensor([0, 1]), False)
    for a, b in zip(tree_leaves(tr.state.params), tree_leaves(state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("change,item", [
    (dict(pixel_sampling="parity"), "Queue 1 item 9"),
    (dict(ray_batching=True), "Queue 1 item 9"),
    (dict(ema_decay=0.999), "Queue 1 item 9"),
    (dict(noise_decay=100), "Queue 1 item 9"),
    (dict(freq_anneal=100), "Queue 1 item 9"),
    (dict(distortion_loss=0.01), "Queue 1 item 9"),
    (dict(occlusion_loss=0.01), "Queue 1 item 9"),
    (dict(fused_allreduce=True), "Queue 1 item 11"),
])
def test_unported_options_raise(change, item):
    """The levers of ROADMAP Queue 1 item 9 and ``fused_allreduce`` (item
    11), once refused here, now build a step and train through
    ``Trainer``: each item-9 lever alone, ``fused_allreduce`` on a
    2-shard CPU mesh. A ``Trainer`` takes a mesh (once refused too), a
    mesh that does not divide ``n_rays`` raises with the JAX message, and
    an impossible draw still raises."""
    base = TrainConfig(height=8, width=8, focal=10.0, near=2.0, far=6.0,
                       n_rays=16, render=RenderConfig(
                           n_coarse=4, n_fine=4, noise_std=1.0,
                           mlp=NerfMLPConfig(**TINY)))
    cfg = dataclasses.replace(base, **change)
    state = create_train_state(PRNGKey(0),
                               mlp=NerfMLPConfig(**TINY), device="cpu",
                               ema=cfg.ema_decay > 0)
    images, poses = bench_scene(8, 8)
    mesh = make_mesh(devices=["cpu"] * 2)
    tr = Trainer(cfg, state, images, poses, [0, 1],
                 mesh=mesh if item.endswith("item 11") else None)
    m = tr.run(1, 3)
    assert tr.state.step == 2 and all(np.isfinite(v) for v in m.values())
    assert (tr.state.ema_params is not None) == (cfg.ema_decay > 0)
    state = create_train_state(PRNGKey(0), mlp=NerfMLPConfig(**TINY),
                               device="cpu")
    tr = Trainer(base, state, images, poses, [0], mesh=mesh)
    m = tr.run(1, 3)
    assert tr.state.step == 2 and all(np.isfinite(v) for v in m.values())
    with pytest.raises(ValueError, match="divisible by the mesh size 3"):
        Trainer(base, state, images, poses, [0],
                mesh=make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="exceeds"):
        make_train_step(dataclasses.replace(base, n_rays=65))


def test_trainer_guards_match_jax():
    """The JAX ``Trainer``'s refusals: an EMA decay outside [0, 1), an EMA
    decay without the slot and a slot without the decay, an occlusion
    window that is the whole ray, a ray-batching pool smaller than a
    batch, and ray batching with any draw but the Feistel one."""
    base = TrainConfig(height=8, width=8, focal=10.0, near=2.0, far=6.0,
                       n_rays=16, render=RenderConfig(
                           n_coarse=4, n_fine=4, mlp=NerfMLPConfig(**TINY)))
    images, poses = bench_scene(8, 8)

    def state(ema):
        return create_train_state(PRNGKey(0),
                                  mlp=NerfMLPConfig(**TINY), device="cpu",
                                  ema=ema)
    for change, ema, match in (
            (dict(ema_decay=1.0), True, r"\[0, 1\)"),
            (dict(ema_decay=0.9), False, "EMA slot"),
            ({}, True, "freeze silently"),
            (dict(occlusion_loss=0.1, occlusion_frac=1.0), False, r"\(0, 1\)"),
            (dict(ray_batching=True, n_rays=130), False, "ray-batching pool")):
        with pytest.raises(ValueError, match=match):
            Trainer(dataclasses.replace(base, **change), state(ema), images,
                    poses, [0, 1])
    with pytest.raises(ValueError, match="Feistel"):
        make_train_step(dataclasses.replace(base, ray_batching=True,
                                            pixel_sampling="parity"))
    # A batch larger than one image is fine across the split.
    Trainer(dataclasses.replace(base, ray_batching=True, n_rays=100),
            state(False), images, poses, [0, 1])
