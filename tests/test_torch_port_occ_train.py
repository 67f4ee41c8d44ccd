"""The port's occupancy training (``--occ_train``'s step and the
``Trainer``'s grid switch) against the JAX package.

One JAX state, after two plain warm-up steps (so the coarse net carries
Adam moments), is carried over with ``train_state_from_jax``; one JAX grid
goes to both sides. Then three occupancy steps each, from
the trainer's per-step keys: JAX ``make_train_step(with_occupancy=True)``
(``pallas="off"``) and the port's (its kernels' plain versions on the
CPU). Tolerances as ``test_torch_port_train.py``'s: metrics rtol 1e-4; the
fine gradients (Adam's first moment) 1e-3 of each leaf's largest, or of
1e-2 of the net's largest where the leaf's own is smaller; fine params
1e-6 where the gradient is large enough to set the step's sign, 2·lr
anywhere. The coarse params are bitwise those of the start (and JAX's),
and the coarse moments, which decay with zero gradients, equal JAX's to
1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.data.synthetic import bench_scene as jax_bench_scene
from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.render import occupancy as jocc
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.train.loop import TrainConfig as JaxTrain
from cvnerf_tpu.train.loop import make_train_step as jax_make_train_step
from cvnerf_tpu.train.state import create_train_state as jax_create_state
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops import fused_mlp_bwd as fb
from cvnerf_torch.ops.rng import PRNGKey, fold_in
from cvnerf_torch.render.occupancy import OccupancyGrid
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train.loop import TrainConfig, Trainer, make_train_step
from cvnerf_torch.utils.convert import train_state_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
LR = 5e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny ops: one torch thread is as fast and leaves the cores to
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grid(g) -> OccupancyGrid:
    return OccupancyGrid(*(torch.from_numpy(np.array(x)) for x in g))


def _sphere_grid(res=12):
    """A JAX grid holding a ball of density in empty space (the fresh
    nets' own bake is empty at this seed: the step only needs a sampler)."""
    ax = np.linspace(-1.5, 1.5, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.where(x * x + y * y + z * z < 1.0, 20.0, 0.0).astype(np.float32)
    return jocc.OccupancyGrid(values=jnp.asarray(vals),
                              bbox_min=jnp.full((3,), -1.5, jnp.float32),
                              inv_spacing=jnp.full((3,), (res - 1) / 3.0,
                                                   jnp.float32))


CASES = {
    "merge": dict(),
    "full": dict(render=dict(occupancy_mode="full")),
    "full_floor": dict(render=dict(occupancy_mode="full", occ_floor=3,
                                   occupancy_interp="trilinear")),
    "merge_ema_distortion": dict(ema_decay=0.9, distortion_loss=0.01),
}


def _configs(extra):
    extra = dict(extra)
    rkw = dict(n_coarse=8, n_fine=8, perturb=True, noise_std=1.0,
               white_bkg=True, **extra.pop("render", {}))
    tkw = dict(height=32, width=32, focal=40.0, near=2.0, far=6.0, n_rays=64,
               lr=LR, lr_decay=1, **extra)
    return (JaxTrain(render=JaxRender(mlp=JaxCfg(**TINY), pallas="off", **rkw),
                     **tkw),
            TrainConfig(render=RenderConfig(mlp=NerfMLPConfig(**TINY), **rkw),
                        **tkw))


def _check_fine(jstate, tstate, step):
    jp, jm = _np(jstate.params["fine"]), _np(jstate.opt_state[0].mu["fine"])
    net_scale = max(np.abs(x).max() for x in jax.tree.leaves(jm))
    for layer in jp:
        for q in ("w", "b"):
            g = jm[layer][q]
            scale = max(np.abs(g).max(), 1e-30)
            gt = tstate.opt_state.mu["fine"][layer][q].numpy()
            assert np.abs(gt - g).max() / max(scale, 1e-2 * net_scale) <= 1e-3
            diff = np.abs(tstate.params["fine"][layer][q].numpy()
                          - jp[layer][q])
            assert diff.max() <= 2 * LR + 1e-7
            big = (np.abs(g) > (1e-4 if step == 1 else 0.1) * scale) \
                & (np.abs(g) > 1e-6)
            if big.any():
                assert diff[big].max() <= 1e-6 + (step - 1) * 1e-3 * LR


@pytest.mark.parametrize("extra", list(CASES.values()), ids=list(CASES))
def test_three_occupancy_steps_match_jax(extra):
    jcfg, tcfg = _configs(extra)
    images, poses = jax_bench_scene(32, 32)
    idx = np.array([0, 1])
    jdata = (jnp.asarray(images), jnp.asarray(poses), jnp.asarray(idx))
    tdata = (torch.from_numpy(images), torch.from_numpy(poses),
             torch.from_numpy(idx))
    jstate = jax_create_state(jax.random.PRNGKey(2), lr=LR, lr_decay=1,
                              mlp=JaxCfg(**TINY), ema=tcfg.ema_decay > 0)
    plain = jax_make_train_step(jcfg)
    for i in (1, 2):    # warm-up: the coarse net gets Adam moments
        jstate, _ = plain(jstate, jax.random.fold_in(jax.random.PRNGKey(0), i),
                          *jdata, precrop=False)
    jgrid = _sphere_grid()
    assert 0 < jocc.occupied_fraction(jgrid) < 1
    tstate = train_state_from_jax(_np(jstate))
    coarse0 = {k: {q: t.clone() for q, t in v.items()}
               for k, v in tstate.params["coarse"].items()}
    jstep = jax_make_train_step(jcfg, with_occupancy=True)
    tstep = make_train_step(tcfg, with_occupancy=True)
    grid = _grid(jgrid)
    for i in (3, 4, 5):
        jstate, jm = jstep(jstate, jgrid,
                           jax.random.fold_in(jax.random.PRNGKey(0), i),
                           *jdata, precrop=False)
        fwd, bwd = fm.fused_nerf_plain.calls, fb.fused_nerf_bwd_plain.calls
        tstate, tm = tstep(tstate, grid, fold_in(PRNGKey(0), i), *tdata,
                           False)
        # One net through the kernels' plain versions: 1 forward, 1 backward.
        assert (fm.fused_nerf_plain.calls - fwd,
                fb.fused_nerf_bwd_plain.calls - bwd) == (1, 1)
        for k in ("loss", "mse_fine", "psnr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert tstate.step == int(jstate.step) == i
        assert tstate.opt_state.count == int(jstate.opt_state[0].count) == i
        _check_fine(jstate, tstate, i - 2)
        jp = _np(jstate.params["coarse"])
        for layer, leaves in coarse0.items():
            for q, t in leaves.items():
                got = tstate.params["coarse"][layer][q]
                assert torch.equal(got, t)
                np.testing.assert_array_equal(got.numpy(), jp[layer][q])
                for mom in ("mu", "nu"):
                    want = np.asarray(getattr(jstate.opt_state[0],
                                              mom)["coarse"][layer][q])
                    assert np.abs(want).max() > 0
                    np.testing.assert_allclose(
                        getattr(tstate.opt_state, mom)["coarse"][layer][q]
                        .numpy(), want, rtol=1e-6, atol=0)
        if tcfg.ema_decay > 0:
            for net in ("coarse", "fine"):
                for layer, leaves in tstate.ema_params[net].items():
                    for q, t in leaves.items():
                        np.testing.assert_allclose(
                            t.numpy(),
                            np.asarray(jstate.ema_params[net][layer][q]),
                            rtol=0, atol=2 * LR + 1e-7)


def _trainer(tcfg):
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.train.state import create_train_state
    images, poses = bench_scene(32, 32)
    state = create_train_state(PRNGKey(1), lr=LR, mlp=NerfMLPConfig(**TINY),
                               device="cpu")
    return Trainer(tcfg, state, images, poses, [0, 1])


def test_maybe_set_occupancy_verdicts_and_the_switch():
    """The four verdicts of the empty-grid guard, and the trainer's steps
    through the installed grid: the coarse net stays as it was."""
    _, tcfg = _configs({})
    tr = _trainer(tcfg)
    empty = OccupancyGrid(torch.zeros(4, 4, 4), torch.full((3,), -1.5),
                          torch.full((3,), 1.0))
    full = OccupancyGrid(torch.ones(4, 4, 4), torch.full((3,), -1.5),
                         torch.full((3,), 1.0))
    assert tr.maybe_set_occupancy(empty) == "postponed"
    assert tr.occupancy is None
    tr.run(1, 3)
    assert tr.maybe_set_occupancy(full, occupied_frac=1.0) == "switched"
    assert tr.occupancy is full
    assert tr.maybe_set_occupancy(empty) == "kept"
    assert tr.occupancy is full
    assert tr.maybe_set_occupancy(full) == "rebaked"
    coarse = [t.clone() for v in tr.state.params["coarse"].values()
              for t in v.values()]
    fine = [t.clone() for v in tr.state.params["fine"].values()
            for t in v.values()]
    fwd, bwd = fm.fused_nerf_plain.calls, fb.fused_nerf_bwd_plain.calls
    m = tr.run(3, 6)
    assert (fm.fused_nerf_plain.calls - fwd,
            fb.fused_nerf_bwd_plain.calls - bwd) == (3, 3)
    assert np.isfinite(m["loss"]) and tr.state.step == 5
    assert all(torch.equal(a, b) for a, b in zip(
        coarse, [t for v in tr.state.params["coarse"].values()
                 for t in v.values()]))
    assert not all(torch.equal(a, b) for a, b in zip(
        fine, [t for v in tr.state.params["fine"].values()
               for t in v.values()]))


def test_occupancy_step_refuses_a_floor_past_the_budget():
    _, tcfg = _configs(dict(render=dict(occupancy_mode="full", occ_floor=8)))
    tr = _trainer(tcfg)
    tr.set_occupancy(OccupancyGrid(torch.ones(4, 4, 4), torch.full((3,), -1.5),
                                   torch.full((3,), 1.0)))
    with pytest.raises(ValueError, match="occ_floor=8 must be in"):
        tr.run(1, 2)
    assert dataclasses.replace(tcfg.render, occ_floor=7).occ_floor == 7
