"""The port's block dispatch (``train/loop.py::make_train_scan`` and the
``Trainer``'s ``steps_per_call``) against its own single steps and the JAX
package's ``make_train_scan``.

On the CPU a block runs the captured step's body ``block`` times without a
graph, through the same static buffers and tables, so it is compared
**bitwise** with the single steps (the JAX package's
``tests/test_train.py::test_scan_matches_single_step_bitwise``). Against
the JAX scan (``pallas="off"``, its kernels' oracle) the tolerances are
``test_torch_port_train.py``'s for its three-step match, here after four
steps: metrics rtol 1e-4; gradients (Adam's first moment) 1e-3 of the
leaf's largest, or of 1e-2 of the net's where the leaf's own is smaller,
at the third step, growing with the steps as the params bound does (the
moment after a fourth step on params that moved apart by up to 2·lr reads
1.05e-3 on the fine l6, a cancelled sum: 1.33e-3 after four); params
2·lr anywhere and, where the gradient is above 0.1 of its leaf's largest,
1e-6 plus 1e-2·lr for each step after the first: a gradient within 1e-3
of its leaf's largest is within 1e-2 of itself there, and Adam moves the
weight by that fraction of lr a step (the three-step match's 1e-3·lr a
step holds through its third step; a fourth reads 3.0e-2·lr over three
steps on a fine-l6 weight). A two-shard
in-process mesh is held to its unsharded block at
``tests/test_sharding.py``'s tolerances (loss rtol 1e-4, params rtol 1e-3
and atol 1e-5). A block with ``Tensor.item``, ``tolist``, ``__bool__``,
``__int__`` and ``__float__`` made to raise is the CPU's proxy for a block
that reads no device value on the host, as a CUDA graph's capture needs.
The test marked ``cuda`` holds a captured block to eager steps on the
card, and skips without one.
"""

import dataclasses
import os
import types

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
from cvnerf_tpu.train.loop import Trainer as JaxTrainer
from cvnerf_tpu.train.loop import make_train_scan as jax_make_train_scan
from cvnerf_tpu.train.state import create_train_state as jax_create_state
from cvnerf_torch import cli
from cvnerf_torch.data.synthetic import bench_scene, make_blender_dataset
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.parallel.mesh import make_mesh
from cvnerf_torch.render.occupancy import OccupancyGrid
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train import loop
from cvnerf_torch.train.loop import (ROW, TrainConfig, Trainer,
                                     make_train_scan, schedules, state_leaves,
                                     step_row)
from cvnerf_torch.train.state import (Adam, create_train_state,
                                      make_optimizer)
from cvnerf_torch.utils.convert import train_state_from_jax
from cvnerf_torch.utils.tree import tree_leaves

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


def _configs(extra, hw=32, n_rays=64):
    extra = dict(extra)
    rkw = dict(n_coarse=8, n_fine=8, perturb=True, noise_std=1.0,
               white_bkg=True, **extra.pop("render", {}))
    tkw = dict(height=hw, width=hw, focal=40.0, near=2.0, far=6.0,
               n_rays=n_rays, lr=LR, lr_decay=1, **extra)
    return (JaxTrain(render=JaxRender(mlp=JaxCfg(**TINY), pallas="off",
                                      **rkw), **tkw),
            TrainConfig(render=RenderConfig(mlp=NerfMLPConfig(**TINY), **rkw),
                        **tkw))


def _port_state(seed=1, ema=False):
    return create_train_state(PRNGKey(seed), lr=LR, lr_decay=1,
                              mlp=NerfMLPConfig(**TINY), device="cpu",
                              ema=ema)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# -- the Trainer: blocks against single steps ---------------------------------

TRAINER_CASES = {
    "plain": {},
    "levers": dict(ema_decay=0.9, noise_decay=6, freq_anneal=8,
                   distortion_loss=0.01, distortion_ramp=4,
                   occlusion_loss=0.01),
    "ray_batching": dict(ray_batching=True),
    "parity": dict(pixel_sampling="parity"),
}


@pytest.mark.parametrize("extra", list(TRAINER_CASES.values()),
                         ids=list(TRAINER_CASES))
def test_trainer_blocks_are_bitwise_single_steps(extra):
    """``Trainer(steps_per_call=4)`` is bitwise ``steps_per_call=1`` over
    steps 1-12 with ``precrop_iters=3`` and a callback every 5: the same
    fires, loss, params, moments, EMA slot, count and step. A 24x24 grid
    (576 pixels, a 12x12 crop) makes the Feistel draw walk its cycles; the
    schedules move inside the block."""
    _, cfg = _configs(dict(precrop_iters=3, **extra), hw=24, n_rays=32)
    images, poses = bench_scene(24, 24)

    def run(spc):
        tr = Trainer(cfg, _port_state(ema="ema_decay" in extra), images,
                     poses, [0, 1], seed=0, steps_per_call=spc)
        fired = []
        tr.add_callback(5, lambda i, t, m: fired.append(i))
        return tr, tr.run(1, 13), fired

    t1, m1, f1 = run(1)
    t4, m4, f4 = run(4)
    assert f1 == f4 == [5, 10]
    assert m1["loss"] == m4["loss"]
    _assert_states_equal(t1.state, t4.state)
    # Steps 6-9 are the one full block; the rest ran as single steps.
    assert t4.scan_fn.runner.stats["eager_steps"] == 4
    assert t1.scan_fn is None
    # The image indices and the base key live on the params' device.
    for t in (t4.train_idx, t4.base_key):
        assert t.device == tree_leaves(t4.state.params)[0].device
        assert t.dtype == torch.int64


def test_block_len_matches_jax():
    """``Trainer._block_len`` is the JAX ``Trainer``'s, over a grid of
    starts, ends, precrop lengths, block sizes and callback sets."""
    for spc in (1, 4, 10):
        for precrop in (0, 3, 10, 25):
            for every in ((), (5,), (10, 7), (3, 30), (1,)):
                cbs = [(e, None) for e in every]
                fake = types.SimpleNamespace(
                    steps_per_call=spc, callbacks=cbs,
                    cfg=types.SimpleNamespace(precrop_iters=precrop))
                for iters in (1, 2, 13, 40):
                    for i in range(1, iters):
                        assert Trainer._block_len(fake, i, iters) == \
                            JaxTrainer._block_len(fake, i, iters), (
                                spc, precrop, every, iters, i)


def test_step_rows_are_the_python_floats():
    """Each step's scalar row holds bitwise the float32 values the single
    step formed as Python floats: Adam's ``-lr(count)``, ``1 - b1^(k+1)``,
    ``1 - b2^(k+1)`` (float32 on the CPU) and the three schedules."""
    assert ROW == ("lr_step", "bc1", "bc2", "noise", "anneal", "dist")
    _, cfg = _configs(dict(noise_decay=50, freq_anneal=30,
                           distortion_start=5, distortion_ramp=20))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    for lr_decay in (1, 250):
        opt = make_optimizer(5e-4, lr_decay)
        assert isinstance(opt, Adam)
        for step, count in ((0, 0), (1, 1), (7, 3), (29, 29), (100, 1000),
                            (123_456, 123_456)):
            row = step_row(cfg, opt, step, count)
            assert row.dtype == np.float32 and row.shape == (len(ROW),)
            want = [-float(opt.learning_rate(count)),
                    float(1 - f32(opt.b1) ** (count + 1)),
                    float(1 - f32(opt.b2) ** (count + 1)),
                    *schedules(cfg, step)]
            assert [float(v) for v in row] == want, (step, count)


@pytest.mark.parametrize("case", ["plain", "ray_batching", "parity",
                                  "precrop_replace", "levers", "occupancy"])
def test_a_block_reads_no_device_value_on_the_host(case, monkeypatch):
    """A block with ``item``, ``tolist``, ``__bool__``, ``__int__`` and
    ``__float__`` raising (every way a step could read a tensor's value on
    the host, each a sync under a graph's capture) runs and equals the
    same block run normally."""
    extra = {"plain": {}, "ray_batching": dict(ray_batching=True),
             "parity": dict(pixel_sampling="parity"),
             "precrop_replace": dict(pixel_sampling="replace",
                                     precrop_iters=10),
             "levers": dict(ema_decay=0.9, noise_decay=6, freq_anneal=8,
                            distortion_loss=0.01, distortion_ramp=4,
                            occlusion_loss=0.01),
             "occupancy": dict(render=dict(occupancy_mode="full",
                                           occ_floor=2,
                                           occupancy_interp="trilinear"))
             }[case]
    _, cfg = _configs(extra, hw=24, n_rays=32)
    images, poses = (torch.from_numpy(a) for a in bench_scene(24, 24))
    idx = torch.tensor([0, 1])
    occ = case == "occupancy"
    grid = _grid(_sphere_grid()) if occ else None
    precrop = "precrop_iters" in extra

    def block():
        scan = make_train_scan(cfg, 3, with_occupancy=occ)
        state = _port_state(ema="ema_decay" in extra)
        args = (PRNGKey(4), images, poses, idx, 1, precrop)
        return scan(state, grid, *args) if occ else scan(state, *args)

    want_state, want_m = block()

    def refuse(*_a, **_k):
        raise AssertionError("a block read a tensor's value on the host")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got_state, got_m = block()
    monkeypatch.undo()
    _assert_states_equal(got_state, want_state)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k])


# -- against the JAX scan ---------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grid(g) -> OccupancyGrid:
    return OccupancyGrid(*(torch.from_numpy(np.array(x)) for x in g))


def _sphere_grid(res=12):
    """A JAX grid holding a ball of density in empty space."""
    ax = np.linspace(-1.5, 1.5, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.where(x * x + y * y + z * z < 1.0, 20.0, 0.0).astype(np.float32)
    return jocc.OccupancyGrid(values=jnp.asarray(vals),
                              bbox_min=jnp.full((3,), -1.5, jnp.float32),
                              inv_spacing=jnp.full((3,), (res - 1) / 3.0,
                                                   jnp.float32))


def _compare_states(jstate, tstate, steps):
    jp, jm = _np(jstate.params), _np(jstate.opt_state[0].mu)
    for net in jp:
        net_scale = max(np.abs(x).max() for x in jax.tree.leaves(jm[net]))
        for layer in jp[net]:
            for q in ("w", "b"):
                g = jm[net][layer][q]
                scale = max(np.abs(g).max(), 1e-30)
                gt = tstate.opt_state.mu[net][layer][q].numpy()
                assert np.abs(gt - g).max() / max(scale, 1e-2 * net_scale) \
                    <= 1e-3 * steps / 3, (net, layer, q)
                big = (np.abs(g) > 0.1 * scale) & (np.abs(g) > 1e-6)
                pairs = [(tstate.params, jstate.params)]
                if jstate.ema_params is not None:
                    pairs.append((tstate.ema_params, jstate.ema_params))
                for t, j in pairs:
                    diff = np.abs(t[net][layer][q].numpy()
                                  - np.asarray(j[net][layer][q]))
                    assert diff.max() <= 2 * LR + 1e-7, (net, layer, q)
                    if big.any():
                        assert diff[big].max() <= (
                            1e-6 + (steps - 1) * 1e-2 * LR), (net, layer, q)
    assert (jstate.ema_params is None) == (tstate.ema_params is None)


SCAN_CASES = {
    "plain": {},
    "ema": dict(ema_decay=0.9),
    "anneal_distortion": dict(freq_anneal=4, distortion_loss=0.01),
    "occupancy": dict(render=dict(occupancy_mode="merge")),
}


@pytest.mark.parametrize("extra", list(SCAN_CASES.values()),
                         ids=list(SCAN_CASES))
def test_scan_matches_the_jax_scan(extra):
    """``make_train_scan(cfg, 4)`` from one JAX state (carried over with
    ``train_state_from_jax``), one base key and one fixture: the JAX block
    and the port's, their last metrics and their states (the occupancy
    case through one baked grid, its coarse net unchanged)."""
    jcfg, tcfg = _configs(extra)
    occ = "render" in extra
    images, poses = jax_bench_scene(32, 32)
    idx = np.array([0, 1])
    jstate = jax_create_state(jax.random.PRNGKey(2), lr=LR, lr_decay=1,
                              mlp=JaxCfg(**TINY),
                              ema=bool(extra.get("ema_decay")))
    tstate = train_state_from_jax(_np(jstate))
    jscan = jax_make_train_scan(jcfg, 4, with_occupancy=occ)
    tscan = make_train_scan(tcfg, 4, with_occupancy=occ)
    jdata = (jax.random.PRNGKey(3), jnp.asarray(images), jnp.asarray(poses),
             jnp.asarray(idx), jnp.int32(1), False)
    tdata = (PRNGKey(3), torch.from_numpy(images), torch.from_numpy(poses),
             torch.from_numpy(idx), 1, False)
    coarse0 = [t.clone() for t in tree_leaves(tstate.params["coarse"])]
    if occ:
        jgrid = _sphere_grid()
        jstate, jm = jscan(jstate, jgrid, *jdata)
        tstate, tm = tscan(tstate, _grid(jgrid), *tdata)
        for a, b in zip(tree_leaves(tstate.params["coarse"]), coarse0):
            assert torch.equal(a, b)
    else:
        jstate, jm = jscan(jstate, *jdata)
        tstate, tm = tscan(tstate, *tdata)
    for k in ("loss", "mse_fine", "psnr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert tstate.step == int(jstate.step) == 4
    assert tstate.opt_state.count == int(jstate.opt_state[0].count) == 4
    _compare_states(jstate, tstate, 4)


def test_sharded_scan_matches_its_unsharded_block():
    """A two-shard in-process CPU mesh runs the same block as no mesh, to
    ``tests/test_sharding.py``'s tolerances (the shards' sums split)."""
    _, cfg = _configs({})
    images, poses = (torch.from_numpy(a) for a in bench_scene(32, 32))
    idx = torch.tensor([0, 1])
    out = {}
    for name, mesh in (("one", None), ("two", make_mesh(["cpu"] * 2))):
        scan = make_train_scan(cfg, 4, mesh)
        out[name] = scan(_port_state(), PRNGKey(3), images, poses, idx, 1,
                         False)
    (s1, m1), (s2, m2) = out["one"], out["two"]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
    assert s2.step == 4 and s2.opt_state.count == 4


def test_scan_buffers_follow_the_state_it_is_given():
    """The returned state holds the scan's buffers; a block from it runs in
    place, and a block from any other state copies that state in first
    (two blocks equal eight single steps; a restart from the fresh state
    repeats the first block)."""
    _, cfg = _configs({})
    images, poses = (torch.from_numpy(a) for a in bench_scene(32, 32))
    data = (images, poses, torch.tensor([0, 1]))
    scan = make_train_scan(cfg, 4)
    s1, _ = scan(_port_state(), PRNGKey(3), *data, 1, False)
    s2, m2 = scan(s1, PRNGKey(3), *data, 5, False)
    assert state_leaves(s2)[0] is state_leaves(s1)[0]
    step = loop.make_train_step(cfg)
    ref = _port_state()
    for i in range(1, 9):
        ref, m = step(ref, loop.fold_in(PRNGKey(3), i), *data, False)
    _assert_states_equal(s2, ref)
    assert torch.equal(m["loss"], m2["loss"])
    again, _ = scan(_port_state(), PRNGKey(3), *data, 1, False)
    first = _port_state()
    for i in range(1, 5):
        first, _ = step(first, loop.fold_in(PRNGKey(3), i), *data, False)
    _assert_states_equal(again, first)


def test_a_rebake_refreshes_the_installed_grid_in_place():
    """``Trainer.set_occupancy`` installs the first grid as given, copies a
    grid of the same resolution into it (a captured block keeps reading
    its tensors), and replaces it with a grid of another size."""
    _, cfg = _configs({})
    tr = Trainer(cfg, _port_state(), *bench_scene(32, 32), [0, 1],
                 steps_per_call=4)
    g1, g2 = _grid(_sphere_grid()), _grid(_sphere_grid())
    g2.values.mul_(0.5)
    values = g1.values.clone()
    assert tr.maybe_set_occupancy(g1) == "switched"
    assert tr.occupancy is g1 and tr._scan_fn_occ is not None
    data = [t.data_ptr() for t in (g1.values, g1.bbox_min, g1.inv_spacing)]
    assert tr.maybe_set_occupancy(g2) == "rebaked"
    assert tr.occupancy is g1 and data == [
        t.data_ptr() for t in (g1.values, g1.bbox_min, g1.inv_spacing)]
    assert torch.equal(g1.values, g2.values)
    assert not torch.equal(g1.values, values)
    installed = tr.occupancy
    tr.set_occupancy(_grid(_sphere_grid(10)))
    assert tr.occupancy is not installed
    assert tr.occupancy.values.shape == (10, 10, 10)


def test_blocks_follow_a_grid_of_another_resolution():
    """A rebake at another resolution replaces the installed grid between
    blocks: the blocks after it are bitwise the single steps through the
    new grid, and a graph's signature tells a tensor of another shape at
    the same address apart (the graph would index the old layout)."""
    _, cfg = _configs({})
    images, poses = bench_scene(32, 32)

    def run(spc):
        tr = Trainer(cfg, _port_state(), images, poses, [0, 1],
                     steps_per_call=spc)
        tr.set_occupancy(_grid(_sphere_grid(12)))

        def rebake(i, t, m):
            if i == 4:
                t.set_occupancy(_grid(_sphere_grid(10)))
        tr.add_callback(4, rebake)
        tr.run(1, 13)
        return tr

    single, blocks = run(1), run(4)
    assert blocks.occupancy.values.shape == (10, 10, 10)
    assert blocks._scan_fn_occ.runner.stats["eager_steps"] == 12
    _assert_states_equal(single.state, blocks.state)
    home = torch.device("cpu")
    g = _grid(_sphere_grid(12))
    part = dataclasses.replace(g, values=g.values[:10, :10, :10])
    assert part.values.data_ptr() == g.values.data_ptr()
    data = (torch.zeros(2, 4, 4, 3), torch.zeros(2, 3, 4),
            torch.tensor([0, 1]))
    assert loop._graph_sig(home, g, *data) != loop._graph_sig(home, part,
                                                              *data)
    assert loop._graph_sig(home, g, *data) == loop._graph_sig(home, g, *data)


def test_cli_blocks_are_bitwise_single_steps(tmp_path, capsys):
    """``python -m cvnerf_torch.cli --steps_per_call 4`` writes the same
    checkpoint as ``--steps_per_call 1`` (blocks 1-4 and 6-9 run through
    the scan, the rest as single steps), and the CLI no longer calls the
    flag without effect."""
    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_train=4, n_val=1, n_test=1, h=24, w=24)
    logs = str(tmp_path / "logs")
    flags = ["--data_dir", data, "--base_dir", logs, "--save_dir", logs,
             "--device", "cpu", "--no-bf16", "--dtype", "blender",
             "--white_bkg", "--testskip", "1", "--n_rays", "32",
             "--n_coarse_samples", "8", "--n_fine_samples", "8",
             "--trunk_width", "32", "--head_width", "16", "--xyz_freqs", "4",
             "--dir_freqs", "2", "--noise", "1.0", "--chunk", "256",
             "--print_freq", "5", "--vid_freq", "0", "--val_freq", "0",
             "--ckpt_freq", "10", "--iters", "11", "--lr", "5e-3"]
    ckpts = {}
    calls = []
    orig = loop.make_train_scan

    def spy(*a, **kw):
        fn = orig(*a, **kw)
        calls.append(fn)
        return fn
    loop.make_train_scan = spy
    try:
        for spc in ("1", "4"):
            cli.main([*flags, "--name", f"spc{spc}", "--steps_per_call",
                      spc])
            ckpts[spc] = torch.load(os.path.join(
                logs, f"spc{spc}", "torch_checkpoints", "000010.pt"),
                weights_only=True)
    finally:
        loop.make_train_scan = orig
    assert "steps_per_call" not in capsys.readouterr().out
    assert [c.runner.stats["eager_steps"] for c in calls] == [8]

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif torch.is_tensor(a):
            assert torch.equal(a, b), path
        else:
            assert a == b, path
    walk(ckpts["1"], ckpts["4"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_blocks_are_bitwise_eager_steps_on_card(cuda_device):
    """On the card a block is graph replays: bitwise the same steps run
    one by one, across the precrop switch and a callback."""
    _, cfg = _configs(dict(precrop_iters=6, ema_decay=0.9, freq_anneal=8),
                      hw=24, n_rays=32)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, compute_dtype=torch.bfloat16))
    images, poses = bench_scene(24, 24)

    def run(spc):
        state = create_train_state(PRNGKey(1), lr=LR, lr_decay=1,
                                   mlp=NerfMLPConfig(**TINY),
                                   device=cuda_device, ema=True)
        tr = Trainer(cfg, state, images, poses, [0, 1], steps_per_call=spc)
        tr.add_callback(7, lambda i, t, m: None)
        tr.run(1, 20)
        return tr

    eager, graphed = run(1), run(4)
    assert graphed.scan_fn.runner.stats["replayed_steps"] > 0
    # The precrop graph's pool goes once a block without precrop runs.
    assert list(graphed.scan_fn.runner._graphs) == [False]
    _assert_states_equal(eager.state, graphed.state)
