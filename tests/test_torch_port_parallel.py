"""Ray-sharded data parallelism (``cvnerf_torch/parallel/mesh.py`` and its
callers) against the JAX package's, on the CPU.

The JAX side runs on its virtual 8-device CPU mesh (``tests/conftest.py``)
with its Pallas kernels off; the port on in-process meshes of CPU shards
(``make_mesh(devices=["cpu"] * k)``) and on gloo worlds of two
processes. The shapes are ``tests/test_sharding.py``'s and
``tests/test_multihost.py``'s: 16x16 images, 64-128 rays, 8 + 8 samples,
trunk 64, head 32. Tolerances:
  * sharded port step against the JAX sharded step: the single-device
    parity bounds (metrics rtol 1e-4, states through
    ``test_torch_port_train.py::_compare_states``);
  * sharded against unsharded, in the port: loss rtol 1e-4, params rtol
    1e-3, atol 1e-5 (``tests/test_sharding.py``);
  * ``fused_allreduce`` against per-leaf: loss rtol 1e-5, params rtol
    1e-4, atol 1e-6 (the JAX package pins no more than that);
  * frames, sharded against unsharded and against the JAX sharded render:
    rtol 1e-4, atol 1e-5 (``tests/test_sharded_render.py``);
  * two gloo processes: the same loss bitwise on both ranks, within rtol
    1e-5 of the in-process 2-shard mesh (``tests/test_multihost.py``).
Every subprocess waits at most 120 s and is killed on expiry; rendezvous
ports come from binding port 0.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cvnerf_tpu.parallel.mesh import replicated_sharding
from cvnerf_tpu.render.frames import render_image as jax_render_image
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.train.loop import TrainConfig as JaxTrain
from cvnerf_tpu.train.loop import make_train_step as jax_make_train_step
from cvnerf_tpu.train.state import create_train_state as jax_create_state
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey, fold_in
from cvnerf_torch.parallel.mesh import (RAY_AXIS, initialize_distributed,
                                        make_mesh, ray_sharding)
from cvnerf_torch.render.frames import render_image
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train import loop
from cvnerf_torch.train.loop import TrainConfig, Trainer, make_train_step
from cvnerf_torch.train.state import create_train_state
from cvnerf_torch.utils.convert import params_from_jax, train_state_from_jax
from cvnerf_torch.utils.tree import tree_leaves
from test_torch_port_train import _compare_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = dict(xyz_freqs=4, dir_freqs=2, trunk_width=64, head_width=32)
WAIT_S = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    """A TCP port free on this host now (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scene():
    rng = np.random.RandomState(0)
    images = rng.rand(2, 16, 16, 3).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    poses[:, 2, 3] = 4.0
    return images, poses


RKW = dict(n_coarse=8, n_fine=8, perturb=True, noise_std=1.0)
TKW = dict(height=16, width=16, focal=16.0, near=2.0, far=6.0, n_rays=128,
           lr=5e-4, lr_decay=250)


def _port_cfg(**extra) -> TrainConfig:
    return TrainConfig(render=RenderConfig(mlp=NerfMLPConfig(**MLP), **RKW),
                       **{**TKW, **extra})


def _port_run(mesh, steps=3, **extra):
    """``steps`` port steps from ``create_train_state(PRNGKey(0))`` with
    the keys ``fold_in(PRNGKey(1), i)``."""
    cfg = _port_cfg(**extra)
    images, poses = _scene()
    state = create_train_state(PRNGKey(0), lr=cfg.lr, lr_decay=cfg.lr_decay,
                               mlp=NerfMLPConfig(**MLP), device="cpu")
    step = make_train_step(cfg, mesh)
    metrics = None
    for i in range(steps):
        state, metrics = step(state, fold_in(PRNGKey(1), i),
                              torch.from_numpy(images),
                              torch.from_numpy(poses), torch.arange(2),
                              False)
    return state, {k: float(v) for k, v in metrics.items()}


def test_initialize_distributed_is_a_noop_and_make_mesh_spans_the_list(
        monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed(f"localhost:{free_port()}", device="cpu")
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis_names == (RAY_AXIS,)
    assert [s for s, _ in mesh.local_shards] == list(range(8))
    assert not mesh.distributed
    assert make_mesh(device="cpu").size == 1
    assert [ray_sharding(mesh).rows(128, s) for s in (0, 7)] == [
        slice(0, 16), slice(112, 128)]
    with pytest.raises(ValueError, match="equal shards"):
        ray_sharding(mesh).rows(100, 0)


@pytest.mark.parametrize("k,extra", [
    (2, {}), (4, dict(ray_batching=True, distortion_loss=0.01))],
    ids=["2-plain", "4-ray_batching-distortion"])
def test_sharded_step_matches_the_jax_sharded_step(k, extra):
    """Three steps on a k-shard CPU mesh, against JAX's
    ``make_train_step(cfg, make_mesh(jax.devices()[:k]))`` from the same
    state and keys: plain on 2 shards, and on 4 with ray batching and the
    distortion regularizer on (each JAX compile takes seconds here)."""
    images, poses = _scene()
    jcfg = JaxTrain(render=JaxRender(mlp=JaxCfg(**MLP), pallas="off", **RKW),
                    **TKW, **extra)
    jstate = jax_create_state(jax.random.PRNGKey(0), lr=jcfg.lr,
                              lr_decay=jcfg.lr_decay, mlp=JaxCfg(**MLP))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    jstep = jax_make_train_step(jcfg, jax_make_mesh(jax.devices()[:k]))
    tstep = make_train_step(_port_cfg(**extra),
                            make_mesh(devices=["cpu"] * k))
    for i in (1, 2, 3):
        jstate, jm = jstep(jstate, jax.random.fold_in(jax.random.PRNGKey(1),
                                                      i),
                           jnp.asarray(images), jnp.asarray(poses),
                           jnp.arange(2, dtype=jnp.int32), False)
        tstate, tm = tstep(tstate, fold_in(PRNGKey(1), i),
                           torch.from_numpy(images), torch.from_numpy(poses),
                           torch.arange(2), False)
        for key in ("loss", "mse_fine", "psnr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
        _compare_states(jstate, tstate, jcfg.lr, i)


def _close_to_unsharded(base, got, loss_rtol, rtol, atol):
    (s1, m1), (sk, mk) = base, got
    np.testing.assert_allclose(mk["loss"], m1["loss"], rtol=loss_rtol)
    for a, b in zip(tree_leaves(sk.params), tree_leaves(s1.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_step_matches_unsharded_and_splits_the_batch(k,
                                                             monkeypatch):
    """The port's k-shard step against its unsharded step
    (``tests/test_sharding.py``'s bounds), each shard rendering its own
    contiguous ``n_rays / k`` rows under their global ray ids
    (``test_ray_batch_actually_sharded``). The mutation guard: the same
    shards with their ray ids re-based to 0 (every shard drawing the same
    jitter and noise) fail the comparison."""
    seen = []
    render_rays = loop.render_rays

    def spy(*args, ray_ids, **kw):
        seen.append((int(ray_ids[0]), int(ray_ids[-1]), len(ray_ids)))
        return render_rays(*args, ray_ids=ray_ids, **kw)

    base = _port_run(None)
    monkeypatch.setattr(loop, "render_rays", spy)
    got = _port_run(make_mesh(devices=["cpu"] * k))
    m = 128 // k
    assert seen == [(s * m, s * m + m - 1, m) for s in range(k)] * 3
    _close_to_unsharded(base, got, 1e-4, 1e-3, 1e-5)

    def rebased(*args, ray_ids, **kw):
        return render_rays(*args, ray_ids=ray_ids - ray_ids[0], **kw)

    monkeypatch.setattr(loop, "render_rays", rebased)
    with pytest.raises(AssertionError):
        _close_to_unsharded(base, _port_run(make_mesh(devices=["cpu"] * k)),
                            1e-4, 1e-3, 1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_fused_allreduce_matches_per_leaf(k):
    mesh = make_mesh(devices=["cpu"] * k)
    _close_to_unsharded(_port_run(mesh), _port_run(mesh,
                                                   fused_allreduce=True),
                        1e-5, 1e-4, 1e-6)


def _frame_params():
    p = {"coarse": jax_init(jax.random.PRNGKey(0), JaxCfg(**MLP)),
         "fine": jax_init(jax.random.PRNGKey(1), JaxCfg(**MLP))}
    for net in p.values():   # some opacity, so the resample has structure
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
    return p, params_from_jax(jax.tree.map(np.asarray, p))


C2W = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 4.0]],
               np.float32)


def test_sharded_frame_matches_unsharded_and_jax():
    """``render_image`` on an 8-shard mesh against the unsharded frame and
    against the JAX sharded render (the stochastic resample on, as in
    ``tests/test_sharded_render.py``); a chunk that does not divide over
    the mesh is refused with the JAX message."""
    jp, tp = _frame_params()
    cfg = RenderConfig(n_coarse=8, n_fine=8, mlp=NerfMLPConfig(**MLP)
                       ).eval_mode()
    jcfg = JaxRender(n_coarse=8, n_fine=8, mlp=JaxCfg(**MLP), pallas="off"
                     ).eval_mode()
    mesh = make_mesh(devices=["cpu"] * 8)
    c2w = torch.from_numpy(C2W)
    single = render_image(tp, 16, 16, 16.0, c2w, 2.0, 6.0, cfg, chunk=128,
                          key=PRNGKey(2))
    sharded = render_image(tp, 16, 16, 16.0, c2w, 2.0, 6.0, cfg, chunk=128,
                           key=PRNGKey(2), mesh=mesh)
    jmesh = jax_make_mesh()
    want = jax_render_image(jax.random.PRNGKey(2),
                            jax.device_put(jp, replicated_sharding(jmesh)),
                            16, 16, 16.0, jnp.asarray(C2W), 2.0, 6.0, jcfg,
                            chunk=128, mesh=jmesh)
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(sharded[k].numpy(), single[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(sharded[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        render_image(tp, 8, 8, 8.0, c2w, 2.0, 6.0, cfg, chunk=100,
                     key=PRNGKey(0), mesh=mesh)


def test_nerf_renderer_use_mesh(tmp_path, monkeypatch):
    """``NerfRenderer(use_mesh=True)`` on a 2-shard mesh (``make_mesh``
    patched: this host has one CPU device) and ``use_mesh=<a 4-shard
    mesh>`` render the frame of ``use_mesh=False``, float and int8, with
    the nets and the grid replicated; a one-shard mesh is no mesh."""
    from cvnerf_torch import serve
    from cvnerf_torch.parallel.mesh import Replicated
    from cvnerf_torch.train.checkpoint import save_checkpoint
    state = create_train_state(PRNGKey(3), mlp=NerfMLPConfig(**MLP),
                               device="cpu")
    for net in state.params.values():
        net["alpha"]["b"] += 1.0
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, state)
    path = os.path.join(ckpt, "000000.pt")
    kw = dict(height=16, width=16, focal=16.0, near=2.0, far=6.0,
              cfg=RenderConfig(n_coarse=8, n_fine=8,
                               mlp=NerfMLPConfig(**MLP)),
              chunk=64, device="cpu")
    assert serve.NerfRenderer(path, **kw).mesh is None
    plain = serve.NerfRenderer(path, use_mesh=False, **kw)
    monkeypatch.setattr(serve, "make_mesh",
                        lambda device: make_mesh(devices=[device] * 2))
    meshed = serve.NerfRenderer(path, use_mesh=True, **kw)
    given = serve.NerfRenderer(path, use_mesh=make_mesh(
        devices=["cpu"] * 4), **kw)
    assert meshed.mesh.size == 2 and isinstance(meshed._nets, Replicated)
    assert given.mesh.size == 4
    for r in (plain, meshed, given):
        r.enable_occupancy(resolution=8)
    assert isinstance(meshed.occupancy, Replicated)
    for stage in ("float", "int8"):
        a = plain.render_pose_extras(C2W)
        for r in (meshed, given):
            b = r.render_pose_extras(C2W)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"{stage} {k}")
        for r in (plain, meshed, given):
            r.enable_int8(n_calib=2048)


_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
from cvnerf_torch.parallel.mesh import initialize_distributed, make_mesh
assert initialize_distributed(f"localhost:{port}", 2, pid, device="cpu")
try:
    initialize_distributed(f"localhost:{port}", 2, pid, device="cpu")
except RuntimeError as e:
    print("LIVE_GROUP_REFUSED", "already live" in str(e), flush=True)
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train.loop import TrainConfig, Trainer
from cvnerf_torch.train.state import create_train_state

mlp = NerfMLPConfig(xyz_freqs=4, dir_freqs=2, trunk_width=64, head_width=32)
cfg = TrainConfig(height=16, width=16, focal=16.0, near=2.0, far=6.0,
                  n_rays=64, lr=5e-4, lr_decay=250,
                  render=RenderConfig(n_coarse=8, n_fine=8, perturb=True,
                                      noise_std=1.0, mlp=mlp))
rng = np.random.RandomState(0)
images = rng.rand(2, 16, 16, 3).astype(np.float32)
poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
poses[:, 2, 3] = 4.0
state = create_train_state(PRNGKey(0), lr=cfg.lr, lr_decay=cfg.lr_decay,
                           mlp=mlp, device="cpu")
mesh = make_mesh(device="cpu")
assert mesh.distributed and mesh.size == 2 and mesh.first == pid
tr = Trainer(cfg, state, images, poses, [0, 1], seed=0, mesh=mesh)
m = tr.run(1, 4)
print(f"MULTIHOST_LOSS {pid} {m['loss']!r}", flush=True)
"""


def _spawn(code_or_args: list[str], n: int = 2) -> list[str]:
    """Run ``n`` worker processes (``python <args> <rank>``) and return
    their standard outputs; each waits at most WAIT_S seconds, a worker
    that fails or overruns fails the test, and none outlives it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO + os.pathsep + os.path.join(REPO, "tests")
    procs = [subprocess.Popen([sys.executable, *code_or_args, str(pid)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_process_train_matches_the_in_process_mesh():
    """The ``tests/test_multihost.py`` worker's three steps through
    ``Trainer(mesh=make_mesh())`` in a two-process gloo world: both ranks
    print the same loss bitwise, within rtol 1e-5 of the in-process
    2-shard mesh; ``initialize_distributed`` refuses a second world while
    one is live."""
    outs = _spawn(["-c", _WORKER, str(free_port())])
    losses = []
    for out in outs:
        assert "LIVE_GROUP_REFUSED True" in out, out
        line = [x for x in out.splitlines() if x.startswith("MULTIHOST")]
        assert line, out
        losses.append(float(line[0].split()[-1]))
    assert losses[0] == losses[1]
    images, poses = _scene()
    cfg = _port_cfg(n_rays=64)
    state = create_train_state(PRNGKey(0), lr=cfg.lr, lr_decay=cfg.lr_decay,
                               mlp=NerfMLPConfig(**MLP), device="cpu")
    tr = Trainer(cfg, state, images, poses, [0, 1], seed=0,
                 mesh=make_mesh(devices=["cpu"] * 2))
    np.testing.assert_allclose(losses[0], tr.run(1, 4)["loss"], rtol=1e-5)


CLI_FLAGS = [
    "--device", "cpu", "--no-bf16", "--dtype", "blender", "--white_bkg",
    "--testskip", "1", "--n_rays", "64", "--n_coarse_samples", "8",
    "--n_fine_samples", "8", "--trunk_width", "32", "--head_width", "16",
    "--xyz_freqs", "4", "--dir_freqs", "2", "--noise", "1.0",
    "--chunk", "128", "--print_freq", "1", "--vid_freq", "0",
    "--val_freq", "2", "--track_best", "--ckpt_freq", "0", "--lr", "5e-4",
    "--seed", "3"]

_CLI_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from cvnerf_torch import cli
argv, ports, pid = sys.argv[1:-3], sys.argv[-3:-1], sys.argv[-1]
for iters, port in zip(("5", "7"), ports):
    out = cli.main([*argv, "--iters", iters, "--coordinator",
                    f"localhost:{port}", "--num_processes", "2",
                    "--process_id", pid])
    print("CLI_RESULT", pid, iters, out["loss"], out["test_psnr"],
          flush=True)
"""


def test_two_process_cli_matches_the_single_process_cli(tmp_path):
    """``python -m cvnerf_torch.cli`` with ``--coordinator --num_processes
    2 --process_id {0,1}`` on the micro-fixture, validation and
    ``--track_best`` on (sharded frames, the best checkpoint read back by
    both ranks): only rank 0 writes (each step logged once), its step-4
    checkpoint matches the single-process run's within the parity bounds
    (``_compare_states``), and a resume to step 6 runs in the same world."""
    from cvnerf_torch import cli
    from cvnerf_torch.data.synthetic import make_blender_dataset
    from cvnerf_torch.train import checkpoint as tckpt
    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_train=4, n_val=1, n_test=1, h=24, w=24)

    def argv(name):
        logdir = str(tmp_path / name)
        return ["--data_dir", data, "--base_dir", logdir, "--save_dir",
                logdir, "--name", "p", *CLI_FLAGS]

    outs = _spawn(["-c", _CLI_WORKER, *argv("dist"), str(free_port()),
                   str(free_port())])
    results = [[x.split()[1:] for x in out.splitlines()
                if x.startswith("CLI_RESULT")] for out in outs]
    assert [len(r) for r in results] == [2, 2]
    assert [r[2:] for r in results[0]] == [r[2:] for r in results[1]]
    run = str(tmp_path / "dist" / "p")
    recs = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    steps = [r["step"] for r in recs if "lr" in r]
    assert steps == [1, 2, 3, 4, 5, 6], steps
    assert len([r for r in recs if "test_psnr" in r]) == 2
    ckpts = os.path.join(run, "torch_checkpoints")
    assert tckpt.latest_step(ckpts) == 6
    assert os.path.exists(os.path.join(run, "best.json"))

    cli.main([*argv("single"), "--iters", "5"])
    template = create_train_state(PRNGKey(0), mlp=NerfMLPConfig(
        xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16),
        device="cpu")
    two = tckpt.restore_checkpoint(ckpts, template, step=4)
    one = tckpt.restore_checkpoint(
        str(tmp_path / "single" / "p" / "torch_checkpoints"), template)
    assert one.step == two.step == 4

    def as_jax(st):
        np_tree = jax.tree.map(lambda t: t.numpy(), st.params)
        mu = jax.tree.map(lambda t: t.numpy(), st.opt_state.mu)
        return types.SimpleNamespace(params=np_tree, ema_params=None,
                                     opt_state=[types.SimpleNamespace(
                                         mu=mu)])
    _compare_states(as_jax(one), two, 5e-4, 4)
