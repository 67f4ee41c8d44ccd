"""The port's checkpoints (``train/checkpoint.py``), run snapshot
(``serve.write_scene_snapshot``) and their serving.

Save then restore is bitwise (params, both Adam moments, count, step), and
so is a JAX ``TrainState`` carried over with ``train_state_from_jax``;
``scene.json`` is the JAX package's file key for key; a run directory the
port writes is served by ``load_torch_checkpoint`` and
``NerfRenderer.from_run_dir`` on the CPU with the saved weights, bitwise
(the renders of such weights are held to the JAX renderer in
``test_torch_port_serve.py``). An EMA run's checkpoints carry the Polyak
average, which resumes bitwise, is warm-started from a checkpoint without
one and is what ``restore_params`` and serving read; a raw checkpoint from
inside a ``freq_anneal`` horizon is served through the training-time
window. Both are held to the JAX renderer serving the same weights from
its own checkpoint (rgb 1e-5; depth 1e-4).
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.serve import NerfRenderer, latest_checkpoint
from cvnerf_torch.serve import write_scene_snapshot
from cvnerf_torch.train import checkpoint as ckpt
from cvnerf_torch.train.state import AdamState, TrainState, create_train_state
from cvnerf_torch.utils.convert import (load_torch_checkpoint,
                                        torch_state_dict_from_params,
                                        train_state_from_jax)
from cvnerf_torch.utils.tree import tree_leaves
from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.serve import write_scene_snapshot as jax_write_snapshot
from cvnerf_tpu.train.state import create_train_state as jax_create_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these runs are many tiny ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
MLP = NerfMLPConfig(**TINY)


def _state(seed=0, step=0):
    """A state whose moments are not zero, so a mix-up of mu and nu or of
    the leaves would show."""
    g = torch.Generator().manual_seed(seed)
    st = create_train_state(PRNGKey(seed), mlp=MLP, device="cpu")

    def rand(tree):
        return {k: rand(v) if isinstance(v, dict)
                else torch.randn(v.shape, generator=g)
                for k, v in tree.items()}
    return TrainState(params=st.params,
                      opt_state=AdamState(count=step, mu=rand(st.params),
                                          nu=rand(st.params)),
                      step=step)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert (a.ema_params is None) == (b.ema_params is None)
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    if a.ema_params is not None:
        pairs.append((a.ema_params, b.ema_params))
    for x, y in pairs:
        assert list(x) == list(y)
        for net in x:
            assert list(x[net]) == list(y[net])     # the leaf order too
        for u, v in zip(tree_leaves(x), tree_leaves(y)):
            assert u.dtype == v.dtype and u.device == v.device
            assert torch.equal(u, v)


def test_save_then_restore_is_bitwise(tmp_path):
    st = _state(1, step=7)
    ckpt.save_checkpoint(str(tmp_path), st)
    assert os.listdir(tmp_path) == ["000007.pt"]
    got = ckpt.restore_checkpoint(str(tmp_path), _state(2))
    _assert_states_equal(got, st)
    params, step = ckpt.restore_params(str(tmp_path))
    assert step == 7
    for u, v in zip(tree_leaves(params), tree_leaves(st.params)):
        assert torch.equal(u, v)


def test_the_file_is_plain_tensors_in_the_documented_layout(tmp_path):
    st = _state(3, step=4)
    ckpt.save_checkpoint(str(tmp_path), st)
    blob = torch.load(tmp_path / "000004.pt", weights_only=True)
    assert sorted(blob) == ["coarse", "fine", "opt_state", "raw_params",
                            "step"]
    assert blob["raw_params"] is True and blob["step"] == 4
    assert blob["opt_state"]["count"] == 4
    want = torch_state_dict_from_params(st.opt_state.nu["fine"])
    for k, v in want.items():
        assert torch.equal(blob["opt_state"]["nu"]["fine"][k], v)
    assert blob["coarse"]["l1.weight"].shape == (32, 3 + 6 * 4)


def test_restore_of_nothing_and_of_a_wrong_architecture(tmp_path):
    assert ckpt.restore_checkpoint(str(tmp_path / "none"), _state()) is None
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(str(tmp_path / "none"))
    ckpt.save_checkpoint(str(tmp_path), _state(step=3))
    wide = create_train_state(PRNGKey(0),
                              mlp=NerfMLPConfig(**{**TINY, "trunk_width": 64}),
                              device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), wide)
    with pytest.raises(FileNotFoundError, match="step 9"):
        ckpt.restore_checkpoint(str(tmp_path), _state(), step=9)


def test_same_step_is_benign_lower_step_raises_and_retention(tmp_path):
    d = str(tmp_path)
    with ckpt.Checkpointer(d, max_to_keep=2) as w:
        for step in (5, 10, 15):
            w.save(_state(step, step=step))
        w.save(_state(99, step=15))                  # a no-op
        with pytest.raises(RuntimeError, match="refusing to save step 12"):
            w.save(_state(step=12))
    assert ckpt.latest_step(d) == 15
    assert sorted(os.listdir(d)) == ["000010.pt", "000015.pt"]
    _assert_states_equal(ckpt.restore_checkpoint(d, _state()),
                         _state(15, step=15))
    with pytest.raises(ValueError):
        ckpt.Checkpointer(d, max_to_keep=0)


def test_no_partial_file_is_visible_while_a_save_is_in_flight(
        tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _state(step=1))
    started, release = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(obj, fp):
        fp.write(b"partial")          # half a file on disk under .tmp
        fp.flush()
        started.set()
        assert release.wait(30)
        fp.seek(0)
        fp.truncate()
        real_save(obj, fp)

    monkeypatch.setattr(ckpt.torch, "save", slow_save)
    w = ckpt.Checkpointer(d)
    try:
        w.save(_state(2, step=2))                  # returns at once
        assert started.wait(30)
        assert ckpt.latest_step(d) == 1
        assert latest_checkpoint(d) == os.path.join(d, "000001.pt")
        assert ckpt.restore_checkpoint(d, _state()).step == 1
        assert "000002.pt.tmp" in os.listdir(d)
    finally:
        release.set()
        w.close()
    monkeypatch.undo()
    assert sorted(os.listdir(d)) == ["000001.pt", "000002.pt"]
    _assert_states_equal(ckpt.restore_checkpoint(d, _state()),
                         _state(2, step=2))


def test_a_failed_write_raises_at_the_next_save(tmp_path, monkeypatch):
    def broken(obj, fp):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.torch, "save", broken)
    w = ckpt.Checkpointer(str(tmp_path))
    w.save(_state(step=1))
    with pytest.raises(OSError, match="disk full"):
        w.save(_state(step=2))
    w.close()


def test_a_params_only_file_is_refused_for_resume_and_still_served(
        tmp_path, capsys):
    st = _state(4, step=1000)
    run = tmp_path / "run"
    d = run / "torch_checkpoints"
    d.mkdir(parents=True)
    torch.save({k: torch_state_dict_from_params(v)
                for k, v in st.params.items()} | {"step": 1000},
               d / "001000.pt")
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.restore_checkpoint(str(d), _state())
    params, step = ckpt.restore_params(str(d))
    assert step == 1000
    _write_snapshot(str(run))
    r = NerfRenderer.from_run_dir(str(run), device="cpu")
    assert r.step == 1000
    for u, v in zip(tree_leaves(r.params), tree_leaves(st.params)):
        assert torch.equal(u, v)


def test_a_jax_state_survives_convert_save_restore(tmp_path):
    js = jax_create_state(jax.random.PRNGKey(5), mlp=JaxCfg(**TINY))
    js = jax.tree.map(np.asarray, js)
    ts = train_state_from_jax(js)
    ckpt.save_checkpoint(str(tmp_path), ts)
    got = ckpt.restore_checkpoint(str(tmp_path), _state())
    adam = js.opt_state[0]
    assert got.step == int(js.step) and got.opt_state.count == int(adam.count)
    for mine, theirs in ((got.params, js.params), (got.opt_state.mu, adam.mu),
                         (got.opt_state.nu, adam.nu)):
        for net in theirs:
            for layer in theirs[net]:
                for q in ("w", "b"):
                    np.testing.assert_array_equal(
                        mine[net][layer][q].numpy(), theirs[net][layer][q])


def _snapshot_kwargs(**over):
    poses = np.random.RandomState(0).randn(100, 3, 4).astype(np.float32)
    return {**dict(height=12, width=16, focal=20.0, near=2.0, far=6.0,
                   ndc=False, ndc_variant="canonical", white_bkg=True,
                   n_coarse=8, n_fine=8, bf16=False, sorted_resample=True,
                   pallas="auto", calib_poses=poses), **over}


def _write_snapshot(run, **over):
    write_scene_snapshot(run, mlp=MLP, **_snapshot_kwargs(**over))


@pytest.mark.parametrize("over", [
    {}, dict(calib_poses=None, bf16=True, pallas="off", ndc=True),
    dict(freq_anneal=40, ema_decay=0.999)],
    ids=["plain", "no_poses", "levers"])
def test_scene_snapshot_matches_jax(tmp_path, over):
    write_scene_snapshot(str(tmp_path / "t"), mlp=MLP,
                         **_snapshot_kwargs(**over))
    jax_write_snapshot(str(tmp_path / "j"), mlp=JaxCfg(**TINY),
                       **_snapshot_kwargs(**over))
    got = json.load(open(tmp_path / "t" / "scene.json"))
    want = json.load(open(tmp_path / "j" / "scene.json"))
    assert got == want
    if over.get("calib_poses", 0) is not None:
        assert len(got["calib_poses"]) == 64


def _write_snapshot_recording(run, **record):
    """A snapshot, then keys only a JAX run records (``freq_anneal``)."""
    _write_snapshot(run)
    path = os.path.join(run, "scene.json")
    snap = json.load(open(path))
    json.dump({**snap, **record}, open(path, "w"))


def _trained_run(tmp_path, steps=(10, 20), **record):
    run = str(tmp_path / "run")
    _write_snapshot_recording(run, **record)
    with ckpt.Checkpointer(os.path.join(run, "torch_checkpoints")) as w:
        for s in steps:
            w.save(_state(s, step=s))
    return run


def test_load_torch_checkpoint_and_from_run_dir_serve_a_written_run(
        tmp_path):
    run = _trained_run(tmp_path)
    params, cfg, step = load_torch_checkpoint(
        os.path.join(run, "torch_checkpoints", "000020.pt"))
    assert cfg == MLP and step == 20
    r = NerfRenderer.from_run_dir(run, device="cpu", chunk=64)
    assert r.step == 20 and r.which == "last"
    for u, v in zip(tree_leaves(r.params), tree_leaves(_state(20).params)):
        assert torch.equal(u, v)
    rgb = r.render_pose(np.eye(4, dtype=np.float32)[:3] + [[0, 0, 0, 0],
                                                          [0, 0, 0, 0],
                                                          [0, 0, 0, 4.0]])
    assert rgb.shape == (12, 16, 3) and np.isfinite(rgb).all()
    assert NerfRenderer.from_run_dir(run, device="cpu", step=10).step == 10
    with pytest.raises(FileNotFoundError, match="step 11"):
        NerfRenderer.from_run_dir(run, device="cpu", step=11)


@pytest.mark.parametrize("sorted_resample", [True, False])
def test_from_run_dir_keeps_the_recorded_resample(tmp_path, sorted_resample):
    """``scene.json``'s ``sorted_resample`` reaches the renderer (its
    stochastic resample draws the stream the run trained with)."""
    run = str(tmp_path / "run")
    _write_snapshot(run, sorted_resample=sorted_resample)
    with ckpt.Checkpointer(os.path.join(run, "torch_checkpoints")) as w:
        w.save(_state(step=10))
    r = NerfRenderer.from_run_dir(run, device="cpu", deterministic=False)
    assert r.cfg.sorted_resample is sorted_resample


def _jax_run(run, state: TrainState):
    """The same weights as a JAX package checkpoint under
    ``<run>/checkpoints`` (its serving reads it with the EMA slot)."""
    from cvnerf_tpu.train.checkpoint import save_checkpoint as jax_save

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else jax.numpy.asarray(
            v.numpy()) for k, v in t.items()}
    js = jax_create_state(jax.random.PRNGKey(0), mlp=JaxCfg(**TINY),
                          ema=state.ema_params is not None)
    js.params = tree(state.params)
    js.step = jax.numpy.asarray(state.step, jax.numpy.int32)
    if state.ema_params is not None:
        js.ema_params = tree(state.ema_params)
    jax_save(os.path.join(run, "checkpoints"), js)


def _frames_match_jax(run):
    """The port's ``from_run_dir`` frame against the JAX renderer's of the
    same run directory: rgb within 1e-5, depth 1e-4."""
    from cvnerf_tpu.serve import NerfRenderer as JaxRenderer
    r = NerfRenderer.from_run_dir(run, device="cpu", chunk=64)
    j = JaxRenderer.from_run_dir(run, chunk=64, use_mesh=False)
    assert r.step == j.step
    c2w = np.eye(4, dtype=np.float32)[:3] + [[0, 0, 0, 0], [0, 0, 0, 0],
                                              [0, 0, 0, 4.0]]
    got = r.render_pose_extras(c2w, keys=("rgb", "depth"))
    want = j.render_pose_extras(c2w, keys=("rgb", "depth"))
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               rtol=0, atol=1e-4)
    return r


def test_a_raw_mid_anneal_checkpoint_is_refused(tmp_path, capsys):
    """A checkpoint the port's trainer wrote (``raw_params``) from inside
    the run's ``freq_anneal`` horizon, once refused, is now served through
    the training-time window at ``step / freq_anneal``, in float32 before
    packing, as the JAX package serves its own raw checkpoint of the same
    weights."""
    from cvnerf_torch.models.nerf_mlp import anneal_model_params
    run = str(tmp_path / "run")
    _write_snapshot(run, freq_anneal=50)
    st = _state(11, step=10)
    with ckpt.Checkpointer(os.path.join(run, "torch_checkpoints")) as w:
        w.save(st)
    _jax_run(run, st)
    r = _frames_match_jax(run)
    assert "applying the training-time frequency window" in \
        capsys.readouterr().out
    want = anneal_model_params(st.params, MLP, 10 / 50)
    for u, v in zip(tree_leaves(r.params), tree_leaves(want)):
        assert torch.equal(u, v)
    assert any(not torch.equal(u, v) for u, v in zip(
        tree_leaves(r.params), tree_leaves(st.params)))


def _ema_state(seed, step):
    st = _state(seed, step=step)
    g = torch.Generator().manual_seed(seed + 100)
    st.ema_params = {k: {n: {q: t + 0.01 * torch.randn(t.shape, generator=g)
                             for q, t in lay.items()}
                         for n, lay in net.items()}
                     for k, net in st.params.items()}
    return st


def _ema_template():
    return create_train_state(PRNGKey(9), mlp=MLP,
                              device="cpu", ema=True)


def test_an_ema_checkpoint_resumes_bitwise(tmp_path):
    st = _ema_state(1, step=12)
    ckpt.save_checkpoint(str(tmp_path), st)
    blob = torch.load(tmp_path / "000012.pt", weights_only=True)
    assert sorted(blob) == ["coarse", "ema_params", "fine", "opt_state",
                            "raw_params", "step"]
    _assert_states_equal(ckpt.restore_checkpoint(str(tmp_path),
                                                 _ema_template()), st)


def test_a_pre_ema_checkpoint_warm_starts_the_average(tmp_path, capsys):
    """A run resumed with ``--ema_decay`` from a checkpoint without an
    average starts it at the restored params (a copy); a template without
    the slot drops a stored average, with the JAX package's warning."""
    plain = _state(2, step=5)
    ckpt.save_checkpoint(str(tmp_path / "plain"), plain)
    got = ckpt.restore_checkpoint(str(tmp_path / "plain"), _ema_template())
    for u, v in zip(tree_leaves(got.ema_params), tree_leaves(plain.params)):
        assert torch.equal(u, v)
    for u, v in zip(tree_leaves(got.ema_params), tree_leaves(got.params)):
        assert u.data_ptr() != v.data_ptr()
    ckpt.save_checkpoint(str(tmp_path / "ema"), _ema_state(3, step=6))
    capsys.readouterr()
    dropped = ckpt.restore_checkpoint(str(tmp_path / "ema"), _state())
    assert dropped.ema_params is None
    assert "carries an EMA average but this invocation disables " \
        "--ema_decay: dropping it" in capsys.readouterr().out


def test_restore_params_prefers_the_average(tmp_path):
    st = _ema_state(4, step=8)
    ckpt.save_checkpoint(str(tmp_path), st)
    for prefer, want in ((True, st.ema_params), (False, st.params)):
        got, step = ckpt.restore_params(str(tmp_path), prefer_ema=prefer)
        assert step == 8
        for u, v in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(u, v)
    got, _ = ckpt.restore_params(str(tmp_path))
    assert torch.equal(tree_leaves(got)[0], tree_leaves(st.ema_params)[0])
    params, _, step = load_torch_checkpoint(str(tmp_path / "000008.pt"))
    assert step == 8 and torch.equal(tree_leaves(params)[-1],
                                     tree_leaves(st.ema_params)[-1])


def test_serving_an_ema_run_serves_the_average(tmp_path):
    """``from_run_dir`` serves the Polyak average, as the JAX renderer
    serves the average of its own checkpoint of the same weights."""
    run = str(tmp_path / "run")
    _write_snapshot(run, ema_decay=0.999)
    st = _ema_state(5, step=20)
    with ckpt.Checkpointer(os.path.join(run, "torch_checkpoints")) as w:
        w.save(st)
    _jax_run(run, st)
    r = _frames_match_jax(run)
    for u, v in zip(tree_leaves(r.params), tree_leaves(st.ema_params)):
        assert torch.equal(u, v)


def test_a_raw_checkpoint_past_the_anneal_horizon_is_served(tmp_path):
    run = _trained_run(tmp_path, steps=(10, 60), freq_anneal=50)
    assert NerfRenderer.from_run_dir(run, device="cpu").step == 60


def test_an_exported_mid_anneal_checkpoint_is_served_as_exported(
        tmp_path, capsys):
    """A file with no ``raw_params`` marker (``cvnerf-import --export``
    applies the window) keeps being served as it is."""
    run = str(tmp_path / "run")
    _write_snapshot_recording(run, freq_anneal=50)
    d = os.path.join(run, "torch_checkpoints")
    os.makedirs(d)
    st = _state(6)
    torch.save({k: torch_state_dict_from_params(v)
                for k, v in st.params.items()} | {"step": 10},
               os.path.join(d, "000010.pt"))
    r = NerfRenderer.from_run_dir(run, device="cpu")
    assert r.step == 10
    assert "already carry the training-time frequency window" in \
        capsys.readouterr().out
    for u, v in zip(tree_leaves(r.params), tree_leaves(st.params)):
        assert torch.equal(u, v)
