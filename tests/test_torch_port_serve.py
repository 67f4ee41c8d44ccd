"""The port's ``NerfRenderer`` against JAX ``render_image``.

A temporary run directory holds a ``scene.json`` and a two-net ``.pt``
written by the JAX package's own ``torch_state_dict_from_params`` (the
layout ``cvnerf-import --export`` writes). Tolerances as in
``test_torch_port_render.py``: rgb/acc 1e-4, depth 1e-3.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import anneal_model_params
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.render.frames import render_image as jax_render_image
from cvnerf_tpu.render.frames import render_poses_to_frames as jax_render_frames
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_tpu.utils.convert import torch_state_dict_from_params
from cvnerf_torch.serve import NerfRenderer
from cvnerf_torch.utils import convert

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
POSE = np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4], [0, 0.6, 0.8, 3.2]],
                np.float32)
POSE2 = np.array([[0.8, 0, 0.6, 2.4], [0, 1, 0, 0.1], [-0.6, 0, 0.8, 3.2]],
                 np.float32)
KEYS = ("rgb", "rgb_coarse", "acc", "depth")


def _jax_params(seed=0):
    cfg = JaxCfg(**TINY)
    p = {"coarse": jax_init(jax.random.PRNGKey(seed), cfg),
         "fine": jax_init(jax.random.PRNGKey(seed + 1), cfg)}
    for net in p.values():
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
    return jax.tree.map(np.asarray, p)


def _write_pt(path, params, step):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"coarse": torch_state_dict_from_params(params["coarse"]),
                "fine": torch_state_dict_from_params(params["fine"]),
                "step": step}, path)


def _write_run(run, params, step=7, **extra):
    scene = {"height": 6, "width": 8, "focal": 7.0, "near": 2.0, "far": 6.0,
             "ndc": False, "ndc_variant": "canonical", "white_bkg": True,
             "n_coarse": 8, "n_fine": 16, "bf16": False,
             "sorted_resample": True, "pallas": "auto", "mlp": TINY, **extra}
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "scene.json"), "w") as fp:
        json.dump(scene, fp)
    _write_pt(os.path.join(run, "torch_checkpoints", f"{step:06d}.pt"),
              params, step)


def _jax_render(params, pose=POSE):
    cfg = JaxRender(n_coarse=8, n_fine=16, white_bkg=True,
                    mlp=JaxCfg(**TINY), pallas="off",
                    deterministic_resample=True).eval_mode()
    return jax_render_image(jax.random.PRNGKey(0), params, 6, 8, 7.0,
                            jnp.asarray(pose), 2.0, 6.0, cfg, chunk=16)


def _check(got, want):
    for k in KEYS:
        tol = 1e-3 if k == "depth" else 1e-4
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.fixture
def run_dir(tmp_path):
    params = _jax_params()
    run = str(tmp_path / "run")
    _write_run(run, params)
    return run, params


def test_from_run_dir_matches_jax_render_image(run_dir):
    run, params = run_dir
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    assert (r.step, r.which, r.height, r.width) == (7, "last", 6, 8)
    assert r.cfg.deterministic_resample and not r.cfg.perturb
    got = r.render_pose_extras(POSE, keys=KEYS)
    _check(got, _jax_render(params))
    np.testing.assert_array_equal(r.render_pose(POSE), got["rgb"])


def test_stochastic_serving_matches_jax(run_dir):
    """``deterministic=False`` serves the stochastic resample keyed by
    ``PRNGKey(seed)``, as the JAX renderer does: one pose renders as JAX
    ``render_image`` with that key, a pose sequence as JAX
    ``render_poses_to_frames`` (one split key per pose)."""
    run, params = run_dir
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu", seed=3,
                                  deterministic=False)
    assert not r.cfg.deterministic_resample and not r.cfg.perturb
    cfg = JaxRender(n_coarse=8, n_fine=16, white_bkg=True,
                    mlp=JaxCfg(**TINY), pallas="off").eval_mode()
    want = jax_render_image(jax.random.PRNGKey(3), params, 6, 8, 7.0,
                            jnp.asarray(POSE), 2.0, 6.0, cfg, chunk=16)
    _check(r.render_pose_extras(POSE, keys=KEYS), want)
    poses = np.stack([POSE, POSE2])
    want = jax_render_frames(jax.random.PRNGKey(3), params, poses, 6, 8, 7.0,
                             2.0, 6.0, cfg, chunk=16)
    np.testing.assert_allclose(r.render_video(poses), want, rtol=1e-4,
                               atol=1e-4)


def test_render_poses_extras_equals_separate_calls(run_dir):
    run, _ = run_dir
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    poses = np.stack([POSE, POSE2, POSE])
    batch = r.render_poses_extras(poses, keys=("rgb", "depth", "acc"))
    for i, pose in enumerate(poses):
        one = r.render_pose_extras(pose, keys=("rgb", "depth", "acc"))
        for k in one:
            np.testing.assert_array_equal(batch[k][i], one[k])
    rgb_only = r.render_poses_extras(poses[:2], factor=2)
    assert list(rgb_only) == ["rgb"] and rgb_only["rgb"].shape == (2, 3, 4, 3)
    video = r.render_video(poses[:2])
    np.testing.assert_array_equal(video, batch["rgb"][:2])


def test_mid_anneal_checkpoint_renders_as_jax_serves_it(tmp_path):
    """JAX serving windows the raw weights of a checkpoint inside the
    ``freq_anneal`` horizon; its exporter writes the .pt with that window
    already applied (``convert.py:223-248``), so the port must serve the
    .pt as is. Progress 6/20 leaves one band of each encoding partly open,
    so a second window would change the image."""
    raw = _jax_params(seed=4)
    windowed = jax.tree.map(np.asarray, anneal_model_params(
        raw, JaxCfg(**TINY), 6 / 20))
    run = str(tmp_path / "anneal")
    _write_run(run, windowed, step=6, freq_anneal=20)
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    _check(r.render_pose_extras(POSE, keys=KEYS), _jax_render(windowed))


def test_checkpoint_selection(tmp_path):
    old, new, best = _jax_params(0), _jax_params(2), _jax_params(6)
    run = str(tmp_path / "sel")
    _write_run(run, old, step=3)
    _write_pt(os.path.join(run, "torch_checkpoints", "000012.pt"), new, 12)
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    assert (r.step, r.which) == (12, "last")
    with pytest.raises(FileNotFoundError, match="best"):
        NerfRenderer.from_run_dir(run, device="cpu", which="best")
    _write_pt(os.path.join(run, "torch_checkpoints_best", "000009.pt"),
              best, 9)
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    assert (r.step, r.which) == (9, "best")
    _check(r.render_pose_extras(POSE, keys=KEYS), _jax_render(best))
    r = NerfRenderer.from_run_dir(run, device="cpu", which="last")
    assert r.step == 12
    os.remove(os.path.join(run, "torch_checkpoints", "000003.pt"))
    os.remove(os.path.join(run, "torch_checkpoints", "000012.pt"))
    with pytest.raises(FileNotFoundError, match="cvnerf-import --export"):
        NerfRenderer.from_run_dir(run, device="cpu", which="last")
    with pytest.raises(FileNotFoundError, match="scene.json"):
        NerfRenderer.from_run_dir(str(tmp_path), device="cpu")


def test_unported_and_unsupported_setups_raise(run_dir, tmp_path,
                                               monkeypatch):
    run, _ = run_dir
    r = NerfRenderer.from_run_dir(run, device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        r.enable_occupancy(mode="half")
    with pytest.raises(ValueError, match="interp must be"):
        r.enable_occupancy(interp="cubic")
    with pytest.raises(ValueError, match="architecture"):
        NerfRenderer(os.path.join(run, "torch_checkpoints", "000007.pt"),
                     height=6, width=8, focal=7.0, near=2.0, far=6.0,
                     device="cpu")   # the default (full-width) MLP
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NerfRenderer.from_run_dir(run)   # entry points default to CUDA


def test_checkpoint_conversion(tmp_path):
    params = _jax_params()
    path = str(tmp_path / "two.pt")
    _write_pt(path, params, 11)
    loaded, cfg, step = convert.load_torch_checkpoint(path)
    assert (cfg.trunk_width, cfg.head_width, cfg.xyz_freqs, cfg.dir_freqs,
            step) == (32, 16, 4, 2, 11)
    direct = convert.params_from_jax(params)
    for net in ("coarse", "fine"):
        for layer in direct[net]:
            for leaf in ("w", "b"):
                torch.testing.assert_close(loaded[net][layer][leaf],
                                           direct[net][layer][leaf],
                                           rtol=0, atol=0)
        sd = convert.torch_state_dict_from_params(direct[net])
        ref = torch_state_dict_from_params(params[net])
        assert sd.keys() == ref.keys()
        for k in sd:
            torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    single = str(tmp_path / "one.pt")
    torch.save(torch_state_dict_from_params(params["coarse"]), single)
    one, _, step = convert.load_torch_checkpoint(single)
    assert step is None and one["fine"] is one["coarse"]
    with pytest.raises(ValueError, match="unrecognized"):
        torch.save({"x": torch.zeros(1)}, single)
        convert.load_torch_checkpoint(single)


def test_from_run_dir_reads_calib_poses_for_int8(tmp_path):
    """``calib_poses`` in ``scene.json`` become the renderer's calibration
    camera set, the default of ``enable_int8``; the float master copy stays
    as loaded."""
    from cvnerf_torch.ops.fused_mlp_int8 import QuantizedNerfWeights
    params = _jax_params()
    run = str(tmp_path / "int8")
    _write_run(run, params, calib_poses=np.stack([POSE, POSE2]).tolist())
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    np.testing.assert_array_equal(r.calib_poses, np.stack([POSE, POSE2]))
    float_rgb = r.render_pose(POSE)
    a = r.enable_int8(n_calib=1024).render_pose(POSE)
    assert isinstance(r._nets["fine"], QuantizedNerfWeights)
    b = r.enable_int8(poses=np.stack([POSE, POSE2]),
                      n_calib=1024).render_pose(POSE)
    np.testing.assert_array_equal(a, b)   # the stored poses are the default
    assert np.isfinite(a).all() and np.abs(a - float_rgb).max() < 0.2
    assert r._float_params is r.params
    np.testing.assert_array_equal(r.params["fine"]["l1"]["w"].numpy(),
                                  params["fine"]["l1"]["w"])


def _jax_occ_render(params, grid, **change):
    import dataclasses
    cfg = dataclasses.replace(
        JaxRender(n_coarse=8, n_fine=16, white_bkg=True, mlp=JaxCfg(**TINY),
                  pallas="off", deterministic_resample=True).eval_mode(),
        **change)
    return jax_render_image(jax.random.PRNGKey(0), params, 6, 8, 7.0,
                            jnp.asarray(POSE), 2.0, 6.0, cfg, chunk=16,
                            occupancy=grid)


def _jax_grid(params, res, bound=1.5, net="fine"):
    from cvnerf_tpu.render.occupancy import bake_occupancy
    return bake_occupancy(params[net], JaxCfg(**TINY), (-bound,) * 3,
                          (bound,) * 3, resolution=res, pallas="off")


@pytest.mark.parametrize("record,change", [
    ({"resolution": 8, "bound": 1.5}, dict(occupancy_mode="full")),
    ({"resolution": 7, "bound": 1.2, "mode": "merge", "interp": "trilinear",
      "floor": 0}, dict(occupancy_interp="trilinear")),
    ({"resolution": 8, "bound": 1.5, "mode": "full", "interp": "nearest",
      "floor": 3}, dict(occupancy_mode="full", occ_floor=3))],
    ids=["legacy", "merge_trilinear", "full_floor"])
def test_occ_train_run_dir_serves_through_a_grid(tmp_path, record, change):
    """An ``occ_train`` run directory is served through a grid baked with
    its recorded resolution and bound, in its recorded mode, probe and
    floor (a legacy record: ``full``, nearest, no floor), as JAX
    ``from_run_dir`` serves it; the frame against JAX ``render_image``
    through the JAX bake of the same weights."""
    params = _jax_params()
    run = str(tmp_path / "occ")
    _write_run(run, params, occ_train=record)
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    assert r.occupancy is not None
    assert r.cfg.occupancy_mode == record.get("mode", "full")
    assert r.cfg.occupancy_interp == record.get("interp", "nearest")
    grid = _jax_grid(params, record["resolution"], record["bound"])
    np.testing.assert_allclose(r.occupancy.values.numpy(),
                               np.asarray(grid.values), rtol=1e-5, atol=1e-5)
    _check(r.render_pose_extras(POSE, keys=KEYS),
           _jax_occ_render(params, grid, **change))


def test_enable_occupancy_matches_jax_and_resets_the_budget(run_dir):
    """``enable_occupancy`` in merge, full and termination modes with
    reduced budgets, against the JAX renderer through the JAX bake; a
    re-enable without overrides restores the checkpoint's budget. The
    bake reads the float master copy, so it is the same after
    ``enable_int8``."""
    run, params = run_dir
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    grid = _jax_grid(params, 9)
    r.enable_occupancy(resolution=9)
    _check(r.render_pose_extras(POSE, keys=KEYS),
           _jax_occ_render(params, grid))
    r.enable_occupancy(resolution=9, mode="full", term=1e-3, n_coarse=6,
                       n_fine=10)
    assert (r.cfg.n_coarse, r.cfg.n_fine) == (6, 10)
    _check(r.render_pose_extras(POSE, keys=KEYS),
           _jax_occ_render(params, grid, occupancy_mode="full",
                           occupancy_termination=1e-3, n_coarse=6,
                           n_fine=10))
    before = r.occupancy.values.clone()
    r.enable_int8(n_calib=256)
    r.enable_occupancy(resolution=9)
    assert (r.cfg.n_coarse, r.cfg.n_fine, r.cfg.occupancy_termination) == (
        8, 16, 0.0)
    torch.testing.assert_close(r.occupancy.values, before, rtol=0, atol=0)
    out = r.render_pose_extras(POSE, keys=KEYS)
    assert np.isfinite(out["rgb"]).all() and out["rgb_coarse"] is not None


def test_an_empty_bake_serves_grid_less(tmp_path, capsys):
    """``require_occupied``: a bake with no positive density keeps the
    coarse net (JAX's warning) instead of installing an empty grid."""
    params = _jax_params()
    params["fine"]["alpha"]["b"] = params["fine"]["alpha"]["b"] - 100.0
    run = str(tmp_path / "empty")
    _write_run(run, params, occ_train={"resolution": 6, "bound": 1.5,
                                       "mode": "merge", "interp": "nearest",
                                       "floor": 0})
    r = NerfRenderer.from_run_dir(run, chunk=16, device="cpu")
    assert r.occupancy is None
    assert "occupancy bake found no positive density" in capsys.readouterr().out
    _check(r.render_pose_extras(POSE, keys=KEYS), _jax_render(params))


def test_scene_snapshot_occ_train_record_matches_jax(tmp_path):
    """``write_scene_snapshot`` writes JAX's ``occ_train`` record, and
    refuses one that does not name its mode or probe."""
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
    from cvnerf_torch.serve import write_scene_snapshot
    from cvnerf_tpu.serve import write_scene_snapshot as jax_write
    kw = dict(height=6, width=8, focal=7.0, near=2.0, far=6.0, ndc=False,
              ndc_variant="canonical", white_bkg=True, n_coarse=8, n_fine=16,
              bf16=True, occ_train=True, occ_res=64, occ_bound=1.2,
              occ_mode="full", occ_interp="trilinear", occ_floor=4)
    a = write_scene_snapshot(str(tmp_path / "a"), mlp=NerfMLPConfig(**TINY),
                             **kw)
    b = jax_write(str(tmp_path / "b"), mlp=JaxCfg(**TINY), **kw)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    for bad in (dict(occ_mode=None), dict(occ_interp="cubic")):
        with pytest.raises(ValueError, match="occ_train snapshots must"):
            write_scene_snapshot(str(tmp_path / "c"),
                                 mlp=NerfMLPConfig(**TINY), **{**kw, **bad})
