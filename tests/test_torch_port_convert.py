"""The port's checkpoint converter (``python -m cvnerf_torch.utils.convert``)
against the JAX package's (``cvnerf-import``): every case of
``tests/test_convert.py``.

Import reads the reference's ``.pt`` layouts into params equal bit for bit
to the JAX importer's and writes the port's own full checkpoint (params,
a fresh Adam state, the stamped step), equal to the JAX importer's orbax
state read back through JAX's restore; export writes the tensors the JAX
exporter writes for the same params, windowed alike inside a
``freq_anneal`` horizon. The imported run renders and fine-tunes through
the port's CLI.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.train.checkpoint import restore_checkpoint as jax_restore
from cvnerf_tpu.train.checkpoint import save_checkpoint as jax_save
from cvnerf_tpu.train.state import TrainState as JaxState
from cvnerf_tpu.train.state import create_train_state as jax_create_state
from cvnerf_tpu.utils import convert as jconv
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, apply_nerf
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.serve import NerfRenderer, write_scene_snapshot
from cvnerf_torch.train import checkpoint as tckpt
from cvnerf_torch.train.state import create_train_state
from cvnerf_torch.utils import convert as tconv
from cvnerf_torch.utils.tree import tree_leaves
from test_torch_parity import _TorchReferenceModel, _torch_freq_embed

TINY = dict(xyz_dim=3 + 6 * 4, dir_dim=3 + 6 * 2, w=32, h=16)
TINY_CFG = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)
C2W = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 4.0]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_model(seed=0, **kw):
    torch.manual_seed(seed)
    return _TorchReferenceModel(**kw)


def _same_params(port: dict, want: dict) -> None:
    """Port params (tensors) equal to JAX-side params (arrays), bitwise."""
    for net, layers in want.items():
        for layer, leaves in layers.items():
            for q, w in leaves.items():
                np.testing.assert_array_equal(
                    port[net][layer][q].numpy(), np.asarray(w),
                    err_msg=f"{net}.{layer}.{q}")


@pytest.mark.parametrize("kw", [{}, TINY], ids=["reference", "tiny"])
def test_state_dict_import_matches_the_jax_importer_and_torch(kw):
    """Weights born in torch: the port reads the JAX importer's params
    bitwise and the inferred widths, and its MLP reproduces the torch
    model's forward."""
    model = _torch_model(**kw)
    params, cfg = tconv.params_from_torch_state_dict(model.state_dict())
    jparams, jcfg = jconv.params_from_torch_state_dict(model.state_dict())
    assert (cfg.xyz_freqs, cfg.dir_freqs, cfg.trunk_width,
            cfg.head_width) == (jcfg.xyz_freqs, jcfg.dir_freqs,
                                jcfg.trunk_width, jcfg.head_width)
    assert (cfg.xyz_freqs, cfg.trunk_width) == ((10, 256) if not kw
                                                else (4, 32))
    _same_params({"n": params}, {"n": jparams})
    rng = np.random.RandomState(3)
    pts = torch.from_numpy(rng.randn(32, 3).astype(np.float32))
    dirs = torch.from_numpy(rng.randn(32, 3).astype(np.float32))
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    ours = apply_nerf(params, freq_encode(pts, cfg.xyz_freqs),
                      freq_encode(dirs, cfg.dir_freqs), cfg)
    with torch.no_grad():
        theirs = model(torch.cat([_torch_freq_embed(pts, cfg.xyz_freqs),
                                  _torch_freq_embed(dirs, cfg.dir_freqs)],
                                 -1))
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("keys", [("coarse", "fine"),
                                  ("model", "model_fine"),
                                  ("network_fn", "network_fine"),
                                  (None, None)],
                         ids=["coarse", "model", "network_fn", "bare"])
def test_checkpoint_layouts_match_the_jax_loader(tmp_path, keys):
    """Two-net layouts keep their nets apart; a bare state_dict serves as
    both nets; each equal to the JAX loader's."""
    ck, fk = keys
    path = str(tmp_path / "ref.pt")
    if ck is None:
        torch.save(_torch_model(0, **TINY).state_dict(), path)
    else:
        torch.save({ck: _torch_model(0, **TINY).state_dict(),
                    fk: _torch_model(1, **TINY).state_dict(),
                    "global_step": 2499}, path)
    params, cfg, step = tconv.load_torch_checkpoint(path)
    jparams, jcfg = jconv.load_torch_checkpoint(path)
    _same_params(params, jparams)
    assert cfg == NerfMLPConfig(**TINY_CFG) and step is None
    same = torch.equal(params["coarse"]["l1"]["w"], params["fine"]["l1"]["w"])
    assert same == (ck is None)


def test_missing_layer_is_a_clear_error():
    sd = _torch_model(0, **TINY).state_dict()
    del sd["l_alpha.weight"]
    for load in (tconv.params_from_torch_state_dict,
                 jconv.params_from_torch_state_dict):
        with pytest.raises(KeyError, match="l_alpha.weight"):
            load(sd)


def test_import_rejects_full_pickle_without_flag(tmp_path):
    """A file that pickled a live ``nn.Module`` is refused without
    ``--allow_pickle`` (its pickle code would run), as the JAX importer
    refuses it; with the flag it imports."""
    path = str(tmp_path / "module.pt")
    torch.save({"coarse": _torch_model(0, **TINY)}, path)
    with pytest.raises(ValueError, match="allow_pickle"):
        tconv.load_torch_checkpoint(path)
    with pytest.raises(ValueError, match="allow_pickle"):
        tconv.main([path, str(tmp_path / "refused")])
    assert not os.path.exists(tmp_path / "refused")
    params, _, _ = tconv.load_torch_checkpoint(path, allow_pickle=True)
    jparams, _ = jconv.load_torch_checkpoint(path, allow_pickle=True)
    _same_params(params, jparams)
    tconv.main([path, str(tmp_path / "run"), "--allow_pickle"])
    assert tckpt.latest_step(str(tmp_path / "run" / "torch_checkpoints")) == 0


def test_imported_state_equals_the_jax_importers(tmp_path):
    """The port's imported checkpoint, restored, equals the JAX importer's
    orbax state read back through JAX's restore: params, Adam moments,
    count and step."""
    path = str(tmp_path / "ref.pt")
    torch.save({"coarse": _torch_model(0, **TINY).state_dict(),
                "fine": _torch_model(1, **TINY).state_dict()}, path)
    cfg = tconv.import_torch_checkpoint(path, str(tmp_path / "t"), step=2499)
    jcfg = jconv.import_torch_checkpoint(path, str(tmp_path / "j"),
                                         step=2499)
    assert cfg == NerfMLPConfig(**TINY_CFG) and jcfg == JaxCfg(**TINY_CFG)
    got = tckpt.restore_checkpoint(
        str(tmp_path / "t" / "torch_checkpoints"),
        create_train_state(PRNGKey(1), mlp=cfg, device="cpu"))
    want = jax_restore(str(tmp_path / "j" / "checkpoints"),
                       jax_create_state(jax.random.PRNGKey(1), mlp=jcfg))
    assert got.step == int(want.step) == 2499
    adam = want.opt_state[0]
    assert got.opt_state.count == int(adam.count) == 0
    _same_params(got.params, want.params)
    _same_params(got.opt_state.mu, adam.mu)
    _same_params(got.opt_state.nu, adam.nu)


def test_import_cli_geometry_to_scene_json(tmp_path, capsys):
    """With all five geometry flags both importers write the same
    ``scene.json`` and the run serves from it; with only some of them both
    warn and write none."""
    path = str(tmp_path / "ref.pt")
    torch.save(_torch_model(0, **TINY).state_dict(), path)
    geo = ["--step", "7", "--height", "8", "--width", "8", "--focal", "10",
           "--near", "2", "--far", "6", "--n_coarse_samples", "4",
           "--n_fine_samples", "4"]
    tconv.main([path, str(tmp_path / "t"), *geo])
    jconv.main([path, str(tmp_path / "j"), *geo])
    assert json.load(open(tmp_path / "t" / "scene.json")) == json.load(
        open(tmp_path / "j" / "scene.json"))
    r = NerfRenderer.from_run_dir(str(tmp_path / "t"), chunk=64,
                                  device="cpu")
    assert r.step == 7 and (r.height, r.width) == (8, 8)
    assert r.cfg.mlp.trunk_width == 32
    assert np.isfinite(r.render_pose(C2W)).all()
    capsys.readouterr()
    for main, out in ((tconv.main, "tp"), (jconv.main, "jp")):
        main([path, str(tmp_path / out), "--height", "8", "--width", "8"])
        printed = capsys.readouterr().out
        assert "[WARN] partial geometry given" in printed
        assert not os.path.exists(tmp_path / out / "scene.json")


def _state_at(step: int, seed: int = 5) -> JaxState:
    st = jax_create_state(jax.random.PRNGKey(seed), mlp=JaxCfg(**TINY_CFG))
    return JaxState(params=st.params, opt_state=st.opt_state,
                    step=st.step + step)


def _save_both(tmp_path, name, steps, scene=None):
    """The same states saved as a JAX run (``<name>_j/checkpoints``) and a
    port run (``<name>_t/torch_checkpoints``), each with ``scene``."""
    dirs = []
    for side, sub in (("j", "checkpoints"), ("t", "torch_checkpoints")):
        run = str(tmp_path / f"{name}_{side}")
        for step in steps:
            st = _state_at(step)
            if side == "j":
                jax_save(os.path.join(run, sub), st)
            else:
                from cvnerf_torch.utils.convert import train_state_from_jax
                tckpt.save_checkpoint(os.path.join(run, sub),
                                      train_state_from_jax(
                                          jax.tree.map(np.asarray, st)))
        if scene is not None:
            write_scene_snapshot(run, **scene)
        dirs.append(os.path.join(run, sub))
    return dirs


def _same_pt(a: str, b: str) -> None:
    x = torch.load(a, weights_only=True)
    y = torch.load(b, weights_only=True)
    assert x.keys() == y.keys() and x["step"] == y["step"]
    for net in ("coarse", "fine"):
        assert x[net].keys() == y[net].keys()
        for k, t in x[net].items():
            assert t.dtype == y[net][k].dtype and torch.equal(t, y[net][k]), k


def test_export_matches_the_jax_exporter(tmp_path):
    """Export of the same params at step 42: tensor for tensor the JAX
    exporter's ``.pt``, loadable ``weights_only``, read back as the saved
    params."""
    jdir, tdir = _save_both(tmp_path, "e", [42])
    tout, jout = str(tmp_path / "t.pt"), str(tmp_path / "j.pt")
    assert tconv.export_torch_checkpoint(tdir, tout) == 42
    assert jconv.export_torch_checkpoint(jdir, jout) == 42
    _same_pt(tout, jout)
    params, cfg, step = tconv.load_torch_checkpoint(tout)
    assert cfg == NerfMLPConfig(**TINY_CFG) and step == 42
    _same_params(params, _state_at(42).params)


def test_export_mid_anneal_step_zero_and_empty_dir(tmp_path, capsys):
    """Inside a ``freq_anneal`` horizon (``scene.json``) both exporters
    window the weights alike, and an exported file is not windowed twice;
    ``--step 0`` exports step 0, not the latest; an empty directory is a
    clear error."""
    scene = dict(height=8, width=8, focal=10.0, near=2.0, far=6.0,
                 ndc=False, ndc_variant="canonical", white_bkg=False,
                 n_coarse=4, n_fine=4, bf16=False,
                 mlp=NerfMLPConfig(**TINY_CFG), freq_anneal=10)
    jdir, tdir = _save_both(tmp_path, "a", [4], scene)
    tout, jout = str(tmp_path / "t.pt"), str(tmp_path / "j.pt")
    tconv.main(["--export", tdir, tout])
    assert "applying the training-time frequency window" in \
        capsys.readouterr().out
    jconv.main(["--export", jdir, jout])
    _same_pt(tout, jout)
    raw, _, _ = tconv.load_torch_checkpoint(os.path.join(tdir, "000004.pt"))
    windowed, _, _ = tconv.load_torch_checkpoint(tout)
    assert not torch.equal(raw["fine"]["l1"]["w"], windowed["fine"]["l1"]["w"])
    # The exported file, placed as the run's checkpoint, exports as it is.
    os.replace(tout, os.path.join(tdir, "000004.pt"))
    again = str(tmp_path / "again.pt")
    tconv.export_torch_checkpoint(tdir, again)
    _same_pt(again, jout)

    jdir, tdir = _save_both(tmp_path, "z", [0, 7])
    for main, d, side in ((tconv.main, tdir, "t"), (jconv.main, jdir, "j")):
        main(["--export", "--step", "0", d, str(tmp_path / f"{side}0.pt")])
        main(["--export", d, str(tmp_path / f"{side}7.pt")])
        assert torch.load(str(tmp_path / f"{side}0.pt"),
                          weights_only=True)["step"] == 0
        assert torch.load(str(tmp_path / f"{side}7.pt"),
                          weights_only=True)["step"] == 7
    _same_pt(str(tmp_path / "t0.pt"), str(tmp_path / "j0.pt"))
    for export in (tconv.export_torch_checkpoint,
                   jconv.export_torch_checkpoint):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            export(str(tmp_path / "nothing"), str(tmp_path / "o.pt"))


def test_import_then_render_then_fine_tune_through_the_cli(tmp_path):
    """A reference ``.pt`` imported at step 2499 renders through
    ``NerfRenderer`` and fine-tunes through ``python -m cvnerf_torch.cli
    --ft_path``, which starts from its weights at its step."""
    from cvnerf_torch import cli
    from cvnerf_torch.data.synthetic import make_blender_dataset
    from cvnerf_torch.render.renderer import RenderConfig
    path = str(tmp_path / "ref.pt")
    torch.save({"coarse": _torch_model(0, **TINY).state_dict(),
                "fine": _torch_model(1, **TINY).state_dict()}, path)
    out = str(tmp_path / "run")
    cfg = tconv.import_torch_checkpoint(path, out, step=2499)
    ckpts = os.path.join(out, "torch_checkpoints")
    r = NerfRenderer(os.path.join(ckpts, "002499.pt"), height=8, width=8,
                     focal=10.0, near=2.0, far=6.0,
                     cfg=RenderConfig(n_coarse=4, n_fine=4, mlp=cfg),
                     chunk=64, device="cpu")
    assert r.step == 2499
    rgb = r.render_pose(C2W)
    assert rgb.shape == (8, 8, 3) and np.isfinite(rgb).all()

    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_train=2, n_val=1, n_test=1, h=16, w=16)
    logs = str(tmp_path / "logs")
    res = cli.main(["--data_dir", data, "--base_dir", logs, "--save_dir",
                    logs, "--name", "ft", "--device", "cpu", "--no-bf16",
                    "--dtype", "blender", "--white_bkg", "--testskip", "1",
                    "--n_rays", "32", "--n_coarse_samples", "4",
                    "--n_fine_samples", "4", "--trunk_width", "32",
                    "--head_width", "16", "--xyz_freqs", "4",
                    "--dir_freqs", "2", "--chunk", "128", "--vid_freq", "0",
                    "--val_freq", "0", "--ckpt_freq", "0",
                    "--ft_path", ckpts, "--iters", "2502"])
    assert np.isfinite(res["loss"])
    tuned = tckpt.restore_checkpoint(
        os.path.join(logs, "ft", "torch_checkpoints"),
        create_train_state(PRNGKey(0), mlp=cfg, device="cpu"))
    start = tckpt.restore_checkpoint(
        ckpts, create_train_state(PRNGKey(0), mlp=cfg, device="cpu"))
    assert tuned.step == 2501 and tuned.opt_state.count == 2
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(tuned.params), tree_leaves(start.params))]
    assert any(moved)
