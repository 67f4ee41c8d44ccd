"""The seams the port's modules meet at: the model families
(``cvnerf_torch/models/family.py``) and the kernel build
(``cvnerf_torch/utils/kernels.py``).

A checkpoint of either family is written key for key and bit for bit in
the layout written out here by hand (NeRF's reference state dicts at the
file's top level with no tag; the Instant-NGP field's trees under
``"params"`` beside ``"model": "ngp"``) and restores bitwise; a checkpoint
of one family offered to the other's template, and a file's tag, are
refused or read as before. Every lever the Instant-NGP field does not take
is refused at the entry point that can be asked for it, with that entry
point's exception. The build takes every ``csrc/*.cu`` by stem and names a
library by the hash of its source, the shared headers and the flags, so a
built tree's libraries are reused."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from cvnerf_torch.models.family import (FAMILIES, NERF, NGP, family_named,
                                        family_of, family_of_params)
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.models.ngp_field import NgpFieldConfig
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.serve import CKPT_SUBDIR, NerfRenderer, write_scene_snapshot
from cvnerf_torch.train.checkpoint import (restore_checkpoint,
                                           restore_params, save_checkpoint)
from cvnerf_torch.train.loop import TrainConfig, check_supported
from cvnerf_torch.train.state import AdamState, TrainState, create_train_state
from cvnerf_torch.utils import kernels
from cvnerf_torch.utils.tree import tree_map

MLPS = {"nerf": NerfMLPConfig(xyz_freqs=4, dir_freqs=2, trunk_width=32,
                              head_width=16),
        "ngp": NgpFieldConfig(n_levels=4, log2_table=8, base_res=4,
                              max_res=32, hidden=16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these runs are many tiny ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(model: str, seed: int = 0) -> TrainState:
    """A state with an EMA slot whose moments and average are random, so a
    mix-up of the trees would show."""
    g = torch.Generator().manual_seed(seed)
    st = create_train_state(PRNGKey(seed), mlp=MLPS[model], device="cpu")

    def rand(tree):
        return tree_map(lambda t: torch.randn(t.shape, generator=g), tree)
    return TrainState(params=st.params,
                      opt_state=AdamState(count=seed + 3,
                                          mu=rand(st.params),
                                          nu=rand(st.params)),
                      step=seed + 3, ema_params=rand(st.params))


def _reference_state_dict(net: dict) -> dict:
    """One NeRF net as the reference ``Model``'s ``nn.Linear`` state dict:
    ``l1.weight`` ``[out, in]``, ``l1.bias``, ..., the density head as
    ``l_alpha``."""
    out = {}
    for name, layer in net.items():
        key = "l_alpha" if name == "alpha" else name
        out[f"{key}.weight"] = layer["w"].t()
        out[f"{key}.bias"] = layer["b"]
    return out


def _file_layout(model: str, st: TrainState) -> dict:
    """The checkpoint of ``st`` as written out by hand."""
    if model == "ngp":
        return {"model": "ngp", "params": st.params, "step": st.step,
                "opt_state": {"count": st.opt_state.count,
                              "mu": st.opt_state.mu, "nu": st.opt_state.nu},
                "raw_params": True, "ema_params": st.ema_params}

    def nets(tree):
        return {k: _reference_state_dict(v) for k, v in tree.items()}
    return {**nets(st.params), "step": st.step,
            "opt_state": {"count": st.opt_state.count,
                          "mu": nets(st.opt_state.mu),
                          "nu": nets(st.opt_state.nu)},
            "raw_params": True, "ema_params": nets(st.ema_params)}


def _entries(x, path=""):
    """Every leaf of a nested dict in order: its key path, and its type
    and value, a tensor by dtype, shape and bytes."""
    if isinstance(x, dict):
        return [e for k, v in x.items() for e in _entries(v, f"{path}/{k}")]
    if torch.is_tensor(x):
        return [(path, str(x.dtype), tuple(x.shape),
                 x.contiguous().view(torch.uint8).numpy().tobytes())]
    return [(path, type(x).__name__, x)]


def _assert_trees_bitwise(a: dict, b: dict):
    assert _entries(a) == _entries(b)


@pytest.mark.parametrize("model", list(MLPS))
def test_a_checkpoint_is_the_layout_written_by_hand_and_restores_bitwise(
        tmp_path, model):
    st = _state(model)
    save_checkpoint(str(tmp_path), st)
    blob = torch.load(os.path.join(str(tmp_path), "000003.pt"),
                      weights_only=True)
    assert _entries(blob) == _entries(_file_layout(model, st))
    template = create_train_state(PRNGKey(9), mlp=MLPS[model], device="cpu",
                                  ema=True)
    got = restore_checkpoint(str(tmp_path), template)
    assert (got.step, got.opt_state.count) == (3, 3)
    for x, y in ((got.params, st.params), (got.opt_state.mu, st.opt_state.mu),
                 (got.opt_state.nu, st.opt_state.nu),
                 (got.ema_params, st.ema_params)):
        _assert_trees_bitwise(x, y)


@pytest.mark.parametrize("saved,template", [("nerf", "ngp"), ("ngp", "nerf")])
def test_a_checkpoint_of_one_family_is_refused_by_the_others_template(
        tmp_path, saved, template):
    save_checkpoint(str(tmp_path), _state(saved))
    other = create_train_state(PRNGKey(1), mlp=MLPS[template], device="cpu")
    with pytest.raises(ValueError, match="the checkpoint's model and the "
                                         "run's differ"):
        restore_checkpoint(str(tmp_path), other)


@pytest.mark.parametrize("model,wider,leaf", [
    ("nerf", {"trunk_width": 48}, r"params coarse\.l1\.w has shape "
                                  r"\(27, 32\), the run expects \(27, 48\)"),
    ("ngp", {"hidden": 8}, r"params\.field\.density\.l0 has shape "
                           r"\(8, 16\), the run expects \(8, 8\)")])
def test_a_checkpoint_of_other_widths_is_refused_naming_the_leaf(
        tmp_path, model, wider, leaf):
    save_checkpoint(str(tmp_path), _state(model))
    other = create_train_state(PRNGKey(1), device="cpu",
                               mlp=dataclasses.replace(MLPS[model], **wider))
    with pytest.raises(ValueError, match=leaf):
        restore_checkpoint(str(tmp_path), other)


@pytest.mark.parametrize("step", [0, None])
def test_a_params_only_ngp_file_restores_its_field(tmp_path, step):
    """The params-only file the benchmark writes for a served field
    (``{"model": "ngp", "params": tree, "step": 0}``), and one without a
    step."""
    params = _state("ngp").params
    blob = {"model": "ngp", "params": params}
    if step is not None:
        blob["step"] = step
    torch.save(blob, str(tmp_path / "000000.pt"))
    got, found = restore_params(str(tmp_path))
    assert found == 0
    _assert_trees_bitwise(got, params)


@pytest.mark.parametrize("model", list(MLPS))
def test_a_run_directory_of_either_family_serves_its_average(tmp_path,
                                                             model):
    """``scene.json`` carries ``"model": "ngp"`` for the field and no tag
    for NeRF; ``from_run_dir`` reads the family back from it and serves
    the checkpoint's Polyak average, bitwise."""
    st = _state(model)
    run = str(tmp_path / "run")
    save_checkpoint(os.path.join(run, CKPT_SUBDIR), st)
    write_scene_snapshot(run, height=8, width=8, focal=6.0, near=0.0,
                         far=1.0, ndc=True, ndc_variant="canonical",
                         white_bkg=False, n_coarse=4, n_fine=4, bf16=False,
                         mlp=MLPS[model], pallas="off")
    with open(os.path.join(run, "scene.json")) as fp:
        snap = json.load(fp)
    assert snap.get("model") == ("ngp" if model == "ngp" else None)
    r = NerfRenderer.from_run_dir(run, device="cpu", chunk=32)
    assert r.cfg.mlp == MLPS[model] and r.family is FAMILIES[model]
    assert r.step == 3
    _assert_trees_bitwise(r.params, st.ema_params)
    assert r.render_pose(np.eye(4)[:3]).shape == (8, 8, 3)


@pytest.mark.parametrize("model", list(MLPS))
def test_each_family_is_found_by_its_config_name_tag_and_params(model):
    fam = FAMILIES[model]
    assert family_of(MLPS[model]) is fam
    assert family_named(model) is fam and family_named(fam.tag) is fam
    params = create_train_state(PRNGKey(0), mlp=MLPS[model],
                                device="cpu").params
    assert family_of_params(params) is fam
    assert list(params) == (["field"] if model == "ngp"
                            else ["coarse", "fine"])


def test_an_unknown_family_is_refused():
    with pytest.raises(ValueError, match="no model family"):
        family_named("mipnerf")
    with pytest.raises(TypeError, match="no model family"):
        family_of(object())


@pytest.fixture(scope="module")
def sphere_dir(tmp_path_factory):
    from cvnerf_torch.data.synthetic import main as synth
    data = str(tmp_path_factory.mktemp("sphere") / "data")
    synth(["--scene", "sphere", "--out", data, "--views", "4", "--size",
           "16", "16"])
    return data


@pytest.mark.parametrize("lever", [["--occ_train"], ["--occupancy", "merge"],
                                   ["--freq_anneal", "4"]],
                         ids=lambda lv: lv[0])
def test_the_cli_refuses_nerfs_levers_for_an_ngp_field(tmp_path, sphere_dir,
                                                       lever):
    from cvnerf_torch import cli
    argv = ["--config", os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "demo_sphere.txt"),
            "--device", "cpu", "--data_dir", sphere_dir, "--base_dir",
            str(tmp_path), "--save_dir", str(tmp_path), "--name", "ngp",
            "--iters", "2", "--n_rays", "32", "--n_coarse_samples", "8",
            "--n_fine_samples", "8", "--precrop_iters", "0", "--no-bf16",
            "--model", "ngp", *lever]
    with pytest.raises(SystemExit) as err:
        cli.main(argv)
    assert f"without {lever[0]} (NeRF's levers)" in str(err.value.code)
    assert not os.path.exists(str(tmp_path / "ngp" / "torch_checkpoints"))


@pytest.mark.parametrize("model", list(MLPS))
@pytest.mark.parametrize("lever", ["occupancy", "freq_anneal"])
def test_check_supported_refuses_nerfs_levers_for_an_ngp_field(model, lever):
    cfg = TrainConfig(height=16, width=16, focal=14.0, near=0.0, far=1.0,
                      n_rays=32, freq_anneal=4 if lever == "freq_anneal"
                      else 0, render=RenderConfig(mlp=MLPS[model]))
    occupancy = lever == "occupancy"
    if model == "nerf":
        check_supported(cfg, with_occupancy=occupancy)
        return
    with pytest.raises(ValueError, match="the Instant-NGP field trains "
                                         "without occupancy training"):
        check_supported(cfg, with_occupancy=occupancy)


@pytest.mark.parametrize("method,what", [("enable_occupancy", "occupancy"),
                                         ("enable_int8", "int8 serving"),
                                         ("extract_mesh", "meshing")])
def test_an_ngp_renderer_refuses_nerfs_levers(tmp_path, method, what):
    path = str(tmp_path / "f.pt")
    torch.save({"model": "ngp", "params": _state("ngp").params, "step": 0},
               path)
    r = NerfRenderer(path, height=8, width=8, focal=6.0, near=0.0, far=1.0,
                     ndc=True, cfg=RenderConfig(mlp=MLPS["ngp"]),
                     device="cpu")
    with pytest.raises(ValueError, match=f"^{what} is NeRF's: an "
                                         "Instant-NGP field serves"):
        getattr(r, method)()
    assert r.occupancy is None and r._nets is r.params


def test_only_the_ngp_field_refuses_levers():
    levers = dict(occ_train=True, occupancy=True, int8=True,
                  freq_anneal=True, meshing=True)
    assert NERF.refused(**levers) == []
    assert NGP.refused(**levers) == list(levers)
    assert NGP.refused(occupancy=False, int8=True) == ["int8"]


def test_the_build_takes_every_kernel_source_by_stem():
    assert sorted(kernels.SOURCES) == [
        "adam", "fused_mlp", "fused_mlp_bwd", "fused_mlp_int8",
        "hash_encode", "ngp_mlp", "threefry"]
    assert all(p.suffix == ".cu" and p.stem == name and p.exists()
               for name, p in kernels.SOURCES.items())


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_a_built_library_keeps_its_name_and_is_reused(tmp_path, monkeypatch,
                                                      name):
    """``<stem>_<16 hex>.so``, the hash of the source, every shared header
    in name order and the flags: a library already built under that name
    is returned without running ``nvcc``."""
    csrc = kernels.SOURCES[name].parent
    assert kernels._BUILD_DIR == (csrc.parents[1] / "build"
                                  / "cvnerf_torch_kernels")
    flags = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC")
    blob = kernels.SOURCES[name].read_bytes() + b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(blob + " ".join(flags).encode()).hexdigest()
    built = tmp_path / f"{name}_{digest[:16]}.so"
    built.write_bytes(b"")
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("nvcc was asked for a library already built")
    monkeypatch.setattr(kernels, "nvcc", no_nvcc)
    assert kernels.build_library(name) == built


def test_a_build_without_nvcc_raises_and_leaves_nothing(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "kernels")

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(kernels, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library("adam")
    assert not (tmp_path / "kernels").exists()
