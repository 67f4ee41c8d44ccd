"""``python -m cvnerf_torch.eval`` against ``cvnerf_tpu.eval`` on the same
weights: one run directory holds a JAX state's orbax checkpoint
(``checkpoints/``, which the JAX tool scores) and the same state carried
over with ``train_state_from_jax`` and saved by the port
(``torch_checkpoints/``, which the port scores). Both render in fp32 with
the evenly spaced resample; per view and in the mean, PSNR agrees within
1e-3 dB and SSIM within 1e-5.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cvnerf_torch.eval import main as eval_main
from cvnerf_torch.train.checkpoint import save_checkpoint
from cvnerf_torch.utils.convert import train_state_from_jax
from cvnerf_tpu.config import parse_args as jax_parse_args
from cvnerf_tpu.config import snapshot_config as jax_snapshot_config
from cvnerf_tpu.data.synthetic import make_blender_dataset
from cvnerf_tpu.eval import main as jax_eval_main
from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.serve import write_scene_snapshot
from cvnerf_tpu.train.checkpoint import save_checkpoint as jax_save
from cvnerf_tpu.train.state import create_train_state as jax_create


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: these runs are many tiny ops, as fast on one
    thread, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=16)


def _jax_state(seed, step):
    st = jax.tree.map(np.asarray, jax_create(jax.random.PRNGKey(seed),
                                             mlp=JaxCfg(**TINY)))
    for net in st.params.values():   # some opacity, so the views differ
        net["alpha"]["b"] = net["alpha"]["b"] + 1.0
        net["l11"]["b"] = net["l11"]["b"] + 0.3 * seed
    return dataclasses.replace(st, step=np.int32(step))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A scene and a run directory both packages can score: steps 4 and 8
    (periodic) and 6 (best-val) of seeded states."""
    root = tmp_path_factory.mktemp("eval")
    data = str(root / "scene")
    make_blender_dataset(data, n_train=2, n_val=2, n_test=3, h=24, w=24)
    run_dir = str(root / "run")
    args = jax_parse_args(["--dtype", "blender", "--white_bkg",
                           "--testskip", "1"])
    jax_snapshot_config(args, run_dir)
    write_scene_snapshot(run_dir, height=24, width=24,
                         focal=0.5 * 24 / np.tan(0.4), near=2.0, far=6.0,
                         ndc=False, ndc_variant="canonical", white_bkg=True,
                         n_coarse=8, n_fine=8, bf16=False,
                         mlp=JaxCfg(**TINY))
    for sub, steps in (("checkpoints", (4, 8)), ("checkpoints_best", (6,))):
        for s in steps:
            st = _jax_state(s, s)
            jax_save(os.path.join(run_dir, sub), st)
            save_checkpoint(os.path.join(run_dir, "torch_" + sub),
                            train_state_from_jax(st))
    return data, run_dir


@pytest.mark.parametrize("extra", [
    [], ["--which", "last"], ["--step", "4"], ["--split", "val"],
    ["--split", "train", "--max_views", "1"]],
    ids=["auto_best", "last", "step", "val", "train_max1"])
def test_eval_matches_the_jax_eval(run, tmp_path, extra):
    data, run_dir = run
    argv = ["--run", run_dir, "--data_dir", data, "--chunk", "128", *extra]
    got = eval_main([*argv, "--device", "cpu",
                     "--out", str(tmp_path / "t.json")])
    jax_eval_main([*argv, "--out", str(tmp_path / "j.json")])
    want = json.load(open(tmp_path / "j.json"))
    assert json.load(open(tmp_path / "t.json")) == got
    for k in ("step", "which", "which_requested", "split", "n_views"):
        assert got[k] == want[k], k
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    for a, b in zip(got["per_view"], want["per_view"]):
        assert a["view"] == b["view"]
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5


def test_eval_saves_renders_and_checks_geometry(run, tmp_path):
    data, run_dir = run
    renders = str(tmp_path / "renders")
    report = eval_main(["--run", run_dir, "--data_dir", data, "--device",
                        "cpu", "--chunk", "128", "--save_renders", renders])
    assert report["which"] == "best" and report["step"] == 6
    assert sorted(os.listdir(renders)) == [
        f"view_{v['view']:03d}.png" for v in report["per_view"]]
    other = str(tmp_path / "other")
    make_blender_dataset(other, n_train=1, n_val=1, n_test=1, h=16, w=16)
    with pytest.raises(SystemExit, match="geometry mismatch"):
        eval_main(["--run", run_dir, "--data_dir", other, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="step 5"):
        eval_main(["--run", run_dir, "--data_dir", data, "--device", "cpu",
                   "--step", "5"])


def test_eval_scores_the_windowed_average_as_the_jax_eval_does(tmp_path):
    """A run trained with ``--ema_decay`` and ``--freq_anneal``, scored at
    a step inside the anneal horizon: both tools score the Polyak average
    through the window at ``step / freq_anneal`` (the port's checkpoint is
    raw, as its trainer writes it)."""
    data = str(tmp_path / "scene")
    make_blender_dataset(data, n_train=2, n_val=1, n_test=2, h=24, w=24)
    run_dir = str(tmp_path / "run")
    args = jax_parse_args(["--dtype", "blender", "--white_bkg",
                           "--testskip", "1"])
    jax_snapshot_config(args, run_dir)
    write_scene_snapshot(run_dir, height=24, width=24,
                         focal=0.5 * 24 / np.tan(0.4), near=2.0, far=6.0,
                         ndc=False, ndc_variant="canonical", white_bkg=True,
                         n_coarse=8, n_fine=8, bf16=False,
                         mlp=JaxCfg(**TINY), freq_anneal=10, ema_decay=0.9)
    st = _jax_state(3, 4)
    ema = jax.tree.map(lambda p: p * np.float32(0.9), st.params)
    for net in ema.values():
        net["alpha"]["b"] = net["alpha"]["b"] + 0.5
    st = dataclasses.replace(st, ema_params=ema)
    jax_save(os.path.join(run_dir, "checkpoints"), st)
    save_checkpoint(os.path.join(run_dir, "torch_checkpoints"),
                    train_state_from_jax(st))
    argv = ["--run", run_dir, "--data_dir", data, "--chunk", "128"]
    got = eval_main([*argv, "--device", "cpu"])
    jax_eval_main([*argv, "--out", str(tmp_path / "j.json")])
    want = json.load(open(tmp_path / "j.json"))
    assert got["step"] == want["step"] == 4
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    for a, b in zip(got["per_view"], want["per_view"]):
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5
    # The raw params score otherwise: the average and the window matter.
    plain = dataclasses.replace(st, ema_params=None, step=np.int32(5))
    save_checkpoint(os.path.join(run_dir, "torch_checkpoints"),
                    train_state_from_jax(plain))
    assert abs(eval_main([*argv, "--device", "cpu"])["psnr"]
               - got["psnr"]) > 1e-2
