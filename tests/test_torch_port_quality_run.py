"""``python -m cvnerf_torch.quality_run`` on a micro scene, on the CPU.

The micro band trains ``sphere_hi`` cut to 8 views of 16x16 (the
generator's ``_SCENES`` entry shrunk for the test) and a 32-wide net for 300 steps (seed 1, density noise 1.0, lr 3e-3: at this width
noise keeps the density from dying at init), on one torch thread (the
CPU's float sums, and so the reading, change with the thread count). It
reads 19.84 dB; a planted ``kernel_perturb`` 16.57 dB and
``resample_unsorted`` 10.14. The temporary bands file below puts the
floor 1 dB under the clean reading, as ``results/psnr_bands.json`` pins
its bands: the clean run passes, each planted defect falls below it, and a
floor no run reaches fails. The band key and the CLI flags are the real
bands'.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cvnerf_torch import quality_run
from cvnerf_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
MICRO = ["--scene", "sphere_hi", "--iters", "300", "--device", "cpu"]
# The sphere scene's generator sizes for the micro band.
SMALL = dict(n_train=8, h=16, w=16)
EXTRA = ["--extra", "--n_rays", "64", "--n_coarse_samples", "8",
         "--n_fine_samples", "8", "--trunk_width", "32", "--head_width",
         "16", "--xyz_freqs", "4", "--dir_freqs", "2", "--precrop_iters",
         "0", "--chunk", "1024", "--no-bf16", "--lr", "3e-3", "--lr_decay",
         "1", "--noise", "1.0", "--seed", "1"]


FLOOR = 18.84


@pytest.fixture(autouse=True)
def _micro_scene(monkeypatch):
    spec = synthetic._SCENES["sphere"]
    monkeypatch.setitem(synthetic._SCENES, "sphere",
                        {**spec, "gen": {**spec["gen"], **SMALL}})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(tmp_path, floor):
    path = tmp_path / "bands.json"
    path.write_text(json.dumps({"sphere_hi_300": {
        "min_test_psnr_db": floor, "measured_db": floor + 1.0}}))
    return str(path)


def test_the_band_key_and_flags_are_the_jax_scripts():
    assert quality_run.band_key("checker", 3000) == "checker_sphere_3000"
    assert quality_run.band_key("llff_360", 50000) == "llff_360_50000"
    args = quality_run.build_parser().parse_args(
        ["--scene", "llff_360", "--iters", "3000"])
    flags = quality_run.cli_flags(args, "d", "l")
    for pair in (("--n_rays", "1024"), ("--n_coarse_samples", "64"),
                 ("--n_fine_samples", "128"), ("--lr", "5e-4"),
                 ("--lr_decay", "500"), ("--val_freq", "300"),
                 ("--seed", "0")):
        i = flags.index(pair[0])
        assert flags[i + 1] == pair[1], pair
    assert "--bf16" in flags and flags[flags.index("--device") + 1] == "cuda"
    with open(quality_run.BANDS) as fp:
        bands = json.load(fp)
    for scene in quality_run.SCENES:
        assert quality_run.band_key(scene, 3000) in bands


def test_a_reachable_band_passes_without_importing_jax(tmp_path):
    """Run in a fresh process (the test process has JAX loaded): exit 0,
    and no JAX module loaded by the run."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from cvnerf_torch import quality_run\n"
        "from cvnerf_torch.data.synthetic import _SCENES\n"
        f"_SCENES['sphere']['gen'].update({SMALL!r})\n"
        f"out = quality_run.main({MICRO + ['--bands', _bands(tmp_path, FLOOR)] + EXTRA!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'cvnerf_tpu')))\n"
        "print('RESULT', out['psnr'], bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert line and line[0].endswith("[]"), res.stdout[-2000:]
    assert "PASS sphere_hi_300" in res.stdout


def test_an_unreachable_band_fails(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        quality_run.main([*MICRO, "--bands", _bands(tmp_path, 40.0),
                          *EXTRA])
    assert e.value.code == 3
    assert "FAIL sphere_hi_300" in capsys.readouterr().out


@pytest.mark.parametrize("defect", quality_run.DEFECTS)
def test_a_planted_defect_exits_nonzero(tmp_path, capsys, defect):
    with pytest.raises(SystemExit) as e:
        quality_run.main([*MICRO, "--bands", _bands(tmp_path, FLOOR),
                          "--defect", defect, *EXTRA])
    assert e.value.code == 3
    out = capsys.readouterr().out
    assert f"CAUGHT defect {defect}" in out
    # The defect is gone once the run ends.
    import cvnerf_torch.render.renderer as renderer
    from cvnerf_torch.ops.sampling import merge_sorted
    assert renderer.merge_sorted is merge_sorted
    assert renderer._query_mlp.__name__ == "_query_mlp"
