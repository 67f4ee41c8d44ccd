"""The quality bands on the port: train a seeded synthetic scene with
``python -m cvnerf_torch.cli`` and hold its held-out test PSNR to the
band in ``results/psnr_bands.json`` (the port's counterpart of
``scripts/quality_run.py``; the bands are the JAX package's, read and
never written here)::

    python -m cvnerf_torch.quality_run --scene sphere_hi --iters 3000
    python -m cvnerf_torch.quality_run --scene llff_360 --iters 3000
    python -m cvnerf_torch.quality_run --scene sphere_hi --iters 3000 \\
        --defect kernel_perturb

Scenes (the port's generator, ``data/synthetic.py``, with its ``_SCENES``
flags): ``checker`` (band ``checker_sphere_<iters>``), ``sphere_hi``
(``sphere``), ``llff_plane`` and ``llff_360``. The run is the band's: 1024
rays, 64 + 128 samples, lr 5e-4 decaying over 500k steps, bf16, seed 0,
validation every ``iters / 10`` steps (every 300 for ``llff_360``, whose
best-validation model is scored). The score is ``test_psnr_best`` where
the run tracked its best model, else ``test_psnr``.

``--defect`` plants a known fault so that a run can show the band fails:
``kernel_perturb`` biases every eval-mode MLP query (+0.5 on the rgb
logits, density halved) while training queries stay exact;
``resample_unsorted`` merges the fine depths with the coarse ones without
sorting. The verdict is the band's either way: the process exits 3 below
the floor (a caught defect does too), 0 at or above it.

The flags after ``--extra`` (appended to the CLI's, so they override)
shrink a run for a quick check; ``--bands`` points at another bands
file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = os.path.join(REPO, "results", "psnr_bands.json")

# quality_run scene → the generator's scene name.
SCENES = {"checker": "checker", "sphere_hi": "sphere",
          "llff_plane": "llff_plane", "llff_360": "llff_360"}
DEFECTS = ("kernel_perturb", "resample_unsorted")


def band_key(scene: str, iters: int) -> str:
    return ("checker_sphere" if scene == "checker" else scene) + f"_{iters}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cvnerf_torch.quality_run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="checker", choices=sorted(SCENES))
    p.add_argument("--iters", type=int, default=50000)
    p.add_argument("--defect", default=None, choices=DEFECTS,
                   help="plant a known fault; the run should land below "
                        "the band")
    p.add_argument("--bands", default=BANDS,
                   help="the bands file (default results/psnr_bands.json)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default=None,
                   help="where the scene and the run go (default: a "
                        "temporary directory, removed afterwards)")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="everything after --extra is appended to the "
                        "CLI's flags (put it last)")
    return p


@contextlib.contextmanager
def planted(defect: str | None):
    """Install ``defect`` in the renderer for the duration."""
    if defect is None:
        yield
        return
    import torch

    import cvnerf_torch.render.renderer as renderer
    name = {"kernel_perturb": "_query_mlp",
            "resample_unsorted": "merge_sorted"}[defect]
    orig = getattr(renderer, name)
    if defect == "kernel_perturb":
        def fault(net, points, viewdirs, cfg):
            raw = orig(net, points, viewdirs, cfg)
            if cfg.perturb:          # training queries stay exact
                return raw
            scale = raw.new_tensor([1.0, 1.0, 1.0, 0.5])
            shift = raw.new_tensor([0.5, 0.5, 0.5, 0.0])
            return raw * scale + shift
    else:
        def fault(a, b):
            return torch.cat([a, b], dim=-1)
    setattr(renderer, name, fault)
    try:
        yield
    finally:
        setattr(renderer, name, orig)


def _scene(scene: str, data_dir: str) -> list[str]:
    """Write the scene; return its CLI flags."""
    from cvnerf_torch.data.synthetic import _SCENES, generate
    generate(SCENES[scene], data_dir)
    return _SCENES[SCENES[scene]]["train_flags"].split()


def cli_flags(args, data_dir: str, logdir: str) -> list[str]:
    """The CLI invocation of the band's run (``scripts/quality_run.py``'s
    flags)."""
    return [
        "--data_dir", data_dir, "--name", "run",
        "--base_dir", logdir, "--save_dir", logdir,
        "--device", args.device,
        "--n_rays", "1024", "--n_coarse_samples", "64",
        "--n_fine_samples", "128", "--lr", "5e-4", "--lr_decay", "500",
        "--bf16", "--iters", str(args.iters), "--vid_freq", "0",
        "--ckpt_freq", "0",
        "--val_freq", ("300" if args.scene == "llff_360"
                       else str(max(args.iters // 10, 1))),
        "--print_freq", "500", "--seed", "0"]


def run(argv=None) -> dict:
    """Train and score one band; returns ``{"key", "psnr", "floor",
    "jax_measured", "passed", "defect", "seconds", "steps"}``
    (``floor``/``jax_measured`` None when the file has no such band)."""
    import time

    from cvnerf_torch import cli
    args = build_parser().parse_args(argv)
    key = band_key(args.scene, args.iters)
    with open(args.bands) as fp:
        band = json.load(fp).get(key)
    workdir = args.workdir or tempfile.mkdtemp(prefix="quality_run_")
    try:
        data_dir = os.path.join(workdir, args.scene)
        logdir = os.path.join(workdir, "logs")
        flags = _scene(args.scene, data_dir)
        t0 = time.time()
        with planted(args.defect):
            cli.main([*cli_flags(args, data_dir, logdir), *flags,
                      *args.extra])
        seconds = time.time() - t0
        with open(os.path.join(logdir, "run", "metrics.jsonl")) as fp:
            records = [json.loads(line) for line in fp]
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    scores = [r.get("test_psnr_best", r.get("test_psnr")) for r in records
              if "test_psnr" in r or "test_psnr_best" in r]
    if not scores:
        raise RuntimeError("the run logged no test PSNR")
    psnr = float(scores[-1])
    floor = band["min_test_psnr_db"] if band else None
    out = {"key": key, "psnr": psnr, "floor": floor,
           "jax_measured": band["measured_db"] if band else None,
           "passed": floor is not None and math.isfinite(psnr)
           and psnr >= floor,
           "defect": args.defect, "seconds": seconds,
           "steps": max(r["step"] for r in records if "loss" in r)}
    if band is None:
        print(f"NO BAND for {key} in {args.bands}; measured {psnr:.2f} dB")
    else:
        verdict = "PASS" if out["passed"] else "FAIL"
        print(f"{verdict} {key}: test PSNR {psnr:.2f} dB vs floor "
              f"{floor} dB (the JAX package measured "
              f"{band['measured_db']} dB)")
        if args.defect:
            print(f"{'MISSED' if out['passed'] else 'CAUGHT'} defect "
                  f"{args.defect} on {key}")
    return out


def main(argv=None) -> dict:
    """Run one band; exit 3 when the score is below its floor (or the file
    has no band for it)."""
    out = run(argv)
    if not out["passed"]:
        raise SystemExit(3)
    return out


if __name__ == "__main__":
    main()
