"""Standalone checkpoint evaluation: PSNR/SSIM over a dataset split (port
of the JAX package's ``eval.py``).

Scores a run directory's checkpoint (``torch_checkpoints/``, written by
``python -m cvnerf_torch.cli`` or exported by ``cvnerf-import --export``)
against the views of a dataset split, rendered through
``NerfRenderer.from_run_dir`` on the card (``--device cpu`` for the CPU):
the Polyak average of an EMA run, and a raw checkpoint from inside a
``freq_anneal`` horizon through the training-time window, as the JAX
eval scores them.

Usage:
    python -m cvnerf_torch.eval --run logs/lego --data_dir data/lego \
        --dtype blender
    python -m cvnerf_torch.eval --run logs/fern --data_dir data/fern \
        --dtype llff --split val --step 50000 --out eval.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True,
                   help="training run directory (scene.json + checkpoints)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--dtype", default="blender", choices=["blender", "llff"])
    p.add_argument("--split", default="test",
                   choices=["test", "val", "train"])
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--which", default="auto",
                   choices=["auto", "best", "last"],
                   help="which model to score — auto (default) picks the "
                        "best-validation checkpoint when the run tracked "
                        "one (--track_best), else the last periodic one")
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--max_views", type=int, default=0,
                   help="score at most N views (0 = all)")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="AlexNet-LPIPS weights .npz (utils/lpips.py); adds "
                        "LPIPS to the report")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the report as JSON here")
    p.add_argument("--save_renders", type=str, default=None,
                   help="also write each rendered view as PNG into this "
                        "directory (view_<idx>.png)")
    # Dataset-loader flags. Defaults come from the RUN's own
    # config_resolved.json (written at train time), so re-typing them is
    # never required and cannot silently diverge — a hand-typed
    # --white_bkg mismatch, for instance, would score ground truth
    # composited over the wrong background with no error. CLI values
    # override the run's record; geometry is additionally cross-checked
    # against scene.json after loading.
    p.add_argument("--half_res", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--testskip", type=int, default=None)
    p.add_argument("--white_bkg", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--factor", type=int, default=None)
    p.add_argument("--no_ndc", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--llffhold", type=int, default=None)
    p.add_argument("--spherify", action=argparse.BooleanOptionalAction,
                   default=None)
    return p


_LOADER_DEFAULTS = {"half_res": False, "testskip": 8, "white_bkg": False,
                    "factor": 8, "no_ndc": False, "llffhold": 8,
                    "spherify": False}


def _resolve_loader_flags(args: argparse.Namespace, run_dir: str) -> dict:
    """Loader flags: CLI value → the run's config_resolved.json → default."""
    run_cfg = {}
    path = os.path.join(run_dir, "config_resolved.json")
    if os.path.exists(path):
        with open(path) as fp:
            run_cfg = json.load(fp)
    out = {}
    for k, hard_default in _LOADER_DEFAULTS.items():
        v = getattr(args, k)
        if v is None:
            v = run_cfg.get(k, hard_default)
        out[k] = v
    return out


def main(argv=None) -> dict:
    """Score the run; returns the report (also printed, and written to
    ``--out``)."""
    args = build_parser().parse_args(argv)

    from cvnerf_torch.data.datasets import load_scene
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.utils.image import psnr_images, ssim_images

    loader = _resolve_loader_flags(args, args.run)
    scene = load_scene(args.data_dir, args.dtype, **loader)
    idx = {"test": scene.test_idx, "val": scene.val_idx,
           "train": scene.train_idx}[args.split]
    idx = list(np.asarray(idx))
    if not idx:
        sys.exit(f"dataset has no '{args.split}' views")
    if args.max_views > 0:
        idx = idx[:args.max_views]

    r = NerfRenderer.from_run_dir(args.run, chunk=args.chunk,
                                  step=args.step, which=args.which,
                                  device=args.device)
    if (r.height, r.width) != (scene.height, scene.width):
        sys.exit(
            f"geometry mismatch: the run was trained at {r.height}x"
            f"{r.width} (scene.json) but the dataset loads as "
            f"{scene.height}x{scene.width} — check --half_res/--factor")

    lpips_bundle = None
    if args.lpips_weights:
        from cvnerf_torch.utils.lpips import load_weights
        lpips_bundle = load_weights(args.lpips_weights, r.device)

    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)

    # render_video queues view k+1 on the device while view k is scored
    # and written on the host.
    per_view = []

    def score_frame(k: int, rgb: np.ndarray) -> None:
        i = int(idx[k])
        if args.save_renders:
            from cvnerf_torch.utils.image import write_png
            write_png(os.path.join(args.save_renders,
                                   f"view_{i:03d}.png"), rgb)
        gt = np.asarray(scene.images[i])[..., :3]
        rec = {"view": i,
               "psnr": round(float(psnr_images(rgb, gt)), 4),
               "ssim": round(float(ssim_images(rgb, gt)), 5)}
        if lpips_bundle is not None:
            from cvnerf_torch.utils.lpips import lpips_images
            rec["lpips"] = round(float(lpips_images(rgb, gt,
                                                    lpips_bundle)), 5)
        per_view.append(rec)
        print(f"view {rec['view']:3d}: psnr={rec['psnr']:.3f} "
              f"ssim={rec['ssim']:.4f}"
              + (f" lpips={rec['lpips']:.4f}" if "lpips" in rec else ""),
              flush=True)

    poses_arr = np.asarray([scene.poses[int(i)] for i in idx], np.float32)
    # collect=False: each frame is scored and dropped, never stacked.
    r.render_video(poses_arr, on_frame=score_frame, collect=False)

    report = {
        "run": os.path.abspath(args.run),
        "step": int(r.step),
        # The RESOLVED model ("best"/"last"), not the requested mode: an
        # "auto" report would leave best-vs-last ambiguous to consumers.
        "which": r.which,
        "which_requested": args.which,
        "split": args.split,
        "n_views": len(per_view),
        "psnr": round(float(np.mean([v["psnr"] for v in per_view])), 4),
        "ssim": round(float(np.mean([v["ssim"] for v in per_view])), 5),
        "per_view": per_view,
    }
    if lpips_bundle is not None:
        report["lpips"] = round(
            float(np.mean([v["lpips"] for v in per_view])), 5)
    print(f"{args.split} @ step {report['step']}: "
          f"psnr={report['psnr']:.3f} ssim={report['ssim']:.4f}"
          + (f" lpips={report['lpips']:.4f}" if "lpips" in report else "")
          + f" over {report['n_views']} views")
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=2)
        print(f"report written to {args.out}")
    return report


if __name__ == "__main__":
    main()
