"""Config-file + CLI flag system (the port's own copy of the JAX package's
``config.py``).

The same flags, defaults and two-pass semantics: a ``--config <file>``
option reading ``key = value`` lines (``configs/*.txt``), CLI flags
overriding config-file values, every boolean flag settable from a file and
negatable with ``--no-<flag>``. One flag is the port's own: ``--device``
(default ``cuda``; the entry points never fall back to the CPU). Flags the
port does not carry yet parse as in the JAX package; ``cli.main`` refuses
them by name.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex

from cvnerf_torch.models.family import FAMILIES, family_named


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="cvnerf_torch: NeRF training/rendering on one "
                    "NVIDIA card (PyTorch + CUDA)")
    p.add_argument("--config", type=str, default=None,
                   help="config file path (key = value lines)")
    p.add_argument("--name", type=str, default="run",
                   help="experiment name")
    p.add_argument("--base_dir", type=str, default="./logs/",
                   help="where to store ckpts and logs")
    p.add_argument("--data_dir", type=str, default="./data/llff/fern",
                   help="input data directory")
    p.add_argument("--save_dir", type=str, default="./logs")

    p.add_argument("--n_rays", type=int, default=4096)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_decay", type=int, default=250)

    p.add_argument("--chunk", type=int, default=4096,
                   help="rays per render chunk (the reference's default "
                        "is 32768)")
    p.add_argument("--netchunk", type=int, default=1024 * 64,
                   help="accepted for reference parity; the fused "
                        "kernels have no separate network chunking")
    p.add_argument("--no_reload", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--ft_path", type=str, default=None)

    p.add_argument("--n_coarse_samples", type=int, default=64)
    p.add_argument("--n_fine_samples", type=int, default=0)
    p.add_argument("--perturb", type=float, default=1.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--noise_decay", type=int, default=0,
                   help="anneal the density-noise std linearly to zero by "
                        "this step (0 = constant noise for the whole run, "
                        "the reference's behavior). The regularizer is "
                        "needed early to escape dead-ReLU densities but "
                        "keeps perturbing converged geometry late on "
                        "sparse 360-degree captures")
    p.add_argument("--freq_anneal", type=float, default=None,
                   help="coarse-to-fine frequency annealing (FreeNeRF): "
                        "open the positional-encoding bands linearly "
                        "over this horizon — a value >= 1 is a step "
                        "count, a value in (0, 1) is a FRACTION of "
                        "--iters (the scale-invariant form of the "
                        "measured rule; 0.08 reproduces the 22.09 dB "
                        "run at any horizon). 0 = full spectrum from "
                        "step 0, the reference's behavior. KEEP THE "
                        "HORIZON SHORT — roughly <=10%% of the run: "
                        "measured on llff_360 @50k, horizon 4000 gains "
                        "+1.53 dB (22.09 best-val, the largest measured "
                        "quality lever on sparse 360-degree captures) "
                        "while horizon 25000 LOSES 1.39 dB (BASELINE.md "
                        "'Sparse-capture regularizers'). Pair with "
                        "--track_best: the gain peaks shortly after the "
                        "horizon. Eval/serving of mid-anneal "
                        "checkpoints applies the same window "
                        "automatically. Unset on a run dir that recorded "
                        "an anneal horizon: the recorded value sticks "
                        "(checkpoint window semantics must not flip on "
                        "re-invocation); pass 0 to override explicitly")
    p.add_argument("--distortion_loss", type=float, default=0.0,
                   help="weight of the mip-NeRF 360 distortion "
                        "regularizer on the fine pass (0 = off, the "
                        "reference loss). Pulls each ray's weight mass "
                        "into one compact cluster — targets floaters on "
                        "sparse 360-degree captures. WARNING: at "
                        "constant weight from step 0 this collapses "
                        "sparse-capture training to the empty-scene "
                        "basin (measured, BASELINE.md); pair it with "
                        "--distortion_start/--distortion_ramp. Even "
                        "ramped it measured -2.14 dB @3k on llff_360 — "
                        "experimental, not in any recommended recipe")
    p.add_argument("--distortion_start", type=int, default=0,
                   help="step at which the distortion weight starts "
                        "ramping from zero (delay past the early-"
                        "geometry phase; recommended 1000)")
    p.add_argument("--distortion_ramp", type=int, default=0,
                   help="number of steps over which the distortion "
                        "weight ramps linearly from 0 to "
                        "--distortion_loss after --distortion_start "
                        "(0 = constant weight; recommended 4000)")
    p.add_argument("--occlusion_loss", type=float, default=0.0,
                   help="EXPERIMENTAL — measured a regression on its "
                        "target scene (llff_360 @3k: -1.05 dB at 0.01, "
                        "-1.67 at 0.05; BASELINE.md 'Sparse-capture "
                        "regularizers'). Weight of the FreeNeRF "
                        "occlusion regularizer (0 = off, the reference "
                        "loss): penalizes compositing-weight mass in "
                        "the first --occlusion_frac of each ray's "
                        "[near, far] range. Unlike --distortion_loss "
                        "its minimum is an empty NEAR REGION, not an "
                        "empty ray, so it cannot collapse training")
    p.add_argument("--occlusion_frac", type=float, default=0.2,
                   help="normalized-depth window of --occlusion_loss")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="Polyak/EMA weight averaging: after every "
                        "optimizer update ema = ema*decay + "
                        "params*(1-decay); validation, test eval, "
                        "--render_only, serving and export then use the "
                        "average (the deployable model) while training "
                        "continues on the raw params. 0 = off (the "
                        "reference serves the raw last iterate). The "
                        "averaging window is ~1/(1-decay) steps — scale "
                        "it to the horizon (0.995 at 3k ~ 0.999 at 50k). "
                        "Unset on a run dir that recorded a decay: the "
                        "recorded value sticks so resume keeps updating "
                        "the same running average")

    p.add_argument("--render_only", action=argparse.BooleanOptionalAction, default=False)
    # (fractional --freq_anneal values are resolved to a step count by
    # resolve_freq_anneal below, applied in cli.main before the config
    # snapshot so scene.json always records concrete steps)
    p.add_argument("--render_test", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--render_factor", type=int, default=0)
    p.add_argument("--render_depth", action=argparse.BooleanOptionalAction, default=False,
                   help="also write a normalized-disparity video next to "
                        "each spiral rgb video (depth/acc extras the "
                        "reference discards)")

    p.add_argument("--precrop_iters", type=int, default=0)
    p.add_argument("--precrop_frac", type=float, default=0.5)

    p.add_argument("--testskip", type=int, default=8)

    p.add_argument("--white_bkg", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--half_res", action=argparse.BooleanOptionalAction, default=False)

    p.add_argument("--factor", type=int, default=8)
    p.add_argument("--no_ndc", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--spherify", action=argparse.BooleanOptionalAction, default=False,
                   help="spherify inward-facing LLFF captures (a working\n"
                        " extension; the reference parses but ignores this)")
    p.add_argument("--llffhold", type=int, default=8)

    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--vid_freq", type=int, default=5000)

    p.add_argument("--dtype", type=str, default="llff")

    # --- additions over the reference ---
    p.add_argument("--iters", type=int, default=100000,
                   help="training iterations (reference hardcodes 100000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bfloat16 MLP matmuls with fp32 accumulation "
                        "(default on; --no-bf16 restores the reference's "
                        "fp32 numerics)")
    p.add_argument("--ndc_variant", type=str, default="canonical",
                   choices=["canonical", "reference"],
                   help="NDC origin-shift formula (see SURVEY.md §2.3-3)")
    p.add_argument("--ckpt_freq", type=int, default=2500,
                   help="checkpoint cadence (the reference team's "
                        "historical cadence)")
    p.add_argument("--ckpt_keep", type=int, default=3,
                   help="checkpoints retained per directory (orbax "
                        "max_to_keep; the latest N periodic checkpoints, "
                        "and independently the N best-val ones under "
                        "--track_best)")
    p.add_argument("--track_best", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="save a separate best-validation checkpoint "
                        "(checkpoints_best/) and report held-out test "
                        "metrics at it alongside the final step — standard "
                        "model selection for sparse captures whose val "
                        "quality peaks before the end of training")
    p.add_argument("--val_freq", type=int, default=2500,
                   help="validation-PSNR cadence (0 disables)")
    p.add_argument("--deterministic_resample", action=argparse.BooleanOptionalAction, default=False,
                   help="evenly-spaced (non-stochastic) inverse-CDF "
                        "uniforms at eval time")
    p.add_argument("--sorted_resample", action=argparse.BooleanOptionalAction, default=True,
                   help="draw inverse-CDF uniforms pre-sorted per ray "
                        "(order-statistics construction; merge instead of "
                        "192-wide sort). --no-sorted_resample restores the "
                        "reference-shaped iid-draws-then-sort stream "
                        "(reference main.py:251)")
    p.add_argument("--occupancy", type=str, default=None,
                   choices=["merge", "full"],
                   help="render_only acceleration: bake an occupancy grid "
                        "from the restored checkpoint and render the pose "
                        "sequence through it ('merge' drops the coarse "
                        "MLP, 'full' also draws every fine sample from the "
                        "grid's CDF). Ignored during training (see "
                        "--occ_train)")
    p.add_argument("--occ_train",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="occupancy-accelerated training: after "
                        "--occ_train_warmup steps, bake an occupancy grid "
                        "from the fine net, replace the coarse MLP with its "
                        "probe (loss MSE(fine) only; the coarse net stops "
                        "training) and rebake every --occ_train_every "
                        "steps; serving enables the grid from scene.json")
    p.add_argument("--occ_train_warmup", type=int, default=2000,
                   help="reference-semantics steps before the occupancy "
                        "switch (the grid needs a roughly-right density "
                        "field to bake from)")
    p.add_argument("--occ_train_every", type=int, default=1000,
                   help="rebake cadence (steps) during --occ_train")
    p.add_argument("--occ_train_mode", default=None,
                   choices=["full", "merge"],
                   help="--occ_train sampling mode; unset: the run dir's "
                        "recorded mode, else 'merge'")
    p.add_argument("--occ_interp", default=None,
                   choices=["trilinear", "nearest"],
                   help="occupancy probe interpolation; unset: the run "
                        "dir's recorded probe, else 'nearest'")
    p.add_argument("--occ_floor", type=int, default=None,
                   help="full-mode occupancy sampling's stratified "
                        "coverage draws; unset: the run dir's recorded "
                        "floor, else 0")
    p.add_argument("--occupancy_res", type=int, default=192,
                   help="occupancy lattice resolution per axis")
    p.add_argument("--occupancy_bound", type=float, default=1.5,
                   help="half-width of the occupancy bake cube for "
                        "non-NDC scenes (NDC scenes use the NDC box)")
    p.add_argument("--int8",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="render_only: post-training-quantize the restored "
                        "nets to int8 and render through the fused int8 "
                        "kernel (ops.quantize; composes with --occupancy). "
                        "Ignored during training")
    p.add_argument("--int8_calib", type=int, default=1 << 17,
                   help="calibration sample count for --int8")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="path to an LPIPS weight bundle (.npz); "
                        "when given, held-out evals also report LPIPS "
                        "alongside PSNR/SSIM")
    p.add_argument("--debug_nans", action=argparse.BooleanOptionalAction, default=False,
                   help="autograd anomaly detection (NaN-producing "
                        "backward ops raise with their forward trace)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of 20 "
                        "steps here")
    p.add_argument("--pallas", type=str, default="auto",
                   choices=["auto", "on", "off", "interpret"],
                   help="fused MLP kernels: auto and on run them (their "
                        "plain versions on the CPU), off runs the plain "
                        "PyTorch MLP; interpret is refused (a Pallas "
                        "mode)")
    p.add_argument("--trunk_width", type=int, default=256,
                   help="MLP trunk width (reference fixes 256)")
    p.add_argument("--head_width", type=int, default=128,
                   help="view-dependent head width (reference fixes 128)")
    p.add_argument("--xyz_freqs", type=int, default=10,
                   help="positional-encoding L for xyz")
    p.add_argument("--dir_freqs", type=int, default=4,
                   help="positional-encoding L for view directions")
    p.add_argument("--model", type=str, default="nerf",
                   choices=list(FAMILIES),
                   help="the field: nerf (two MLPs, coarse and fine) or ngp "
                        "(Instant-NGP's hash grid and small MLPs at the "
                        "published widths, one field for both passes; "
                        "train it with --lr 1e-2)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process coordinator address host:port — one "
                        "process per card (NCCL; gloo under --device cpu); "
                        "also via JAX_COORDINATOR_ADDRESS")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host process count (with --coordinator)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this host's process index (with --coordinator)")
    p.add_argument("--pixel_sampling", type=str, default="prp",
                   choices=["prp", "parity", "replace"],
                   help="per-step pixel draw: prp = without replacement via "
                        "a keyed Feistel permutation (O(n_rays)); parity = "
                        "a uniform choice without replacement (O(H*W) "
                        "sort, the reference's exact semantics); replace = "
                        "with replacement")
    p.add_argument("--ray_batching",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="cross-image ray batching (flag-gated deviation): "
                        "each step samples n_rays (image, pixel) pairs "
                        "jointly without replacement over the WHOLE train "
                        "split instead of the reference's one-random-image-"
                        "per-step — the original NeRF paper's training mode "
                        "for real multi-view captures (de-correlated "
                        "batches). Precrop warm-up steps keep single-image "
                        "center-crop semantics")
    p.add_argument("--steps_per_call", type=int, default=10,
                   help="train steps per dispatch: a block of this many "
                        "steps runs as CUDA-graph replays on a card (the "
                        "JAX package's lax.scan block), bitwise the single "
                        "steps; 1 runs single steps")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and render on (default "
                        "cuda; pass cpu to run on the CPU)")
    return p


# Boolean flags. Parsed with argparse.BooleanOptionalAction so a value set
# true in a config file CAN be overridden back off from the CLI with
# ``--no-<flag>`` (plain store_true has no negative form, which silently
# broke the "CLI overrides config file" contract).
def _bool_flags(parser: argparse.ArgumentParser) -> set[str]:
    """Boolean flag names, derived from the parser itself.

    Was a hand-maintained set once — which silently drifted the first time
    a new boolean flag landed (``occ_train = True`` in a config file was
    rejected as ``unrecognized arguments``). Deriving from the registered
    actions makes every BooleanOptionalAction config-file-settable by
    construction.
    """
    return {a.dest for a in parser._actions
            if isinstance(a, argparse.BooleanOptionalAction)}


def _config_file_to_argv(path: str, bool_flags: set[str]) -> list[str]:
    """``key = value`` lines → argv fragments (configargparse semantics for
    the subset the reference configs use: scalars and booleans)."""
    argv: list[str] = []
    with open(path) as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"{path}: bad config line {line!r}")
            key, value = (s.strip() for s in line.split("=", 1))
            if key in bool_flags:
                if value.lower() in ("true", "1", "yes"):
                    argv.append(f"--{key}")
                elif value.lower() in ("false", "0", "no"):
                    argv.append(f"--no-{key}")
                else:
                    raise ValueError(f"{path}: bad boolean {line!r}")
            else:
                argv.extend([f"--{key}", *shlex.split(value)])
    return argv


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Two-pass parse: config file values first, CLI flags override."""
    parser = build_parser()
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        file_argv = _config_file_to_argv(pre.config, _bool_flags(parser))
        args = parser.parse_args(file_argv)
        args = parser.parse_args(argv, namespace=args)
    else:
        args = parser.parse_args(argv)
    return args


def resolve_freq_anneal(value: float | None, iters: int) -> int | None:
    """Resolve the ``--freq_anneal`` flag to a concrete step count.

    A value in (0, 1) is a FRACTION of the run — the scale-invariant form
    of the measured horizon rule (a ~8%-of-the-run horizon gains +1.53 dB
    on llff_360 where a 50% horizon loses 1.39; BASELINE.md
    "Sparse-capture regularizers"). A value >= 1 is a step count. None
    passes through (run-dir stickiness is resolved later, in cli.main).
    Everything downstream (the static TrainConfig field, the scene.json
    serving window, the torch exporter) sees concrete integer steps.
    """
    if value is None:
        return None
    if 0 < value < 1:
        return max(1, round(value * iters))
    return int(value)


def snapshot_config(args: argparse.Namespace, run_dir: str) -> str:
    """Write the fully-resolved config to the run directory (a NeRF run's
    without ``--model``, so that it is the JAX CLI's)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config_resolved.json")
    out = dict(vars(args))
    if family_named(out.get("model")).tag is None:
        out.pop("model", None)
    with open(path, "w") as fp:
        json.dump(out, fp, indent=2, sort_keys=True)
    return path
