"""The port's command line: config-driven NeRF training and rendering on
NVIDIA cards (port of the JAX package's ``cli.py``)::

    python -m cvnerf_torch.cli --config configs/lego.txt
    python -m cvnerf_torch.cli --config configs/demo_sphere.txt --device cpu

The run follows the JAX package's CLI step by step, with the same prints,
the same ``metrics.jsonl`` records and the same keys (``PRNGKey(seed)``
for the steps, 123 for validation, 7 for test, ``seed + 1`` for videos):
load the scene; write ``config_resolved.json`` and ``scene.json``; start
fresh, fine-tune from ``--ft_path`` or resume from the newest checkpoint
under ``<run>/torch_checkpoints`` (``train/checkpoint.py``); train through the
fused kernels with periodic logs, asynchronous checkpoints, spiral videos
and validation (``--track_best`` keeps the best-validation model); save a
final checkpoint and score the held-out test views. ``--render_only``
renders the restored model (``--int8``: through the int8 kernel).

The JAX trainer's levers run as there: ``--ema_decay`` (validation,
videos, the test eval and ``--render_only`` read the Polyak average),
``--noise_decay``, ``--freq_anneal`` (those renders go through the step's
frequency window), ``--distortion_loss`` with ``--distortion_start`` and
``--distortion_ramp``, ``--occlusion_loss`` with ``--occlusion_frac``,
``--ray_batching`` and ``--pixel_sampling parity``. A run directory's
recorded ``freq_anneal`` and ``ema_decay`` stay in force when a later
invocation omits the flag, with the JAX CLI's messages.

Occupancy training (``--occ_train``) runs as in the JAX CLI: after
``--occ_train_warmup`` steps a callback (registered first, so validation
and videos render through the fresh grid) bakes a grid from the fine net
every ``--occ_train_every`` steps and the trainer switches to the
occupancy step; ``metrics.jsonl`` records each verdict. The run
directory's ``scene.json`` records the bake and the sampling mode, probe
and floor, which stay in force when a later invocation omits them; a
plain re-invocation keeps the record (``--no_reload`` drops it), and
``--render_only`` renders such a run through a grid (``--occupancy``
renders any run so). ``--lpips_weights`` adds LPIPS to the held-out
scores (``utils/lpips.py``).

Data parallelism runs as in the JAX CLI: ``--coordinator host:port
--num_processes N --process_id i`` (or the JAX package's environment
variables) start a process group before anything else (NCCL with one
rank a card, or gloo under ``--device cpu``), and the trainer always
takes the ``'rays'`` mesh (``parallel/mesh.py``: every local card of a
single process, else one shard a rank); frames are sharded over it
where it has more than one shard. Adaptation: **only rank 0 writes the
run directory** (``config_resolved.json``, ``scene.json``,
``metrics.jsonl``, checkpoints, ``best.json``, frames, videos, the
profiler trace); the JAX package leaves that to orbax, and two ranks
appending one ``metrics.jsonl`` would corrupt it. The other ranks read
the shared run directory (resume, ``--ft_path``, the best checkpoint)
and enter every sharded render (validation, the test eval, videos,
occupancy bakes), so no collective is left waiting; each computes the
same validation PSNR from its gathered frame, so ``--track_best``
decides alike on every rank. The CLI destroys the process group it
started when it returns.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

class _NoWriter:
    """What a rank other than 0 holds in place of the run directory's
    writers (metrics logger, checkpointers): every write is a no-op."""

    def log(self, *args, **kwargs) -> None:
        pass

    log_image = save = wait = close = log


def _snapshot(run_dir: str) -> dict:
    """The run directory's ``scene.json``, read defensively: a missing or
    foreign file gives an empty dict."""
    try:
        with open(os.path.join(run_dir, "scene.json")) as fp:
            snap = json.load(fp)
    except (OSError, ValueError):
        return {}
    return snap if isinstance(snap, dict) else {}


def _recorded_levers(run_dir: str) -> tuple[int | None, float | None]:
    """``(freq_anneal, ema_decay)`` as the run directory recorded them, or
    None each (a JSON boolean counts as missing)."""
    snap = _snapshot(run_dir)

    def num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    fa, ema = snap.get("freq_anneal"), snap.get("ema_decay")
    return (int(fa) if num(fa) else None,
            float(ema) if num(ema) else None)


def resolve_levers(args, run_dir: str) -> None:
    """Resolve ``--freq_anneal`` and ``--ema_decay`` against what the run
    directory recorded, with the JAX CLI's rules and messages: an omitted
    flag keeps the recorded value; a fraction of ``--iters`` resolves to
    steps, but a recorded horizon stays when the fraction would move it;
    an explicit 0 drops the record, loudly; ``--no_reload`` ignores the
    record. Then validates ``--ema_decay`` and ``--occlusion_frac`` before
    anything is recorded."""
    from cvnerf_torch.config import resolve_freq_anneal
    recorded_fa, recorded_ema = _recorded_levers(run_dir)
    if args.no_reload:
        if recorded_fa:
            print(f"freq_anneal: ignoring the run dir's recorded horizon "
                  f"{recorded_fa} for this fresh (--no_reload) run")
        if recorded_ema:
            print(f"ema: ignoring the run dir's recorded decay "
                  f"{recorded_ema} for this fresh (--no_reload) run")
        recorded_fa = recorded_ema = None
    if args.freq_anneal is not None:
        given = args.freq_anneal
        args.freq_anneal = resolve_freq_anneal(given, args.iters)
        if 0 < given < 1:
            if recorded_fa and args.freq_anneal != recorded_fa:
                # The fraction states the rule, not a new horizon: moving
                # it would re-window every existing checkpoint.
                print(f"freq_anneal: fractional horizon {given} would "
                      f"resolve to {args.freq_anneal} at --iters "
                      f"{args.iters}, but this run dir recorded "
                      f"{recorded_fa} — keeping the recorded horizon "
                      f"(pass an explicit step count to re-window)")
                args.freq_anneal = recorded_fa
            else:
                print(f"freq_anneal: fractional horizon {given} resolved "
                      f"to {args.freq_anneal} steps ({args.iters} iters)")
    if args.freq_anneal is None:
        args.freq_anneal = recorded_fa or 0
        if recorded_fa:
            print(f"freq_anneal: using the run dir's recorded anneal "
                  f"horizon {recorded_fa} (pass --freq_anneal 0 to "
                  f"override)")
    elif args.freq_anneal == 0 and recorded_fa:
        print(f"WARNING: --freq_anneal 0 drops this run dir's recorded "
              f"anneal horizon ({recorded_fa}) from scene.json; "
              f"checkpoints trained mid-anneal will render un-windowed "
              f"from now on. Re-pass --freq_anneal {recorded_fa} to "
              f"restore the record.")
    if args.ema_decay is None:
        args.ema_decay = recorded_ema or 0.0
        if recorded_ema:
            print(f"ema: using the run dir's recorded decay "
                  f"{recorded_ema} (pass --ema_decay 0 to override)")
    elif args.ema_decay == 0 and recorded_ema:
        print(f"WARNING: --ema_decay 0 on a run dir that recorded decay "
              f"{recorded_ema}: the stored running average is dropped and "
              f"later checkpoints serve the raw params. Re-pass "
              f"--ema_decay {recorded_ema} to keep averaging.")
    if not 0.0 <= args.ema_decay < 1.0:
        raise SystemExit(f"--ema_decay must be in [0, 1), got "
                         f"{args.ema_decay}")
    if args.occlusion_loss > 0 and not 0.0 < args.occlusion_frac < 1.0:
        raise SystemExit(
            f"--occlusion_frac must be in (0, 1), got "
            f"{args.occlusion_frac}: at frac >= 1 the near-window penalty "
            f"covers the whole ray and becomes the empty-scene objective "
            f"the distortion regularizer was measured to collapse into")


def resolve_occupancy(args, run_dir: str) -> dict | None:
    """Resolve the occupancy flags against the run directory's recorded
    ``occ_train``, with the JAX CLI's rules and messages: an unset
    ``--occ_train_mode``, ``--occ_interp`` or ``--occ_floor`` takes the
    recorded value (a record without the field: ``full``, ``nearest``, 0),
    else ``merge``, ``nearest``, 0; ``--no_reload`` ignores the record. A
    plain re-invocation of an occupancy-trained run keeps the record in
    ``scene.json`` (its checkpoints carry an untrained coarse net):
    returns that record, else None."""
    snap = _snapshot(run_dir)
    recorded = snap.get("occ_train")
    recorded = dict(recorded) if isinstance(recorded, dict) else None
    sticky = None if args.no_reload else recorded
    if args.occ_train_mode is None:
        mode = sticky.get("mode", "full") if sticky is not None else None
        args.occ_train_mode = mode or "merge"
        if mode and args.occ_train:
            print(f"occ_train: using the run dir's recorded sampling mode "
                  f"{mode!r} (pass --occ_train_mode to override)")
    if args.occ_interp is None:
        args.occ_interp = (sticky.get("interp", "nearest")
                           if sticky is not None else "nearest")
    if args.occ_floor is None:
        args.occ_floor = sticky.get("floor", 0) if sticky is not None else 0
    if recorded is None or args.occ_train:
        return None
    if args.no_reload:
        print("[WARN] run dir recorded --occ_train but this fresh "
              "(--no_reload) run is plain: dropping the occupancy "
              "serving metadata from scene.json")
        return None
    print("[WARN] run dir recorded --occ_train but this invocation "
          "omits it: preserving the occupancy serving metadata in "
          "scene.json (the existing checkpoints carry an untrained "
          "coarse net). Pass --no_reload for a fresh plain run.")
    return recorded


def main(argv=None):
    """Run the CLI; returns the run's final metrics (with the test
    scores), or under ``--render_only`` the rendered step and, with
    ``--render_test``, the test scores."""
    from cvnerf_torch.config import parse_args
    args = parse_args(argv)
    if args.pallas == "interpret":
        raise ValueError("--pallas interpret is a Pallas mode: the port runs "
                         "its kernels (auto, on) or the plain PyTorch MLP "
                         "(off)")
    run_dir = os.path.join(args.base_dir, args.name)

    import torch
    import torch.distributed as dist
    from cvnerf_torch import resolve_device
    from cvnerf_torch.parallel.mesh import initialize_distributed
    # Several processes (opt-in): the process group comes first.
    started = initialize_distributed(args.coordinator, args.num_processes,
                                     args.process_id, device=args.device)
    try:
        if started:
            print(f"Distributed: process {dist.get_rank()} of "
                  f"{dist.get_world_size()}")
        dev = resolve_device(args.device)
        anomaly = torch.is_anomaly_enabled()
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        try:
            return _run(args, dev, run_dir)
        finally:
            torch.autograd.set_detect_anomaly(anomaly)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, dev, run_dir: str) -> dict:
    import dataclasses

    import torch

    from cvnerf_torch.config import snapshot_config
    from cvnerf_torch.data.datasets import load_scene
    from cvnerf_torch.models.family import family_named
    from cvnerf_torch.models.nerf_mlp import anneal_model_params
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.parallel.mesh import make_mesh
    from cvnerf_torch.render.frames import (FramePrograms,
                                            render_poses_to_frames)
    from cvnerf_torch.render.occupancy import (bake_scene_occupancy,
                                               occupied_fraction)
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.serve import CKPT_SUBDIR, write_scene_snapshot
    from cvnerf_torch.train.checkpoint import (Checkpointer, latest_step,
                                               restore_checkpoint)
    from cvnerf_torch.train.loop import TrainConfig, Trainer
    from cvnerf_torch.train.state import create_train_state, make_lr_schedule
    from cvnerf_torch.utils.image import (psnr_images, ssim_images,
                                          write_png, write_video)
    from cvnerf_torch.utils.lpips import lpips_images, load_weights
    from cvnerf_torch.utils.metrics import MetricsLogger

    # --- data ---
    scene = load_scene(
        args.data_dir, args.dtype, half_res=args.half_res,
        testskip=args.testskip, white_bkg=args.white_bkg,
        factor=args.factor, no_ndc=args.no_ndc, llffhold=args.llffhold,
        spherify=args.spherify)
    print(f"Loaded {args.dtype} scene: {scene.images.shape[0]} images "
          f"{scene.height}x{scene.width} focal={scene.focal:.2f} "
          f"near={scene.near:.3f} far={scene.far:.3f} ndc={scene.ndc}")

    render_poses = scene.render_poses
    if args.render_test:
        render_poses = scene.poses[scene.test_idx]

    # One shard per local card, or per rank of a process group; only rank
    # 0 writes (see the module docstring).
    mesh = make_mesh(device=dev)
    writer = not mesh.distributed or mesh.first == 0

    # --- run dirs & config snapshot ---
    save_dir = os.path.join(args.save_dir, args.name)
    resolve_levers(args, run_dir)
    preserve_occ = resolve_occupancy(args, run_dir)
    # Every rank has read the run directory's records before rank 0
    # rewrites them.
    mesh.barrier()
    if writer:
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(save_dir, exist_ok=True)
        snapshot_config(args, run_dir)
    ckpt_dir = os.path.join(run_dir, CKPT_SUBDIR)
    if args.netchunk != 1024 * 64:
        print(f"--netchunk {args.netchunk} is accepted without effect: the "
              "port has no separate network chunking")

    # --- model / state ---
    family = family_named(args.model)
    mlp = family.config_from_args(args, scene.ndc)
    refused = family.refused(occ_train=args.occ_train, occupancy=args.occupancy,
                             int8=args.int8, freq_anneal=args.freq_anneal > 0)
    if refused:
        sys.exit(f"--model {args.model} trains and renders without "
                 f"{', '.join('--' + lv for lv in refused)} (NeRF's levers)")
    if args.occ_train and args.n_fine_samples <= 0:
        sys.exit("--occ_train requires n_fine_samples > 0 (occupancy "
                 "sampling resamples n_fine points from the grid probe "
                 "CDF)")
    if args.occ_train and args.occ_train_every <= 0:
        sys.exit("--occ_train_every must be > 0: the switch to occupancy "
                 "training happens inside the rebake callback, so a "
                 "non-positive cadence would silently never switch")
    rcfg_train = RenderConfig(
        n_coarse=args.n_coarse_samples, n_fine=args.n_fine_samples,
        perturb=args.perturb > 0, noise_std=args.noise,
        white_bkg=args.white_bkg, mlp=mlp,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        sorted_resample=args.sorted_resample,
        kernels="off" if args.pallas == "off" else "on",
        occupancy_mode=args.occ_train_mode if args.occ_train else "merge",
        occupancy_interp=args.occ_interp,
        occ_floor=args.occ_floor if args.occ_train else 0)
    rcfg_test = rcfg_train.eval_mode()
    if args.deterministic_resample:
        rcfg_test = dataclasses.replace(rcfg_test,
                                        deterministic_resample=True)

    if writer:
        kept = preserve_occ or {}
        write_scene_snapshot(
            run_dir, height=scene.height, width=scene.width,
            focal=scene.focal, near=scene.near, far=scene.far,
            ndc=scene.ndc, ndc_variant=args.ndc_variant,
            white_bkg=args.white_bkg, n_coarse=args.n_coarse_samples,
            n_fine=args.n_fine_samples, bf16=args.bf16, mlp=mlp,
            sorted_resample=args.sorted_resample, pallas=args.pallas,
            calib_poses=scene.poses,
            occ_train=args.occ_train or preserve_occ is not None,
            occ_res=kept.get("resolution", args.occupancy_res),
            occ_bound=kept.get("bound", args.occupancy_bound),
            occ_mode=kept.get("mode", args.occ_train_mode),
            occ_interp=kept.get("interp", args.occ_interp),
            occ_floor=kept.get("floor", args.occ_floor),
            freq_anneal=args.freq_anneal, ema_decay=args.ema_decay)

    # The JAX CLI's nets for the same --seed, bit for bit.
    state = create_train_state(PRNGKey(args.seed), lr=args.lr,
                               lr_decay=args.lr_decay, mlp=mlp, device=dev,
                               ema=args.ema_decay > 0)

    def deploy_params(st) -> dict:
        """The deployable weights of a state: the Polyak average of an EMA
        run, else the params. Validation, videos, the test eval and
        --render_only read them."""
        return st.ema_params if st.ema_params is not None else st.params

    def render_params(params: dict, step: int) -> dict:
        """The weights as the loss saw them at ``step``: through the
        frequency window inside the anneal horizon, else as they are."""
        if args.freq_anneal > 0 and step < args.freq_anneal:
            return anneal_model_params(params, mlp, step / args.freq_anneal)
        return params

    best_meta_path = os.path.join(run_dir, "best.json")

    def backup_stale_ckpts(reason: str) -> None:
        # Move the run dir's existing checkpoints (and the best-val ones
        # with their best.json) aside so this run's lower-step saves are
        # neither refused nor shadowed at resume time.
        if not writer:
            return
        best_dir = ckpt_dir + "_best"
        have_main = os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir)
        have_best = ((os.path.isdir(best_dir) and os.listdir(best_dir))
                     or os.path.exists(best_meta_path))
        if not (have_main or have_best):
            return
        step = latest_step(ckpt_dir if have_main else best_dir) or 0
        base = f"{ckpt_dir}.bak-{step}"
        backup, k = base, 1
        while any(os.path.exists(p) for p in
                  (backup, backup + "_best", backup + ".best.json")):
            backup = f"{base}.{k}"   # repeated restarts at the same step
            k += 1
        if have_main:
            os.rename(ckpt_dir, backup)
        for extra, dst in ((best_dir, backup + "_best"),
                           (best_meta_path, backup + ".best.json")):
            if os.path.exists(extra):
                os.rename(extra, dst)
        print(f"{reason}: moved existing checkpoints to {backup}")

    start = 0
    if args.ft_path:
        restored = restore_checkpoint(args.ft_path, state)
        if restored is None:
            sys.exit(f"--ft_path {args.ft_path}: no checkpoint found")
        state, start = restored, int(restored.step)
        print(f"Restored fine-tune checkpoint at step {start}")
        newest_here = max(latest_step(ckpt_dir) or -1,
                          latest_step(ckpt_dir + "_best") or -1)
        if os.path.abspath(args.ft_path) != os.path.abspath(ckpt_dir) and \
                newest_here > start:
            backup_stale_ckpts("--ft_path behind existing checkpoints")
    elif not args.no_reload:
        restored = restore_checkpoint(ckpt_dir, state)
        # Crash recovery: a run that died before its first periodic save
        # may have left a newer best-val checkpoint (a full TrainState).
        best_step = latest_step(ckpt_dir + "_best")
        if best_step is not None and best_step > (
                int(restored.step) if restored is not None else -1):
            best_restored = restore_checkpoint(ckpt_dir + "_best", state,
                                               step=best_step)
            if best_restored is not None:
                restored = best_restored
                print(f"Periodic checkpoints are behind the best-val "
                      f"checkpoint (step {best_step}) — resuming from best")
        if restored is not None:
            state, start = restored, int(restored.step)
            print(f"Resumed from checkpoint at step {start}")
    else:
        backup_stale_ckpts("--no_reload")

    print(f"Device mesh: {mesh.size} x {dev.type}")
    # Frames shard only over a mesh of several shards; the trainer always
    # takes the mesh.
    frame_mesh = mesh if mesh.size > 1 else None

    render_chunk = args.chunk
    # The run's frame programs: validation, test and spiral frames of one
    # shape replay one captured program, whatever weights they render.
    programs = FramePrograms()

    def spiral_video(step: int, nets: dict, occupancy=None) -> np.ndarray:
        frame_dir = os.path.join(save_dir, f"spiral_{step:06d}")

        def on_frame(i, rgb):
            write_png(os.path.join(frame_dir, f"{i:03d}.png"), rgb)

        keys = ("rgb", "depth", "acc") if args.render_depth else ("rgb",)
        out_frames = render_poses_to_frames(
            nets, render_poses, scene.height, scene.width, scene.focal,
            scene.near, scene.far, rcfg_test, ndc=scene.ndc,
            ndc_variant=args.ndc_variant, chunk=render_chunk,
            factor=args.render_factor,
            on_frame=on_frame if writer else None, frame_keys=keys,
            device=dev, key=PRNGKey(args.seed + 1), occupancy=occupancy,
            mesh=frame_mesh, programs=programs)
        frames = out_frames if not args.render_depth else out_frames["rgb"]
        if not writer:
            return frames
        out = write_video(
            os.path.join(save_dir, f"{args.name}_spiral_{step:06d}_rgb.mp4"),
            frames, fps=30)
        print(f"Wrote video: {out} ({frames.shape[0]} frames)")
        if args.render_depth:
            # Normalized disparity (1 / opacity-corrected expected depth),
            # grayscale → 3 channels for the mp4 writer.
            depth, acc = out_frames["depth"], out_frames["acc"]
            disp = 1.0 / np.maximum(depth / np.maximum(acc, 1e-6), 1e-6)
            disp = disp * (acc > 1e-3)           # background → 0
            disp = disp / max(disp.max(), 1e-6)
            disp_path = os.path.join(
                save_dir, f"{args.name}_spiral_{step:06d}_disp.mp4")
            write_video(disp_path, np.repeat(disp[..., None], 3, -1), fps=30)
            print(f"Wrote video: {disp_path}")
        return frames

    def _split_heldout_views() -> tuple[np.ndarray, np.ndarray]:
        """(val_views, test_views): ≤4 validation and ≤8 test views, split
        as the JAX CLI splits them (a dataset without a separate val
        split — LLFF — partitions its held-out views under --track_best,
        so model selection and the test score never share an image)."""
        empty = np.zeros((0,), np.int64)
        vi = np.asarray(scene.val_idx)
        ti = np.asarray(scene.test_idx)
        if len(vi) and (len(ti) == 0 or not np.array_equal(vi, ti)):
            return vi[:4], ti[:8]          # genuinely separate splits
        held = ti if len(ti) else vi
        if len(held) == 0:
            return empty, empty
        if len(held) == 1:
            return held.copy(), held.copy()
        if args.track_best:
            val = held[1::2][:4]
            test = np.asarray(
                [t for t in held if t not in set(val.tolist())])
            return val, test[:8]
        return held[1:5], held[:8]

    val_views, test_views = _split_heldout_views()

    # LPIPS (weights pluggable): a bad path fails here, not at the final
    # eval; frames below AlexNet's 32 px support score PSNR/SSIM alone.
    lpips_bundle = None
    if args.lpips_weights:
        lpips_bundle = load_weights(args.lpips_weights, dev)
        if min(scene.height, scene.width) < 32:
            print(f"[WARN] --lpips_weights ignored: {scene.height}x"
                  f"{scene.width} frames are below the 32px AlexNet-LPIPS "
                  "minimum")
            lpips_bundle = None

    def _lpips(rgb, gt) -> float | None:
        if lpips_bundle is None:
            return None
        return lpips_images(rgb, np.asarray(gt)[..., :3], lpips_bundle)

    def score_views(nets: dict, views, key_seed: int, occupancy=None):
        """Mean PSNR/SSIM (and LPIPS with ``--lpips_weights``, else None)
        over ``views`` rendered with ``PRNGKey(key_seed)``; returns (psnr,
        ssim, first rgb, lpips)."""
        psnrs, ssims, lps, rgb0 = [], [], [], None
        for i in views:
            rgb = programs(
                nets, scene.height, scene.width, scene.focal,
                torch.as_tensor(scene.poses[int(i)]), scene.near, scene.far,
                rcfg_test, device=dev,
                take=lambda out: out["rgb"].to("cpu", copy=True).numpy(),
                ndc=scene.ndc,
                ndc_variant=args.ndc_variant, chunk=render_chunk,
                key=PRNGKey(key_seed), occupancy=occupancy, mesh=frame_mesh)
            rgb0 = rgb if rgb0 is None else rgb0
            psnrs.append(psnr_images(rgb, scene.images[int(i)]))
            ssims.append(ssim_images(rgb, scene.images[int(i)]))
            lp = _lpips(rgb, scene.images[int(i)])
            if lp is not None:
                lps.append(lp)
        return (float(np.mean(psnrs)), float(np.mean(ssims)), rgb0,
                float(np.mean(lps)) if lps else None)

    # --- render-only mode ---
    if args.render_only:
        if args.track_best and not args.ft_path:
            # The deployable model of a --track_best run is its best-val
            # checkpoint; --no-track_best renders the last one.
            best_restored = restore_checkpoint(ckpt_dir + "_best", state)
            if best_restored is not None and \
                    int(best_restored.step) != int(state.step):
                state, start = best_restored, int(best_restored.step)
                print(f"--render_only on a --track_best run: rendering "
                      f"the best-val model (step {start}); pass "
                      f"--no-track_best for the last checkpoint")
        params = render_params(deploy_params(state), start)
        nets = family.frame_nets(params, rcfg_test)
        occ = None
        if (args.occ_train or preserve_occ is not None) and not args.occupancy:
            # An --occ_train run's checkpoints carry an untrained coarse
            # net: render them the way they were trained.
            args.occupancy = ((preserve_occ or {}).get("mode")
                              or args.occ_train_mode)
            if preserve_occ is not None:
                args.occupancy_res = preserve_occ.get(
                    "resolution", args.occupancy_res)
                args.occupancy_bound = preserve_occ.get(
                    "bound", args.occupancy_bound)
                print(f"--render_only: rendering through the run dir's "
                      f"recorded occupancy mode {args.occupancy!r}")
        if args.occupancy:
            occ = bake_scene_occupancy(
                params, mlp, ndc=scene.ndc, bound=args.occupancy_bound,
                n_fine=args.n_fine_samples, resolution=args.occupancy_res,
                compute_dtype=rcfg_test.compute_dtype,
                kernels=rcfg_test.kernels, mesh=frame_mesh)
            if occupied_fraction(occ) <= 0.0:
                # A grid with no support would give every ray the
                # ε-uniform fallback CDF; grid-less rendering is defined.
                print("[WARN] occupancy bake found no positive density — "
                      "rendering grid-less", flush=True)
                occ = None
            else:
                rcfg_test = dataclasses.replace(
                    rcfg_test, occupancy_mode=args.occupancy)
                print(f"occupancy grid active: mode={args.occupancy} "
                      f"res={args.occupancy_res}")
        if args.int8:
            from cvnerf_torch.ops.fused_mlp_int8 import QuantizedNerfWeights
            from cvnerf_torch.ops.quantize import (quantize_nerf,
                                                   ray_calibration_samples)
            # Calibrate on real rays through every pose the run knows.
            pts, dirs = ray_calibration_samples(
                PRNGKey(0), args.int8_calib, scene.poses, scene.height,
                scene.width, scene.focal, scene.near, scene.far,
                ndc=scene.ndc, ndc_variant=args.ndc_variant, device=dev)
            qs = {k: quantize_nerf(v, mlp, pts, dirs)
                  for k, v in params.items()}
            nets = (qs if rcfg_test.kernels == "off" else
                    {k: QuantizedNerfWeights(q, mlp) for k, q in qs.items()})
            print(f"int8 quantized rendering active "
                  f"(calibrated on {args.int8_calib} ray samples)")
        frames = spiral_video(start, nets, occupancy=occ)
        result = {"step": start}
        if args.render_test and not args.render_factor:
            # The render of the held-out poses is the evaluation.
            test_idx = np.asarray(scene.test_idx)
            result["test_psnr"] = float(np.mean(
                [psnr_images(frames[k], scene.images[int(i)])
                 for k, i in enumerate(test_idx)]))
            result["test_ssim"] = float(np.mean(
                [ssim_images(frames[k], scene.images[int(i)])
                 for k, i in enumerate(test_idx)]))
            lps = [_lpips(frames[k], scene.images[int(i)])
                   for k, i in enumerate(test_idx)]
            lp_txt = ""
            if lps and lps[0] is not None:
                result["test_lpips"] = float(np.mean(lps))
                lp_txt = f" test_lpips={result['test_lpips']:.4f}"
            print(f"render_test @ step {start}: test_psnr="
                  f"{result['test_psnr']:.3f} "
                  f"test_ssim={result['test_ssim']:.4f}{lp_txt} "
                  f"({len(test_idx)} views)")
        return result

    # --- training ---
    tcfg = TrainConfig(
        height=scene.height, width=scene.width, focal=scene.focal,
        near=scene.near, far=scene.far, n_rays=args.n_rays, lr=args.lr,
        lr_decay=args.lr_decay, precrop_iters=args.precrop_iters,
        precrop_frac=args.precrop_frac, ndc=scene.ndc,
        ndc_variant=args.ndc_variant, pixel_sampling=args.pixel_sampling,
        noise_decay=args.noise_decay, ray_batching=args.ray_batching,
        freq_anneal=args.freq_anneal, distortion_loss=args.distortion_loss,
        distortion_start=args.distortion_start,
        distortion_ramp=args.distortion_ramp,
        occlusion_loss=args.occlusion_loss,
        occlusion_frac=args.occlusion_frac, ema_decay=args.ema_decay,
        render=rcfg_train)
    trainer = Trainer(tcfg, state, scene.images, scene.poses,
                      scene.train_idx, seed=args.seed, mesh=mesh,
                      steps_per_call=args.steps_per_call)
    logger = MetricsLogger(run_dir) if writer else _NoWriter()

    occ_bake = None
    if args.occ_train:
        def occ_bake(params):
            return bake_scene_occupancy(
                params, mlp, ndc=scene.ndc, bound=args.occupancy_bound,
                n_fine=args.n_fine_samples, resolution=args.occupancy_res,
                compute_dtype=rcfg_train.compute_dtype,
                kernels=rcfg_train.kernels)

        if start >= args.occ_train_warmup:
            # Resumed past the warm-up: re-enter occupancy training now,
            # through a grid rebaked from the restored params (so the
            # resume is step-aligned, not bitwise).
            verdict = trainer.maybe_set_occupancy(
                occ_bake(render_params(trainer.state.params, start)))
            if verdict == "postponed":
                print("occ_train: baked grid is empty at resume — staying "
                      "on reference-semantics training until a rebake "
                      "finds a surface")
            else:
                print(f"occ_train: occupancy training active from step "
                      f"{start} (res={args.occupancy_res})")

    lr_sched = make_lr_schedule(args.lr, args.lr_decay)
    dead_warned = [False]

    def log_cb(i, tr, m):
        extra = {k: m[k] for k in ("grad_norm",) if m.get(k) is not None}
        logger.log(i, loss=m["loss"], psnr=m["psnr"],
                   rays_per_sec=m["rays_per_sec"],
                   lr=float(lr_sched(i)), **extra)
        if (not dead_warned[0] and m.get("grad_norm") == 0.0
                and m.get("loss", 0.0) > 0.0):
            # An exactly-zero gradient with a nonzero loss: the density
            # field went non-positive everywhere (dead ReLUs).
            dead_warned[0] = True
            print(f"[WARN] zero gradient with nonzero loss at step {i}: "
                  f"the density field has likely collapsed (dead-ReLU "
                  f"regime) — try a lower --lr, --noise > 0, or more "
                  f"training views", flush=True)

    # One writer for the whole run; saves overlap the following steps.
    if args.ckpt_keep < 1:
        sys.exit("--ckpt_keep must be >= 1 (retention of zero checkpoints "
                 "would make every save a no-op)")
    ckpt_writer = (Checkpointer(ckpt_dir, max_to_keep=args.ckpt_keep)
                   if writer else _NoWriter())

    # Best-validation model selection (--track_best); the best score
    # persists in best.json, so a resumed run compares against it.
    best = {"psnr": float("-inf"), "step": None}
    best_writer = None
    if args.track_best and args.val_freq > 0:
        best_writer = (Checkpointer(ckpt_dir + "_best",
                                    max_to_keep=args.ckpt_keep)
                       if writer else _NoWriter())
    if best_writer is not None and os.path.exists(best_meta_path) and \
            (latest_step(ckpt_dir + "_best") is not None):
        with open(best_meta_path) as fp:
            best = json.load(fp)
        print(f"Resuming best-val tracking: {best['psnr']:.3f} dB at "
              f"step {best['step']}")

    def ckpt_cb(i, tr, m):
        ckpt_writer.save(tr.state)
        print(f"Checkpoint save enqueued at step {i}")

    def _non_fatal(fn):
        # Eval and render failures must not kill training.
        def wrapped(i, tr, m):
            try:
                fn(i, tr, m)
            except Exception as e:  # noqa: BLE001
                print(f"[WARN] callback {fn.__name__} failed at step {i}: "
                      f"{e!r}", flush=True)
        return wrapped

    @_non_fatal
    def occ_cb(i, tr, m):
        if i < args.occ_train_warmup:
            return
        # The bake steers the live sampler: the raw params, not the
        # average.
        grid = occ_bake(render_params(tr.state.params, i))
        frac = occupied_fraction(grid)
        verdict = tr.maybe_set_occupancy(grid, occupied_frac=frac)
        logger.log(i, occ_verdict=verdict, occ_occupied_frac=round(frac, 5))
        if verdict == "switched":
            print(f"occ_train: switched to occupancy training at step {i} "
                  f"(res={args.occupancy_res}, rebake every "
                  f"{args.occ_train_every})")
        elif verdict == "postponed":
            print(f"occ_train: baked grid still empty at step {i} — "
                  f"postponing the occupancy switch (retrying every "
                  f"{args.occ_train_every} steps)")
        elif verdict == "kept":
            print(f"[WARN] occ_train: rebake at step {i} produced an "
                  f"empty grid; keeping the previous one", flush=True)

    @_non_fatal
    def vid_cb(i, tr, m):
        params = render_params(deploy_params(tr.state), i)
        frames = spiral_video(i, family.frame_nets(params, rcfg_test),
                              occupancy=tr.occupancy)
        logger.log_image(i, "spiral_frame0", frames[0])

    @_non_fatal
    def val_cb(i, tr, m):
        if not len(val_views):
            return
        params = render_params(deploy_params(tr.state), i)
        v, s, rgb, _ = score_views(family.frame_nets(params, rcfg_test),
                                   val_views, 123, occupancy=tr.occupancy)
        logger.log(i, val_psnr=v, val_ssim=s, val_views=len(val_views))
        logger.log_image(i, "val_render", rgb)
        if best_writer is not None and v > best["psnr"]:
            # Save first: best must not advance past the checkpoint that
            # exists on disk.
            best_writer.save(tr.state)
            best.update(psnr=v, step=i)
            if writer:
                with open(best_meta_path, "w") as fp:
                    json.dump(best, fp)
            print(f"New best val PSNR {v:.3f} at step {i} "
                  f"(checkpointed to {ckpt_dir}_best)")

    if args.occ_train:
        # Registered first: at a shared step the rebake runs before the
        # validation and video callbacks, which render through it.
        trainer.add_callback(args.occ_train_every, occ_cb)
    trainer.add_callback(args.print_freq, log_cb)
    if args.ckpt_freq > 0:
        trainer.add_callback(args.ckpt_freq, ckpt_cb)
    if args.vid_freq > 0:
        trainer.add_callback(args.vid_freq, vid_cb)
    if args.val_freq > 0:
        trainer.add_callback(args.val_freq, val_cb)

    if args.profile_dir:
        # Bounded profiling window: warm up, then trace 20 steps.
        from torch.profiler import ProfilerActivity, profile
        warm = min(start + 10, args.iters - 1)
        trainer.run(start + 1, warm + 1)
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            trainer.run(warm + 1, min(warm + 21, args.iters))
            if dev.type == "cuda":
                torch.cuda.synchronize()
        if writer:
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir,
                                                  "trace.json"))
            print(f"Profiler trace written to {args.profile_dir}")
        final = trainer.run(min(warm + 21, args.iters), args.iters)
    else:
        final = trainer.run(start + 1, args.iters)

    try:
        ckpt_writer.save(trainer.state, wait=True)   # final save is durable
    finally:
        ckpt_writer.close()
    logger.log(int(trainer.state.step), **final)
    result = dict(final)

    if best_writer is not None:
        best_writer.close()
    # Rank 0's last checkpoints are on disk before any rank reads them.
    mesh.barrier()
    if len(test_views):
        # Held-out test scores on the test views (disjoint from the
        # validation views where the dataset allows).
        step = int(trainer.state.step)
        params = render_params(deploy_params(trainer.state), step)
        p, s, _, lp = score_views(family.frame_nets(params, rcfg_test),
                                  test_views, 7, occupancy=trainer.occupancy)
        extra = {} if lp is None else {"test_lpips": lp}
        logger.log(int(trainer.state.step), test_psnr=p, test_ssim=s,
                   test_views=len(test_views), **extra)
        result.update(test_psnr=p, test_ssim=s, **extra)
        if best_writer is not None and best["step"] is not None:
            # Score the deployable (best-val) model too.
            restored = restore_checkpoint(ckpt_dir + "_best", state)
            if restored is not None:
                params_best = render_params(deploy_params(restored),
                                            int(restored.step))
                # The grid must match the params it resamples for: rebake
                # from the best-val weights; a best checkpoint whose bake
                # is empty (from the warm-up) scores grid-less.
                occ_best = (occ_bake(params_best)
                            if occ_bake is not None
                            and trainer.occupancy is not None else None)
                if occ_best is not None and occupied_fraction(occ_best) <= 0:
                    print("[WARN] best-val occupancy bake is empty — "
                          "scoring the best model grid-less", flush=True)
                    occ_best = None
                pb, sb, _, lpb = score_views(
                    family.frame_nets(params_best, rcfg_test), test_views, 7,
                    occupancy=occ_best)
                extra = {} if lpb is None else {"test_lpips_best": lpb}
                logger.log(int(trainer.state.step), test_psnr_best=pb,
                           test_ssim_best=sb,
                           best_step=int(best["step"]),
                           best_val_psnr=best["psnr"], **extra)
                result.update(test_psnr_best=pb, test_ssim_best=sb, **extra)
                print(f"Best-val model (step {best['step']}): "
                      f"test_psnr={pb:.3f} test_ssim={sb:.4f} "
                      f"(final-step model: {p:.3f}/{s:.4f})")
    logger.close()
    print("Training complete:", final)
    return result


if __name__ == "__main__":
    main()
