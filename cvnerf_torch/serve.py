"""Serving: load a checkpoint once, render views on demand (port of
the JAX package's ``serve.py``: ``NerfRenderer`` and
``write_scene_snapshot``).

The port reads plain-tensor two-net ``.pt`` files: those its own trainer
writes (``python -m cvnerf_torch.cli``, ``train/checkpoint.py``) and those
the JAX package's ``cvnerf-import --export <run>/checkpoints <file>.pt``
writes. A run directory for :meth:`NerfRenderer.from_run_dir` holds the
trainer's ``scene.json`` and such files under ``torch_checkpoints/`` (and,
for a run that tracked its best validation model,
``torch_checkpoints_best/``).

Example::

    r = NerfRenderer.from_run_dir("logs/lego")            # on the card
    rgb = r.render_pose(c2w)                  # [H, W, 3] float32 in [0, 1]
    frames = r.render_video(spiral_poses)     # [N, H, W, 3]

Serving renders in eval mode with the evenly spaced inverse-CDF resample by
default, so a pose always renders the same image; ``deterministic=False``
resamples stochastically with ``PRNGKey(seed)``, as the JAX package's
``--stochastic`` serving does. The weights are packed for the fused kernel
once, here, and reused by every render; each frame replays a captured
frame program (``render/frames.py``) of the renderer's own cache on the
card, and runs the same body eagerly on the CPU. ``enable_int8``
quantizes both nets and serves through the int8 kernel from then on (a
program of its own); ``enable_occupancy`` bakes an occupancy grid
(``render/occupancy.py``, through the forward kernel) and serves through
its probe instead of the coarse net. Both read the float
master copy, so they compose in either order. With ``use_mesh`` (the
default) a host with several cards, or a process group with several
ranks, splits each chunk's rays over a ``'rays'`` mesh
(``parallel/mesh.py``) with the nets and the grid replicated over it; on
one card there is no mesh.

An Instant-NGP run serves through the same frame programs; reading a
checkpoint, packing and the refused levers are the family's
(``models/family.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch

from cvnerf_torch import resolve_device
from cvnerf_torch.models.family import family_named, family_of
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, anneal_model_params
from cvnerf_torch.ops.fused_mlp_int8 import QuantizedNerfWeights
from cvnerf_torch.ops.quantize import (calibration_samples, quantize_nerf,
                                       ray_calibration_samples)
from cvnerf_torch.render.frames import FramePrograms, render_poses_to_frames
from cvnerf_torch.render.occupancy import (bake_scene_occupancy,
                                          occupied_fraction, scene_bbox)
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.parallel.mesh import Mesh, make_mesh, replicate_to_mesh
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.utils.tree import tree_map

SCENE_SNAPSHOT = "scene.json"
CKPT_SUBDIR = "torch_checkpoints"


def latest_checkpoint(ckpt_dir: str, step: int | None = None) -> str | None:
    """The newest ``*.pt`` in ``ckpt_dir``: the highest step number in the
    file name (the last run of digits, e.g. ``050000.pt``), then the latest
    modification time; with ``step``, the newest of that step's files.
    None when there is none."""
    try:
        names = [f for f in os.listdir(ckpt_dir) if f.endswith(".pt")]
    except FileNotFoundError:
        return None

    def key(name):
        digits = re.findall(r"\d+", name[:-3])
        path = os.path.join(ckpt_dir, name)
        return (int(digits[-1]) if digits else -1, os.path.getmtime(path))
    if step is not None:
        names = [f for f in names if key(f)[0] == step]
    if not names:
        return None
    return os.path.join(ckpt_dir, max(names, key=key))


def write_scene_snapshot(run_dir: str, *, height: int, width: int,
                         focal: float, near: float, far: float, ndc: bool,
                         ndc_variant: str, white_bkg: bool,
                         n_coarse: int, n_fine: int, bf16: bool,
                         mlp: NerfMLPConfig,
                         sorted_resample: bool = True,
                         pallas: str = "auto",
                         calib_poses=None,
                         occ_train: bool = False,
                         occ_res: int = 192,
                         occ_bound: float = 1.5,
                         occ_mode: str | None = None,
                         occ_interp: str = "nearest",
                         occ_floor: int = 0,
                         freq_anneal: int = 0,
                         ema_decay: float = 0.0) -> str:
    """Persist everything a renderer needs to serve this run's checkpoints:
    the JAX package's ``write_scene_snapshot`` (the same keys and
    values).

    ``config_resolved.json`` records the raw flags; this records the
    *derived* values (near/far/H/W/focal come out of the data loader, not
    the flags — e.g. LLFF NDC runs train with near=0, far=1 regardless of
    ``poses_bounds.npy``).

    ``calib_poses``: optional ``[P, 3+, 4]`` camera set (the scene's
    poses). Up to 64 are stored (evenly subsampled) so post-training
    transforms that need the query distribution — int8 calibration — can
    sample real rays instead of guessing a bounding cube.

    ``ema_decay`` (an EMA run) is recorded so a resume keeps averaging;
    ``freq_anneal`` so a checkpoint from inside the anneal horizon is
    served through the training-time frequency window.

    ``occ_train`` (an ``--occ_train`` run, whose coarse net stops training
    at the switch) records the bake and the sampling it trained with, so
    ``from_run_dir`` serves it through a grid; the mode and the probe have
    no default: every writer must say which ran.
    """
    if occ_train:
        if occ_mode not in ("full", "merge"):
            raise ValueError(f"occ_train snapshots must record the sampling "
                             f"mode ('full' or 'merge'), got {occ_mode!r}")
        if occ_interp not in ("trilinear", "nearest"):
            raise ValueError(f"occ_train snapshots must record the probe "
                             f"interp ('trilinear' or 'nearest'), got "
                             f"{occ_interp!r}")
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, SCENE_SNAPSHOT)
    payload = {
        "height": int(height), "width": int(width), "focal": float(focal),
        "near": float(near), "far": float(far), "ndc": bool(ndc),
        "ndc_variant": ndc_variant, "white_bkg": bool(white_bkg),
        "n_coarse": int(n_coarse), "n_fine": int(n_fine), "bf16": bool(bf16),
        "sorted_resample": bool(sorted_resample), "pallas": pallas,
        "mlp": dataclasses.asdict(mlp),
    }
    tag = family_of(mlp).tag
    if tag is not None:
        payload["model"] = tag
    if ema_decay > 0:
        payload["ema_decay"] = float(ema_decay)
    if freq_anneal > 0:
        payload["freq_anneal"] = int(freq_anneal)
    if calib_poses is not None:
        cp = np.asarray(calib_poses, np.float32)[:, :3, :4]
        if len(cp) > 64:
            cp = cp[np.linspace(0, len(cp) - 1, 64).round().astype(int)]
        payload["calib_poses"] = cp.tolist()
    if occ_train:
        payload["occ_train"] = {"resolution": int(occ_res),
                                "bound": float(occ_bound),
                                "mode": occ_mode,
                                "interp": occ_interp,
                                "floor": int(occ_floor)}
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=2, sort_keys=True)
    return path


class NerfRenderer:
    """A checkpoint loaded for repeated novel-view rendering: the Polyak
    average of an EMA run, else the params. ``anneal`` applies the
    ``freq_anneal`` window at that progress to the weights, in float32,
    before they are packed (``from_run_dir`` passes it for a raw
    mid-anneal checkpoint). ``use_mesh`` renders over ``make_mesh()``
    (or over the given ``Mesh``) when it has more than one shard
    (``self.mesh``, else None)."""

    which: str = "last"

    def __init__(self, ckpt_path: str, *,
                 height: int, width: int, focal: float,
                 near: float, far: float,
                 ndc: bool = False,
                 ndc_variant: str = "canonical",
                 cfg: RenderConfig | None = None,
                 mlp: NerfMLPConfig | None = None,
                 chunk: int = 8192,
                 seed: int = 0,
                 deterministic: bool = True,
                 device: str | torch.device = "cuda",
                 anneal: float | None = None,
                 use_mesh: bool | Mesh = True):
        self.device = resolve_device(device)
        mesh = use_mesh if isinstance(use_mesh, Mesh) else (
            make_mesh(device=self.device) if use_mesh else None)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if cfg is None:
            cfg = RenderConfig(mlp=mlp if mlp is not None
                               else NerfMLPConfig())
        elif mlp is not None and cfg.mlp != mlp:
            raise ValueError(
                "conflicting architectures: cfg.mlp != mlp — pass the "
                "architecture through cfg, or omit the mlp kwarg")
        self.cfg = dataclasses.replace(cfg.eval_mode(),
                                       deterministic_resample=deterministic)
        self.cfg.check_supported()
        # The checkpoint's sample budget: enable_occupancy's overrides
        # reset to it when omitted.
        self._base_samples = (self.cfg.n_coarse, self.cfg.n_fine)
        self.occupancy = None
        self.height, self.width, self.focal = int(height), int(width), focal
        self.near, self.far = float(near), float(far)
        self.ndc, self.ndc_variant = ndc, ndc_variant
        self.chunk = chunk
        self._key = PRNGKey(seed)
        # The renderer's frame programs: one a frame shape and net kind.
        self.programs = FramePrograms()

        self.family = family_of(self.cfg.mlp)
        params, step = self.family.read(ckpt_path, self.cfg.mlp)
        self.step = 0 if step is None else step
        if anneal is not None:
            # A raw checkpoint from inside a freq_anneal horizon: its
            # weights were only ever trained through this window.
            params = anneal_model_params(params, self.cfg.mlp, anneal)
        self.params = tree_map(lambda t: t.to(self.device), params)
        # The float master copy: enable_int8 swaps the nets a render uses,
        # never these.
        self._float_params = self.params
        # A camera set for calibration (enable_int8); from_run_dir fills it
        # when the run's snapshot stores poses.
        self.calib_poses = None
        # Pack once for the kernel; every render reuses the packing.
        self._nets = self._placed(self.family.frame_nets(self.params,
                                                         self.cfg))

    def _placed(self, x):
        """``x`` replicated over the mesh, or as it is without one."""
        return x if self.mesh is None else replicate_to_mesh(x, self.mesh)

    @classmethod
    def from_run_dir(cls, run_dir: str, *, chunk: int = 8192, seed: int = 0,
                     deterministic: bool = True, which: str = "auto",
                     step: int | None = None,
                     device: str | torch.device = "cuda",
                     use_mesh: bool | Mesh = True) -> "NerfRenderer":
        """Load a renderer from a run directory: geometry, NDC mode,
        architecture, sample counts and compute dtype from ``scene.json``,
        weights from the newest ``.pt`` under ``torch_checkpoints/``.

        ``which="auto"`` serves ``torch_checkpoints_best/`` when the run has
        one, ``"best"`` requires it and ``"last"`` ignores it. ``step``
        picks that step's checkpoint (under ``which="auto"``, from
        ``torch_checkpoints/``, as the JAX package picks it). An EMA run
        serves its average. A raw checkpoint (the port's trainer writes
        ``"raw_params": True``) from inside the run's ``freq_anneal``
        horizon is served through the training-time frequency window at
        ``step / freq_anneal``, as the JAX package serves its own; one
        with no such marker is served as exported, since ``cvnerf-import
        --export`` writes it with the window applied. An ``occ_train``
        snapshot is served through a baked grid with the recorded bake and
        sampling (``full`` and the nearest probe for a record that predates
        those fields); an empty bake serves grid-less, with a warning.
        """
        path = os.path.join(run_dir, SCENE_SNAPSHOT)
        try:
            with open(path) as fp:
                geo = json.load(fp)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{path} not found — {run_dir!r} is not a run directory")
        if which not in ("auto", "best", "last"):
            raise ValueError(f"which must be auto|best|last, got {which!r}")
        mlp = family_named(geo.get("model")).config(**geo["mlp"])
        cfg = RenderConfig(
            n_coarse=geo["n_coarse"], n_fine=geo["n_fine"],
            white_bkg=geo["white_bkg"], mlp=mlp,
            compute_dtype=torch.bfloat16 if geo.get("bf16") else torch.float32,
            sorted_resample=geo.get("sorted_resample", True),
            kernels="off" if geo.get("pallas", "auto") == "off" else "on")
        best_dir = os.path.join(run_dir, CKPT_SUBDIR + "_best")
        has_best = latest_checkpoint(best_dir) is not None
        if which == "best" and not has_best:
            raise FileNotFoundError(
                f"no best-val checkpoint under {run_dir}/{CKPT_SUBDIR}_best")
        use_best = has_best and (which == "best"
                                 or (which == "auto" and step is None))
        ckpt_dir = best_dir if use_best else os.path.join(run_dir, CKPT_SUBDIR)
        ckpt = latest_checkpoint(ckpt_dir, step)
        if ckpt is None and step is not None:
            raise FileNotFoundError(f"no checkpoint at step {step} under "
                                    f"{ckpt_dir}")
        if ckpt is None:
            raise FileNotFoundError(
                f"no .pt checkpoint under {run_dir}/{CKPT_SUBDIR}: export "
                f"one with `cvnerf-import --export {run_dir}/checkpoints "
                f"{run_dir}/{CKPT_SUBDIR}/<step>.pt`")
        fa = int(geo.get("freq_anneal", 0) or 0)
        anneal = None
        if fa > 0:
            blob = torch.load(ckpt, map_location="cpu", weights_only=True)
            raw = isinstance(blob, dict) and bool(blob.get("raw_params"))
            at = int(blob.get("step") or 0) if isinstance(blob, dict) else 0
            if raw and at < fa:
                anneal = at / fa
        r = cls(ckpt, height=geo["height"], width=geo["width"],
                focal=geo["focal"], near=geo["near"], far=geo["far"],
                ndc=geo["ndc"], ndc_variant=geo["ndc_variant"], cfg=cfg,
                chunk=chunk, seed=seed, deterministic=deterministic,
                device=device, anneal=anneal, use_mesh=use_mesh)
        r.which = "best" if use_best else "last"
        if geo.get("calib_poses"):
            r.calib_poses = np.asarray(geo["calib_poses"], np.float32)
        if anneal is not None:
            print(f"serving a mid-anneal checkpoint (step {r.step} < "
                  f"freq_anneal {fa}): applying the training-time "
                  f"frequency window")
        elif fa > 0 and r.step < fa:
            # The exporter has already applied the window to the .pt (it
            # reads this scene.json): a second window would square the
            # partly open band.
            print(f"serving a mid-anneal checkpoint (step {r.step} < "
                  f"freq_anneal {fa}): its exported weights already carry "
                  f"the training-time frequency window")
        if geo.get("occ_train"):
            # Past its warm-up an --occ_train run's coarse net is frozen at
            # warm-up quality: serve it the way it was trained.
            ot = geo["occ_train"]
            r.enable_occupancy(resolution=int(ot["resolution"]),
                               bound=float(ot["bound"]),
                               mode=ot.get("mode", "full"),
                               interp=ot.get("interp", "nearest"),
                               floor=int(ot.get("floor", 0)),
                               require_occupied=True)
        return r

    def enable_occupancy(self, *, resolution: int = 192, dilate: int = 1,
                         bound: float = 1.5, mode: str = "merge",
                         interp: str = "nearest", term: float = 0.0,
                         floor: int = 0, n_coarse: int | None = None,
                         n_fine: int | None = None,
                         require_occupied: bool = False) -> "NerfRenderer":
        """Bake an occupancy grid from the float master copy and serve every
        render through it: the grid probe replaces the coarse net
        (``mode="merge"``), and ``mode="full"`` also draws every fine
        sample from the probe CDF (``floor`` of them from a stratified
        coverage draw). ``term`` > 0 tightens each ray's interval by a
        probe march first, which makes reduced ``n_coarse``/``n_fine``
        budgets safe; omitted overrides reset to the checkpoint's budget.
        The bake reflects the current weights: re-enable after loading
        others. With ``require_occupied``, an empty bake keeps grid-less
        serving, with a warning. Returns self."""
        if self.family.refused(occupancy=True):
            raise ValueError("occupancy is NeRF's: an Instant-NGP field "
                             "serves without it")
        if mode not in ("merge", "full"):
            raise ValueError(f"mode must be 'merge' or 'full', got {mode!r}")
        if interp not in ("trilinear", "nearest"):
            raise ValueError(f"interp must be 'trilinear' or 'nearest', "
                             f"got {interp!r}")
        grid = bake_scene_occupancy(
            self._float_params, self.cfg.mlp, ndc=self.ndc, bound=bound,
            n_fine=self.cfg.n_fine, resolution=resolution, dilate=dilate,
            compute_dtype=self.cfg.compute_dtype, kernels=self.cfg.kernels)
        if require_occupied and occupied_fraction(grid) <= 0.0:
            print("[WARN] occupancy bake found no positive density — "
                  "serving grid-less (the checkpoint's coarse net drives "
                  "the resample)", flush=True)
            return self
        base_c, base_f = self._base_samples
        self.cfg = dataclasses.replace(
            self.cfg, occupancy_mode=mode, occupancy_interp=interp,
            occupancy_termination=float(term), occ_floor=int(floor),
            n_coarse=base_c if n_coarse is None else int(n_coarse),
            n_fine=base_f if n_fine is None else int(n_fine))
        self.occupancy = self._placed(grid)
        return self

    def enable_int8(self, *, poses=None, n_calib: int = 1 << 17,
                    bound: float | None = None,
                    seed: int = 0) -> "NerfRenderer":
        """Quantize both nets to int8 and serve every render with them.

        Post-training symmetric quantization (``ops/quantize.py``): weights
        and activations carry per-channel scales, calibrated max-abs over
        ``n_calib`` samples drawn from ``PRNGKey(seed)``, on the renderer's
        device. Renders then run the int8 kernel (``kernels="on"``) or the
        plain int8 graph (``kernels="off"``). Checkpoints and the float
        master copy are untouched; reloading weights needs a re-enable.
        Returns self.

        Calibration samples real rays through ``poses`` (``[P, 3+, 4]``
        c2w), by default the run snapshot's ``calib_poses``; without poses,
        NDC scenes sample the NDC box (exact) and others a ``±bound`` cube
        (``bound=None`` → ``far``), a heuristic: rays reach ``|origin| +
        far``, and an under-sized box clips the position encoding.
        """
        if self.family.refused(int8=True):
            raise ValueError("int8 serving is NeRF's: an Instant-NGP field "
                             "serves without it")
        key = PRNGKey(seed)
        if poses is None:
            poses = self.calib_poses
        if poses is not None:
            pts, dirs = ray_calibration_samples(
                key, n_calib, poses, self.height, self.width, self.focal,
                self.near, self.far, ndc=self.ndc,
                ndc_variant=self.ndc_variant, device=self.device)
        elif self.ndc:
            pts, dirs = calibration_samples(key, n_calib, (-1.0, -1.0, 0.0),
                                            (1.0, 1.0, 1.0), self.device)
        else:
            b = self.far if bound is None else bound
            pts, dirs = calibration_samples(key, n_calib, (-b,) * 3, (b,) * 3,
                                            self.device)
        qs = {k: quantize_nerf(net, self.cfg.mlp, pts, dirs)
              for k, net in self._float_params.items()}
        if self.cfg.kernels == "on":
            self._nets = self._placed(
                {k: QuantizedNerfWeights(q, self.cfg.mlp)
                 for k, q in qs.items()})
        else:
            self._nets = self._placed(qs)
        return self

    def extract_mesh(self, *, net: str = "fine", resolution: int = 256,
                     iso: float = 50.0, bound: float = 1.5,
                     chunk: int = 65536, keep: str = "all",
                     timings: dict | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Mesh this checkpoint's density field (``render/mesh.py``) from
        the float master copy: in the NDC box for an NDC-trained run (the
        only region it was queried in), else the ``±bound`` cube."""
        from cvnerf_torch.render.mesh import extract_mesh
        if self.family.refused(meshing=True):
            raise ValueError("meshing is NeRF's: an Instant-NGP field "
                             "serves without it")
        bbox_min, bbox_max = scene_bbox(self.ndc, bound)
        if net == "fine" and self.cfg.n_fine == 0:
            net = "coarse"
        return extract_mesh(self._float_params, self.cfg.mlp, net=net,
                            bbox_min=bbox_min, bbox_max=bbox_max,
                            resolution=resolution, iso=iso, chunk=chunk,
                            compute_dtype=self.cfg.compute_dtype, keep=keep,
                            kernels=self.cfg.kernels, timings=timings)

    def render_pose(self, c2w, factor: int = 0) -> np.ndarray:
        """Render one ``[H, W, 3]`` view from a ``[3+, 4]`` c2w pose."""
        return self.render_pose_extras(c2w, factor, keys=("rgb",))["rgb"]

    def render_pose_extras(self, c2w, factor: int = 0,
                           keys: tuple[str, ...] = ("rgb", "depth", "acc"),
                           ) -> dict:
        """Render one view and return the requested outputs (``rgb``,
        ``depth``, ``acc``, ``rgb_coarse``) as numpy arrays."""
        h, w, f = self.height, self.width, self.focal
        if factor:
            h, w, f = h // factor, w // factor, f / factor
        c2w = torch.from_numpy(np.asarray(c2w, np.float32)[:3, :4])
        return self.programs(
            self._nets, h, w, f, c2w, self.near, self.far, self.cfg,
            device=self.device,
            take=lambda out: {k: out[k].to("cpu", copy=True).numpy()
                              for k in keys},
            ndc=self.ndc, ndc_variant=self.ndc_variant, chunk=self.chunk,
            key=self._key, occupancy=self.occupancy, mesh=self.mesh)

    def render_video(self, poses, factor: int = 0, on_frame=None,
                     collect: bool = True) -> np.ndarray | None:
        """Render a pose sequence to ``[N, H, W, 3]``, one frame in flight;
        ``collect=False`` (with ``on_frame``) streams the frames."""
        return render_poses_to_frames(
            self._nets, poses, self.height, self.width, self.focal,
            self.near, self.far, self.cfg, ndc=self.ndc,
            ndc_variant=self.ndc_variant, chunk=self.chunk, factor=factor,
            on_frame=on_frame, collect=collect, device=self.device,
            key=self._key, occupancy=self.occupancy, mesh=self.mesh,
            programs=self.programs)

    def render_poses_extras(self, poses, factor: int = 0,
                            keys: tuple[str, ...] = ("rgb",)) -> dict:
        """Batched :meth:`render_pose_extras`: ``keys`` → ``[N, H, W, ...]``
        stacked arrays, identical to N separate calls."""
        out = render_poses_to_frames(
            self._nets, poses, self.height, self.width, self.focal,
            self.near, self.far, self.cfg, ndc=self.ndc,
            ndc_variant=self.ndc_variant, chunk=self.chunk, factor=factor,
            frame_keys=tuple(keys), device=self.device, key=self._key,
            occupancy=self.occupancy, mesh=self.mesh, programs=self.programs)
        return {"rgb": out} if tuple(keys) == ("rgb",) else out
