"""The train step and the host-side training loop (port of the JAX
package's ``train/loop.py``).

One step, as the JAX step computes it: split the step key into image,
pixel and render keys; draw one training image (``randint``) and
``n_rays`` of its pixels without replacement (a keyed Feistel permutation,
a uniform random permutation for ``"parity"``, or with replacement), with
the centre crop during the precrop warm-up, or under ``ray_batching``
``n_rays`` (image, pixel) pairs over the whole train split; build those
pixels' rays; render them (coarse and fine MLP through the fused kernels
and their backward); loss MSE(fine) + MSE(coarse), plus the distortion and
occlusion regularizers when they are on; backward; Adam; the Polyak
average when ``ema_decay`` is on. The random draws are the JAX package's
bit for bit (``ops/rng.py``), so a step from the same state and key
matches the JAX step.

The levers of the JAX trainer, each off by default: ``noise_decay`` (the
density noise scaled by ``clip(1 - step/noise_decay, 0, 1)``),
``freq_anneal`` (the encoding bands opened by ``clip(step/freq_anneal, 0,
1)``, applied to the weights inside the loss, so a closed band's gradient
is exactly 0), ``distortion_loss`` with its delay and ramp,
``occlusion_loss``, ``ema_decay``, ``ray_batching`` and
``pixel_sampling="parity"``. Every schedule is formed in float32 from the
step, as the JAX step forms it.

Occupancy training (``--occ_train``): ``make_train_step(cfg,
with_occupancy=True)`` builds the step that takes a baked grid, whose probe
replaces the coarse MLP (one forward and one backward launch a step instead
of two each); its loss is MSE(fine) plus the enabled regularizers. The
coarse leaves get zero gradients: Adam still runs on them (their moments
decay, the count advances, as optax does), and their updates are zeroed,
so the coarse net stays as it was at the switch. ``Trainer.set_occupancy``
and ``maybe_set_occupancy`` install the grid.

Data parallelism (``parallel/mesh.py``): ``make_train_step(cfg, mesh)``
splits the ray batch over the mesh's ``'rays'`` axis. Every shard draws
the same global batch from the same key (pixels, ray batching, precrop;
once per distinct device), takes its contiguous rows with their *global*
ray ids, and computes its loss with the regularizers and its gradients;
then the shards average the loss, ``mse_fine`` and every gradient leaf
(``shard_mean``: one all-reduce per leaf across processes, or with
``TrainConfig.fused_allreduce`` one all-reduce of the concatenated
gradients and ``[loss, mse_fine]``). Adam, the EMA slot and the occupancy
step's frozen coarse net then run on the averaged gradients, alike on
every rank, so the state stays replicated; inside one process the state
lives on the mesh's first device and its params are copied to the other
devices each step. One shard is the unsharded step, bitwise.

The step runs eagerly: the Feistel pixel draw runs on the host and is
copied to the card without waiting for it, the parity draw (a sort over
the whole grid) runs on the card; the render and the backward are the
device's work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from cvnerf_torch.models.nerf_mlp import anneal_model_params
from cvnerf_torch.ops.compositing import distortion_loss, occlusion_loss
from cvnerf_torch.ops.rays import (ndc_rays, rays_for_pixels,
                                   rays_for_pixels_batched)
from cvnerf_torch.ops.rng import (PRNGKey, choice_without_replacement,
                                  fold_in, randint,
                                  sample_without_replacement, split)
from cvnerf_torch.parallel.mesh import (Mesh, ray_sharding,
                                        replicate_to_mesh, shard_mean,
                                        to_device)
from cvnerf_torch.render.occupancy import occupied_fraction
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.train.state import (TrainState, ema_update, make_optimizer,
                                      tree_leaves)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the JAX ``TrainConfig``'s fields and
    defaults (see its notes). ``fused_allreduce`` averages the shards'
    gradients and ``[loss, mse_fine]`` in one flat all-reduce instead of
    one a leaf (equal to fp32 rounding); it is ignored without a mesh."""
    height: int
    width: int
    focal: float
    near: float
    far: float
    n_rays: int = 1024
    lr: float = 5e-4
    lr_decay: int = 250
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    ndc: bool = False
    ndc_variant: str = "canonical"
    pixel_sampling: str = "prp"   # "prp" | "parity" | "replace"
    noise_decay: int = 0
    freq_anneal: int = 0
    distortion_loss: float = 0.0
    distortion_start: int = 0
    distortion_ramp: int = 0
    occlusion_loss: float = 0.0
    occlusion_frac: float = 0.2
    ema_decay: float = 0.0
    ray_batching: bool = False
    fused_allreduce: bool = False
    render: RenderConfig = RenderConfig()


def check_supported(cfg: TrainConfig) -> None:
    """Raise for the JAX step's invalid configurations."""
    if cfg.pixel_sampling not in ("prp", "parity", "replace"):
        raise ValueError(f"bad pixel_sampling: {cfg.pixel_sampling!r}")
    if cfg.n_rays > cfg.height * cfg.width and not cfg.ray_batching:
        raise ValueError(
            f"n_rays={cfg.n_rays} exceeds the {cfg.height}x{cfg.width} "
            "pixel grid (sampling is without replacement; --ray_batching "
            "samples over the whole train split instead)")
    if cfg.ray_batching and cfg.pixel_sampling != "prp":
        raise ValueError(
            "ray_batching draws the joint (image, pixel) sample with the "
            "Feistel PRP only — pixel_sampling="
            f"{cfg.pixel_sampling!r} is not implemented over the "
            "cross-image pool")
    if cfg.precrop_iters > 0:
        crop = (2 * int(cfg.height // 2 * cfg.precrop_frac)
                * 2 * int(cfg.width // 2 * cfg.precrop_frac))
        if cfg.n_rays > crop:
            raise ValueError(
                f"n_rays={cfg.n_rays} exceeds the precrop grid of {crop} "
                f"pixels (precrop_frac={cfg.precrop_frac})")


def _sample_pixels(key: torch.Tensor, cfg: TrainConfig, precrop: bool,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_rays`` (py, px) pixel coordinates (int64, on ``device``): the
    centre-crop grid during warm-up, then the whole image. The Feistel and
    with-replacement draws run on the host, the parity permutation on
    ``device``."""
    h, w = cfg.height, cfg.width
    if precrop:
        dh = int(h // 2 * cfg.precrop_frac)
        dw = int(w // 2 * cfg.precrop_frac)
        y0, x0 = h // 2 - dh, w // 2 - dw
        gh, gw = 2 * dh, 2 * dw
    else:
        y0 = x0 = 0
        gh, gw = h, w
    if cfg.pixel_sampling == "parity":
        flat = choice_without_replacement(key, cfg.n_rays, gh * gw, device)
    else:
        if cfg.pixel_sampling == "prp":
            flat = sample_without_replacement(key, cfg.n_rays, gh * gw)
        else:
            flat = randint(key, (cfg.n_rays,), 0, gh * gw).to(torch.int64)
        flat = _to(flat, device)
    return y0 + flat // gw, x0 + flat % gw


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor onto ``device`` without making the host wait for the
    device's queue (pinned staging)."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def global_norm(tree: dict) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


def _f32(x) -> float:
    return float(np.float32(x))


def schedules(cfg: TrainConfig, step: int) -> tuple[float, float, float]:
    """``(noise_scale, anneal, dist_scale)`` at ``step``, each formed in
    float32 as the JAX step forms it: ``clip(1 - step/noise_decay, 0, 1)``,
    ``clip(step/freq_anneal, 0, 1)`` and ``clip((step - start) / max(ramp,
    1), 0, 1)``; 1.0 where the lever is off."""
    t = np.float32(step)
    one, zero = np.float32(1.0), np.float32(0.0)
    noise = one
    if cfg.noise_decay > 0:
        noise = np.clip(one - t / np.float32(cfg.noise_decay), zero, one)
    anneal = one
    if cfg.freq_anneal > 0:
        anneal = np.clip(t / np.float32(cfg.freq_anneal), zero, one)
    dist = one
    if cfg.distortion_start > 0 or cfg.distortion_ramp > 0:
        dist = np.clip((t - np.float32(cfg.distortion_start))
                       / np.float32(max(cfg.distortion_ramp, 1)), zero, one)
    return float(noise), float(anneal), float(dist)


def make_train_step(cfg: TrainConfig, mesh: Mesh | None = None,
                    with_occupancy: bool = False) -> Callable:
    """``step_fn(state, key, images, poses, train_idx, precrop) ->
    (new_state, metrics)``: the JAX ``make_train_step(cfg, mesh=None)``.
    ``images [N, H, W, 3]`` and ``poses [N, 3, 4]`` lie on the params'
    device (or, with a mesh, are ``replicate_to_mesh`` values),
    ``train_idx`` (int64) on any; the metrics are 0-d tensors on the
    params' device. With ``with_occupancy=True`` the step takes a baked
    ``OccupancyGrid`` after the state: ``step_fn(state, occupancy, key,
    ...)`` (the occupancy step, see the module docstring). With ``mesh``
    the batch is split over its shards (see the module docstring);
    ``n_rays`` must divide into them."""
    if mesh is not None and cfg.n_rays % mesh.size != 0:
        raise ValueError(
            f"n_rays={cfg.n_rays} must be divisible by the mesh size "
            f"{mesh.size}")
    check_supported(cfg)
    opt = make_optimizer(cfg.lr, cfg.lr_decay)
    rcfg = cfg.render
    if cfg.distortion_loss > 0.0 or cfg.occlusion_loss > 0.0:
        # The regularizers read the fine pass's weights and depths.
        rcfg = dataclasses.replace(rcfg, return_weights=True)

    def pick_rays(key, images, poses, train_idx, precrop):
        """The step's global batch on the images' device: rays (NDC-warped
        when ``cfg.ndc``), pre-NDC unit view directions and target
        colours."""
        k_img, k_pix = key
        dev = images.device
        if cfg.ray_batching and not precrop:
            # n_rays (image, pixel) pairs over the whole train split, one
            # Feistel draw over n_train·H·W.
            h, w = cfg.height, cfg.width
            flat = _to(sample_without_replacement(
                k_pix, cfg.n_rays, train_idx.shape[0] * h * w), dev)
            im_idx = train_idx.to(dev)[flat // (h * w)]
            pix = flat % (h * w)
            py, px = pix // w, pix % w
            target = images[im_idx, py, px]
            rays_o, rays_d = rays_for_pixels_batched(
                px, py, w, h, cfg.focal, poses[im_idx])
        else:
            j = int(randint(k_img, (), 0, train_idx.shape[0]))
            im = int(train_idx[j])
            py, px = _sample_pixels(k_pix, cfg, precrop, dev)
            target = images[im][py, px]
            rays_o, rays_d = rays_for_pixels(px, py, cfg.width, cfg.height,
                                             cfg.focal, poses[im])
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if cfg.ndc:
            rays_o, rays_d = ndc_rays(cfg.height, cfg.width, cfg.focal, 1.0,
                                      rays_o, rays_d, variant=cfg.ndc_variant)
        return rays_o, rays_d, viewdirs, target

    def shard_grads(params, occupancy, k_render, batch, rows, schedule):
        """One shard's rays ``rows`` of the global ``batch``: (loss,
        mse_fine, the gradient of every leaf of ``params``)."""
        noise_scale, anneal, dist_scale = schedule
        rays_o, rays_d, viewdirs, target = (x[rows] for x in batch)
        dev = target.device
        n = rows.stop - rows.start
        ray_ids = torch.arange(rows.start, rows.stop, dtype=torch.int64,
                               device=dev)
        near = torch.full((n,), cfg.near, dtype=torch.float32, device=dev)
        far = torch.full((n,), cfg.far, dtype=torch.float32, device=dev)
        # The anneal transforms the weights inside the loss, so autograd
        # gives grad(raw) = window · grad(windowed): a closed band's
        # gradient is exactly 0.
        used = (anneal_model_params(params, rcfg.mlp, anneal)
                if cfg.freq_anneal > 0 else params)
        out = render_rays(used, rays_o, rays_d, viewdirs, near, far, rcfg,
                          key=k_render, ray_ids=ray_ids,
                          noise_scale=noise_scale, occupancy=occupancy)
        mse_fine = torch.mean((out["rgb"] - target) ** 2)
        if occupancy is not None:
            # No coarse image on the occupancy path (rgb_coarse is rgb):
            # scoring it would double the fine gradient.
            loss = mse_fine
        else:
            loss = mse_fine + torch.mean((out["rgb_coarse"] - target) ** 2)
        if cfg.distortion_loss > 0.0:
            coef = _f32(np.float32(cfg.distortion_loss)
                        * np.float32(dist_scale))
            loss = loss + coef * torch.mean(
                distortion_loss(out["weights"], out["t"], near, far))
        if cfg.occlusion_loss > 0.0:
            loss = loss + _f32(cfg.occlusion_loss) * torch.mean(
                occlusion_loss(out["weights"], out["t"], near, far,
                               _f32(cfg.occlusion_frac)))
        leaves = tree_leaves(params)
        # Under occupancy the coarse net is off the graph: its gradient is
        # exactly zero, and Adam must still see it.
        flat = torch.autograd.grad(loss, leaves,
                                   allow_unused=occupancy is not None)
        grads = [g if g is not None else torch.zeros_like(x)
                 for g, x in zip(flat, leaves)]
        return loss.detach(), mse_fine.detach(), grads

    def average(per_shard, like):
        """The shards' (loss, mse_fine, grads) averaged over the mesh."""
        if mesh is None:
            return per_shard[0]
        if cfg.fused_allreduce:
            # One collective for everything: the flattened gradients with
            # the two scalars packed onto the end.
            (packed,) = shard_mean(mesh, [
                [torch.cat([*(g.reshape(-1) for g in grads),
                            torch.stack([loss, mse])])]
                for loss, mse, grads in per_shard])
            sizes = [x.numel() for x in like]
            parts = torch.split(packed[:-2], sizes)
            return (packed[-2], packed[-1],
                    [p.reshape(x.shape) for p, x in zip(parts, like)])
        loss, mse, *grads = shard_mean(
            mesh, [[loss, mse, *grads] for loss, mse, grads in per_shard])
        return loss, mse, grads

    def step_fn(state: TrainState, occupancy, key: torch.Tensor,
                images, poses, train_idx: torch.Tensor, precrop: bool):
        k_img, k_pix, k_render = split(key, 3)
        schedule = schedules(cfg, state.step)
        home = tree_leaves(state.params)[0].device
        if mesh is None:
            shards = [(slice(0, cfg.n_rays), images.device)]
        else:
            shards = [(ray_sharding(mesh).rows(cfg.n_rays, s), dev)
                      for s, dev in mesh.local_shards]
        # Per distinct device: the global batch, drawn there from the
        # same key, and the params as leaves of a graph.
        batch, params, occ = {}, {}, {}
        per_shard = []
        for rows, dev in shards:
            if dev not in batch:
                batch[dev] = pick_rays((k_img, k_pix),
                                       to_device(images, dev),
                                       to_device(poses, dev), train_idx,
                                       precrop)
                params[dev] = {
                    net: {name: {p: t.detach().requires_grad_()
                                 for p, t in layer.items()}
                          for name, layer in tree.items()}
                    for net, tree in to_device(state.params, dev).items()}
                occ[dev] = (None if occupancy is None
                            else to_device(occupancy, dev))
            per_shard.append(shard_grads(params[dev], occ[dev], k_render,
                                         batch[dev], rows, schedule))
        loss, mse_fine, flat = average(per_shard,
                                       tree_leaves(state.params))
        it = iter(to_device(g, home) for g in flat)
        grads = {net: {name: {p: next(it) for p in layer}
                       for name, layer in tree.items()}
                 for net, tree in state.params.items()}
        new_params, opt_state = opt.update(grads, state.opt_state,
                                           state.params)
        if with_occupancy:
            # Zeroed coarse updates (optax's p + 0): the momentum from the
            # warm-up would otherwise keep moving the frozen coarse net.
            new_params = {**new_params, "coarse": {
                name: {p: t.detach() + 0.0 for p, t in layer.items()}
                for name, layer in state.params["coarse"].items()}}
        ema = state.ema_params
        if cfg.ema_decay > 0.0:
            ema = ema_update(ema, new_params, cfg.ema_decay)
        loss, mse_fine = to_device(loss, home), to_device(mse_fine, home)
        metrics = {"loss": loss, "mse_fine": mse_fine,
                   "psnr": -10.0 * torch.log10(mse_fine),
                   "grad_norm": global_norm(grads)}
        return TrainState(params=new_params, opt_state=opt_state,
                          step=state.step + 1, ema_params=ema), metrics

    if with_occupancy:
        return step_fn

    def step_no_occ(state: TrainState, key: torch.Tensor, images, poses,
                    train_idx: torch.Tensor, precrop: bool):
        return step_fn(state, None, key, images, poses, train_idx, precrop)

    return step_no_occ


class Trainer:
    """Host-side training driver: the step, the per-step keys
    (``fold_in(PRNGKey(seed), i)``) and the periodic callbacks, as the JAX
    ``Trainer`` runs them. The data goes to the device of the state's
    params; with a ``mesh``, the state goes to the mesh's first device and
    the images, poses and any occupancy grid are replicated over it
    (``replicate_to_mesh``). ``steps_per_call > 1`` runs the same single
    steps one after another (the JAX scan is numerically the single
    steps)."""

    def __init__(self, cfg: TrainConfig, state: TrainState, images, poses,
                 train_idx, seed: int = 0, mesh: Mesh | None = None,
                 steps_per_call: int = 1):
        if not 0.0 <= cfg.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got "
                             f"{cfg.ema_decay}")
        if cfg.ema_decay > 0.0 and state.ema_params is None:
            raise ValueError("ema_decay > 0 needs a state with the EMA "
                             "slot — create_train_state(ema=True)")
        if cfg.ema_decay == 0.0 and state.ema_params is not None:
            # Silent otherwise: the step would carry the stale average
            # along, checkpoints would keep it and serving prefers it.
            raise ValueError("state carries an EMA average but "
                             "TrainConfig.ema_decay is 0 — the average "
                             "would freeze silently")
        if cfg.occlusion_loss > 0.0 and not 0.0 < cfg.occlusion_frac < 1.0:
            # At frac >= 1 the window is the whole ray: the empty-scene
            # objective.
            raise ValueError(f"occlusion_frac must be in (0, 1), got "
                             f"{cfg.occlusion_frac}")
        if cfg.ray_batching:
            pool = len(np.asarray(train_idx)) * cfg.height * cfg.width
            if cfg.n_rays > pool:
                raise ValueError(
                    f"n_rays={cfg.n_rays} exceeds the ray-batching pool of "
                    f"{pool} pixels across the train split")
        self.cfg = cfg
        self.mesh = mesh
        self.step_fn = make_train_step(cfg, mesh)
        self.state = state if mesh is None else to_device(state, mesh.home)
        # Occupancy training: set_occupancy installs a grid and the
        # occupancy step.
        self.occupancy = None
        self._step_fn_occ: Callable | None = None
        # steps_per_call is accepted for the JAX signature and changes nothing.
        del steps_per_call
        self.base_key = PRNGKey(seed)
        dev = tree_leaves(self.state.params)[0].device
        self.images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        self.poses = torch.as_tensor(poses, dtype=torch.float32)[:, :3, :4]
        self.poses = self.poses.to(dev)
        if mesh is not None:
            self.images = replicate_to_mesh(self.images, mesh)
            self.poses = replicate_to_mesh(self.poses, mesh)
        # Read on the host (the image draw); the ray-batching draw copies
        # it to each shard's device.
        self.train_idx = torch.as_tensor(train_idx, dtype=torch.int64)
        self.callbacks: list[tuple[int, Callable]] = []
        self._last_metrics: dict[str, Any] = {}

    def set_occupancy(self, grid) -> None:
        """Install (or refresh) a baked ``OccupancyGrid``: the following
        steps are occupancy steps through it (replicated over the mesh)."""
        self.occupancy = (grid if self.mesh is None
                          else replicate_to_mesh(grid, self.mesh))
        if self._step_fn_occ is None:
            self._step_fn_occ = make_train_step(self.cfg, self.mesh,
                                                with_occupancy=True)

    def maybe_set_occupancy(self, grid, occupied_frac: float | None = None
                            ) -> str:
        """:meth:`set_occupancy` behind the empty-grid guard; returns
        ``"switched"`` (the first grid), ``"rebaked"`` (a refresh),
        ``"postponed"`` (an empty grid before the switch: train on through
        the coarse net and retry) or ``"kept"`` (an empty grid after it:
        keep the last one). An empty grid gives every ray the ε-uniform
        fallback CDF, whose samples can all land where the ReLUs are dead,
        and the gradient would be zero for good."""
        if occupied_frac is None:
            occupied_frac = occupied_fraction(grid)
        if occupied_frac <= 0.0:
            return "postponed" if self.occupancy is None else "kept"
        switched = self.occupancy is None
        self.set_occupancy(grid)
        return "switched" if switched else "rebaked"

    def add_callback(self, every: int, fn: Callable) -> None:
        """Register ``fn(step, trainer, metrics)`` to run every ``every``
        steps (``every <= 0`` disables it)."""
        if every > 0:
            self.callbacks.append((every, fn))

    def _finalize_metrics(self, metrics: dict, rays_done: int,
                          t0: float) -> dict:
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        if rays_done > 0:
            m["rays_per_sec"] = rays_done / max(time.time() - t0, 1e-9)
        else:
            m["rays_per_sec"] = self._last_metrics.get("rays_per_sec", 0.0)
        self._last_metrics = m
        return m

    def run(self, start: int, iters: int) -> dict:
        """Train steps ``start .. iters - 1`` (the reference's 1-based
        loop); returns the last step's metrics as floats with
        ``rays_per_sec`` over the window since the last callback."""
        if start >= iters:
            return dict(self._last_metrics)
        t0 = time.time()
        rays_done = 0
        for i in range(start, iters):
            args = (fold_in(self.base_key, i), self.images, self.poses,
                    self.train_idx, i < self.cfg.precrop_iters)
            if self.occupancy is not None:
                self.state, metrics = self._step_fn_occ(
                    self.state, self.occupancy, *args)
            else:
                self.state, metrics = self.step_fn(self.state, *args)
            rays_done += self.cfg.n_rays
            final_m = None
            for every, fn in self.callbacks:
                if i % every == 0 and i > 0:
                    if final_m is None:
                        final_m = self._finalize_metrics(metrics, rays_done,
                                                         t0)
                    fn(i, self, final_m)
            if final_m is not None:
                # Slow callbacks do not count against rays_per_sec.
                t0 = time.time()
                rays_done = 0
        return self._finalize_metrics(metrics, rays_done, t0)
