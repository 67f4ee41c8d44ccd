"""The train step and the host-side training loop (port of the plain
branch of the JAX package's ``train/loop.py``).

One step, as the JAX step computes it: split the step key into image,
pixel and render keys; draw one training image (``randint``) and
``n_rays`` of its pixels without replacement (a keyed Feistel permutation,
or with replacement), with the centre crop during the precrop warm-up;
build those pixels' rays; render them (coarse and fine MLP through the
fused kernels and their backward); loss MSE(fine) + MSE(coarse); backward;
Adam. The random draws are the JAX package's bit for bit (``ops/rng.py``),
so a step from the same state and key matches the JAX step.

The step runs eagerly: the pixel permutation is drawn on the host and
copied to the card without waiting for it; the render and the backward are
the device's work. Options of the JAX trainer that this slice does not
carry raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from cvnerf_torch.ops.rays import ndc_rays, rays_for_pixels
from cvnerf_torch.ops.rng import (PRNGKey, fold_in, randint,
                                  sample_without_replacement, split)
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.train.state import TrainState, make_optimizer, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the JAX ``TrainConfig``'s fields and
    defaults (see its notes). The fields after ``pixel_sampling`` are
    flag-gated levers that this slice refuses unless they are off."""
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
    pixel_sampling: str = "prp"   # "prp" | "replace" ("parity": not yet)
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


LEVERS_ITEM = "ROADMAP Queue 1 item 9 (flag-gated training levers)"
MESH_ITEM = "ROADMAP Queue 1 item 11 (data parallelism)"


def check_supported(cfg: TrainConfig) -> None:
    """Raise for options this slice does not carry, and for the JAX step's
    invalid configurations."""
    unported = [(name, item) for name, on, item in (
        ("pixel_sampling='parity'", cfg.pixel_sampling == "parity",
         LEVERS_ITEM),
        ("ray_batching", cfg.ray_batching, LEVERS_ITEM),
        ("ema_decay", cfg.ema_decay > 0, LEVERS_ITEM),
        ("noise_decay", cfg.noise_decay > 0, LEVERS_ITEM),
        ("freq_anneal", cfg.freq_anneal > 0, LEVERS_ITEM),
        ("distortion_loss", cfg.distortion_loss > 0, LEVERS_ITEM),
        ("occlusion_loss", cfg.occlusion_loss > 0, LEVERS_ITEM),
        ("fused_allreduce", cfg.fused_allreduce, MESH_ITEM)) if on]
    if unported:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{n} ({i})" for n, i in unported))
    if cfg.pixel_sampling not in ("prp", "replace"):
        raise ValueError(f"bad pixel_sampling: {cfg.pixel_sampling!r}")
    if cfg.n_rays > cfg.height * cfg.width:
        raise ValueError(
            f"n_rays={cfg.n_rays} exceeds the {cfg.height}x{cfg.width} "
            "pixel grid (sampling is without replacement)")
    if cfg.precrop_iters > 0:
        crop = (2 * int(cfg.height // 2 * cfg.precrop_frac)
                * 2 * int(cfg.width // 2 * cfg.precrop_frac))
        if cfg.n_rays > crop:
            raise ValueError(
                f"n_rays={cfg.n_rays} exceeds the precrop grid of {crop} "
                f"pixels (precrop_frac={cfg.precrop_frac})")


def _sample_pixels(key: torch.Tensor, cfg: TrainConfig,
                   precrop: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_rays`` (py, px) pixel coordinates (int64, on the CPU): the
    centre-crop grid during warm-up, then the whole image."""
    h, w = cfg.height, cfg.width
    if precrop:
        dh = int(h // 2 * cfg.precrop_frac)
        dw = int(w // 2 * cfg.precrop_frac)
        y0, x0 = h // 2 - dh, w // 2 - dw
        gh, gw = 2 * dh, 2 * dw
    else:
        y0 = x0 = 0
        gh, gw = h, w
    if cfg.pixel_sampling == "prp":
        flat = sample_without_replacement(key, cfg.n_rays, gh * gw)
    else:
        flat = randint(key, (cfg.n_rays,), 0, gh * gw).to(torch.int64)
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


def make_train_step(cfg: TrainConfig, mesh=None) -> Callable:
    """``step_fn(state, key, images, poses, train_idx, precrop) ->
    (new_state, metrics)``: the JAX ``make_train_step(cfg, mesh=None)``.
    ``images [N, H, W, 3]``, ``poses [N, 3, 4]`` and ``train_idx`` (int64)
    lie on the params' device; the metrics are 0-d tensors there."""
    if mesh is not None:
        raise NotImplementedError(f"device meshes: {MESH_ITEM}")
    check_supported(cfg)
    opt = make_optimizer(cfg.lr, cfg.lr_decay)
    rcfg = cfg.render

    def step_fn(state: TrainState, key: torch.Tensor, images: torch.Tensor,
                poses: torch.Tensor, train_idx: torch.Tensor, precrop: bool):
        k_img, k_pix, k_render = split(key, 3)
        dev = images.device
        j = int(randint(k_img, (), 0, train_idx.shape[0]))
        im = int(train_idx[j])
        py, px = _sample_pixels(k_pix, cfg, precrop)
        py, px = _to(py, dev), _to(px, dev)
        target = images[im][py, px]
        rays_o, rays_d = rays_for_pixels(px, py, cfg.width, cfg.height,
                                         cfg.focal, poses[im])
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if cfg.ndc:
            rays_o, rays_d = ndc_rays(cfg.height, cfg.width, cfg.focal, 1.0,
                                      rays_o, rays_d, variant=cfg.ndc_variant)
        ray_ids = torch.arange(cfg.n_rays, dtype=torch.int64, device=dev)
        params = {net: {name: {p: t.detach().requires_grad_()
                               for p, t in layer.items()}
                        for name, layer in tree.items()}
                  for net, tree in state.params.items()}
        out = render_rays(params, rays_o, rays_d, viewdirs, cfg.near,
                          cfg.far, rcfg, key=k_render, ray_ids=ray_ids,
                          noise_scale=1.0)
        mse_fine = torch.mean((out["rgb"] - target) ** 2)
        loss = mse_fine + torch.mean((out["rgb_coarse"] - target) ** 2)
        leaves = tree_leaves(params)
        flat = torch.autograd.grad(loss, leaves)
        it = iter(flat)
        grads = {net: {name: {p: next(it) for p in layer}
                       for name, layer in tree.items()}
                 for net, tree in params.items()}
        new_params, opt_state = opt.update(grads, state.opt_state, params)
        metrics = {"loss": loss.detach(), "mse_fine": mse_fine.detach(),
                   "psnr": -10.0 * torch.log10(mse_fine.detach()),
                   "grad_norm": global_norm(grads)}
        return TrainState(params=new_params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return step_fn


class Trainer:
    """Host-side training driver: the step, the per-step keys
    (``fold_in(PRNGKey(seed), i)``) and the periodic callbacks, as the JAX
    ``Trainer`` runs them. The data goes to the device of the state's
    params. ``steps_per_call > 1`` runs the same single steps one after
    another (the JAX scan is numerically the single steps)."""

    def __init__(self, cfg: TrainConfig, state: TrainState, images, poses,
                 train_idx, seed: int = 0, mesh=None, steps_per_call: int = 1):
        if mesh is not None:
            raise NotImplementedError(f"device meshes: {MESH_ITEM}")
        self.cfg = cfg
        self.state = state
        self.step_fn = make_train_step(cfg)
        # steps_per_call is accepted for the JAX signature and changes nothing.
        del steps_per_call
        self.base_key = PRNGKey(seed)
        dev = tree_leaves(state.params)[0].device
        self.images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        self.poses = torch.as_tensor(poses, dtype=torch.float32)[:, :3, :4]
        self.poses = self.poses.to(dev)
        self.train_idx = torch.as_tensor(train_idx, dtype=torch.int64)
        self.callbacks: list[tuple[int, Callable]] = []
        self._last_metrics: dict[str, Any] = {}

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
            self.state, metrics = self.step_fn(
                self.state, fold_in(self.base_key, i), self.images,
                self.poses, self.train_idx, i < self.cfg.precrop_iters)
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
