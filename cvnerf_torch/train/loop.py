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

The Instant-NGP field (``models/ngp_field.py``, an ``NgpFieldConfig`` in
``RenderConfig.mlp``; ``TrainConfig.model`` reads ``"ngp"``) trains on the
same path: its params are ``{"field": ...}``, queried by both passes, and
its optimizer is the paper's (``optimizer_for``). Occupancy training and the
frequency anneal are NeRF's alone.

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

Every draw of the step runs on the params' device (the threefry and
Feistel kernels of ``ops/threefry.py`` on a card), the image and pixel
picks are device gathers, and the per-step scalars (Adam's learning rate
and bias corrections, the noise, anneal and distortion schedules) enter as
one float32 row formed on the host (``step_row``). So a step reads no
device value back to the host, and ``make_train_scan`` captures it in a
CUDA graph: a block of ``steps_per_call`` steps is then one dispatch of
graph replays, as a block is one ``lax.scan`` program in the JAX package.
The eager step and the captured one are one code path
(``_build_step_core``): the eager step hands it a one-row table, the
captured step reads its row from the block's table through a device
counter.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from cvnerf_torch import staged
from cvnerf_torch.models.nerf_mlp import anneal_model_params
from cvnerf_torch.models.ngp_field import is_ngp
from cvnerf_torch.ops import hash_encode, ngp_mlp
from cvnerf_torch.ops.compositing import distortion_loss, occlusion_loss
from cvnerf_torch.ops.rays import (ndc_rays, rays_for_pixels,
                                   rays_for_pixels_batched)
from cvnerf_torch.ops.rng import (PRNGKey, choice_without_replacement,
                                  fold_in, key_on, randint,
                                  sample_without_replacement, split)
from cvnerf_torch.parallel.mesh import (Mesh, Replicated, ray_sharding,
                                        replicate_to_mesh, shard_mean,
                                        to_device)
from cvnerf_torch.render.occupancy import occupied_fraction
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.train.state import (Adam, AdamState, TrainState,
                                      clone_tree, ema_update,
                                      make_optimizer, tree_leaves, tree_like,
                                      tree_map)
from cvnerf_torch.utils import tracing
from cvnerf_torch.utils.graphs import GraphProgram


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

    @property
    def model(self) -> str:
        """The field kind: ``"ngp"`` for an ``NgpFieldConfig`` in
        ``render.mlp``, else ``"nerf"``."""
        return "ngp" if is_ngp(self.render.mlp) else "nerf"


def optimizer_for(cfg: TrainConfig) -> Adam:
    """The optimizer of ``cfg``'s model (``state.make_optimizer``)."""
    return make_optimizer(cfg.lr, cfg.lr_decay, cfg.render.mlp)


def check_supported(cfg: TrainConfig, with_occupancy: bool = False) -> None:
    """Raise for the JAX step's invalid configurations, and for the levers
    the Instant-NGP field does not take."""
    if cfg.model == "ngp" and (with_occupancy or cfg.freq_anneal > 0):
        raise ValueError("the Instant-NGP field trains without occupancy "
                         "training and without freq_anneal")
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
                   device: torch.device | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_rays`` (py, px) pixel coordinates (int64, drawn on the key's
    device, or on ``device``): the centre-crop grid during warm-up, then
    the whole image."""
    key = key_on(key, device)
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
        flat = choice_without_replacement(key, cfg.n_rays, gh * gw)
    elif cfg.pixel_sampling == "prp":
        flat = sample_without_replacement(key, cfg.n_rays, gh * gw)
    else:
        flat = randint(key, (cfg.n_rays,), 0, gh * gw).to(torch.int64)
    return y0 + flat // gw, x0 + flat % gw


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


# The columns of a step's scalar row: Adam's (``Adam.scalars``), then the
# schedules'.
ROW = ("lr_step", "bc1", "bc2", "noise", "anneal", "dist")


def step_row(cfg: TrainConfig, opt: Adam, step: int,
             count: int) -> np.ndarray:
    """The float32 scalars of the step taken from ``state.step == step``
    with Adam's update count ``count`` (columns ``ROW``), formed on the
    host as the single step formed them before it read them from a row."""
    return np.concatenate([opt.scalars(count),
                           np.array(schedules(cfg, step), np.float32)])


def _build_step_core(cfg: TrainConfig, mesh: Mesh | None,
                     with_occupancy: bool, opt: Adam | None = None
                     ) -> Callable:
    """``core(state, occupancy, key, row, images, poses, train_idx,
    precrop) -> (new_state, metrics)``: the step of ``make_train_step``
    with its scalars read from ``row`` (a float32 ``[len(ROW)]`` tensor on
    the params' device) and not from ``state.step`` or the Adam count, so
    the same function runs eagerly and inside a captured graph. ``opt``:
    the optimizer (default ``optimizer_for(cfg)``)."""
    if mesh is not None and cfg.n_rays % mesh.size != 0:
        raise ValueError(
            f"n_rays={cfg.n_rays} must be divisible by the mesh size "
            f"{mesh.size}")
    check_supported(cfg, with_occupancy)
    opt = opt or optimizer_for(cfg)
    rcfg = cfg.render
    if cfg.distortion_loss > 0.0 or cfg.occlusion_loss > 0.0:
        # The regularizers read the fine pass's weights and depths.
        rcfg = dataclasses.replace(rcfg, return_weights=True)

    def pick_rays(keys, images, poses, train_idx, precrop):
        """The step's global batch on the images' device: rays (NDC-warped
        when ``cfg.ndc``), pre-NDC unit view directions and target
        colours. Every pick is a device gather of device-drawn indices."""
        dev = images.device
        k_img, k_pix = (key_on(k, dev) for k in keys)
        train_idx = to_device(train_idx, dev)
        h, w = cfg.height, cfg.width
        pixels = images.reshape(-1, 3)
        if cfg.ray_batching and not precrop:
            # n_rays (image, pixel) pairs over the whole train split, one
            # Feistel draw over n_train·H·W.
            flat = sample_without_replacement(
                k_pix, cfg.n_rays, train_idx.shape[0] * h * w)
            im_idx = train_idx.index_select(0, flat // (h * w))
            pix = flat % (h * w)
            py, px = pix // w, pix % w
            target = pixels.index_select(0, im_idx * (h * w) + pix)
            rays_o, rays_d = rays_for_pixels_batched(
                px, py, w, h, cfg.focal, poses.index_select(0, im_idx))
        else:
            j = randint(k_img, (1,), 0, train_idx.shape[0])
            im = train_idx.index_select(0, j.to(torch.int64))
            py, px = _sample_pixels(k_pix, cfg, precrop)
            target = pixels.index_select(0, (im * h + py) * w + px)
            rays_o, rays_d = rays_for_pixels(px, py, cfg.width, cfg.height,
                                             cfg.focal,
                                             poses.index_select(0, im)[0])
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if cfg.ndc:
            rays_o, rays_d = ndc_rays(cfg.height, cfg.width, cfg.focal, 1.0,
                                      rays_o, rays_d, variant=cfg.ndc_variant)
        return rays_o, rays_d, viewdirs, target

    def shard_grads(params, occupancy, k_render, batch, rows, row):
        """One shard's rays ``rows`` of the global ``batch``: (loss,
        mse_fine, the gradient of every leaf of ``params``)."""
        rays_o, rays_d, viewdirs, target = (x[rows] for x in batch)
        dev = target.device
        noise_scale, anneal, dist_scale = to_device(row, dev)[3:].unbind(0)
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
            # float32(weight) · float32(scale), one rounding, as before.
            coef = dist_scale * _f32(cfg.distortion_loss)
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

    def core(state: TrainState, occupancy, key: torch.Tensor,
             row: torch.Tensor, images, poses, train_idx: torch.Tensor,
             precrop: bool):
        home = tree_leaves(state.params)[0].device
        k_img, k_pix, k_render = split(key_on(key, home), 3)
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
                params[dev] = tree_map(lambda t: t.detach().requires_grad_(),
                                        to_device(state.params, dev))
                occ[dev] = (None if occupancy is None
                            else to_device(occupancy, dev))
            per_shard.append(shard_grads(params[dev], occ[dev], k_render,
                                         batch[dev], rows, row))
        loss, mse_fine, flat = average(per_shard,
                                       tree_leaves(state.params))
        grads = tree_like(state.params, [to_device(g, home) for g in flat])
        new_params, opt_state = opt.update(grads, state.opt_state,
                                           state.params, row[:3])
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

    return core


def make_train_step(cfg: TrainConfig, mesh: Mesh | None = None,
                    with_occupancy: bool = False,
                    opt: Adam | None = None) -> Callable:
    """``step_fn(state, key, images, poses, train_idx, precrop) ->
    (new_state, metrics)``: the JAX ``make_train_step(cfg, mesh=None)``.
    ``images [N, H, W, 3]`` and ``poses [N, 3, 4]`` lie on the params'
    device (or, with a mesh, are ``replicate_to_mesh`` values),
    ``train_idx`` (int64) on any; the key on any device (it is moved to
    the params'); the metrics are 0-d tensors on the params' device. With
    ``with_occupancy=True`` the step takes a baked ``OccupancyGrid`` after
    the state: ``step_fn(state, occupancy, key, ...)`` (the occupancy
    step, see the module docstring). With ``mesh`` the batch is split over
    its shards (see the module docstring); ``n_rays`` must divide into
    them. The step's scalar row (``step_row`` of the state's step and Adam
    count) goes to the device with one pinned copy. ``opt``: the
    optimizer (default ``optimizer_for(cfg)``)."""
    opt = opt or optimizer_for(cfg)
    core = _build_step_core(cfg, mesh, with_occupancy, opt)

    def step_fn(state: TrainState, occupancy, key: torch.Tensor,
                images, poses, train_idx: torch.Tensor, precrop: bool):
        home = tree_leaves(state.params)[0].device
        row = staged(step_row(cfg, opt, state.step, state.opt_state.count),
                     home)
        return core(state, occupancy, key, row, images, poses, train_idx,
                    precrop)

    if with_occupancy:
        return step_fn

    def step_no_occ(state: TrainState, key: torch.Tensor, images, poses,
                    train_idx: torch.Tensor, precrop: bool):
        return step_fn(state, None, key, images, poses, train_idx, precrop)

    return step_no_occ


def state_leaves(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step reads and writes: params, Adam moments, EMA."""
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu)
            + (tree_leaves(state.ema_params)
               if state.ema_params is not None else []))


def _grid_tensors(grid) -> list[torch.Tensor]:
    """The tensors of a grid (each copy of a replicated one)."""
    grids = (list(grid.copies.values()) if isinstance(grid, Replicated)
             else [grid])
    return [t for g in grids for t in (g.values, g.bbox_min, g.inv_spacing)]


def _graph_sig(home: torch.device, occupancy, images, poses,
               train_idx) -> tuple:
    """What a captured graph reads outside the scan's buffers: the
    address and shape of the data and the grid tensors (a graph of another
    shape at the same address would index the wrong layout)."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in (
        *(to_device(x, home) for x in (images, poses, train_idx)),
        *(_grid_tensors(occupancy) if occupancy is not None else [])))


class _Block(GraphProgram):
    """The program of ``make_train_scan``: static buffers for the state,
    the block's per-step tables and, on a card, one CUDA graph per
    ``precrop`` variant (see ``make_train_scan``). With ``utils.tracing``
    on, a block is a ``train.block`` span (``captured``: whether it
    captured a graph) holding ``train.prep`` (the host's tables, copies
    and the graph's lookup or capture) and ``train.replay`` (the replays
    queued) or ``train.eager`` (its steps run eagerly)."""

    def __init__(self, cfg: TrainConfig, block: int, mesh: Mesh | None,
                 with_occupancy: bool, opt: Adam | None = None):
        if block < 1:
            raise ValueError(f"block={block} must be positive")
        super().__init__("make_train_scan",
                         f"each block runs as {block} eager steps",
                         replayed_steps=0, eager_steps=0)
        self.cfg, self.block, self.mesh = cfg, block, mesh
        self.opt = opt or optimizer_for(cfg)
        self.core = _build_step_core(cfg, mesh, with_occupancy, self.opt)
        self._bufs: dict | None = None
        self._graphs: dict = {}

    def _static(self, state: TrainState) -> dict:
        """The static buffers, holding ``state`` (copied in unless the
        state already is them)."""
        leaves = state_leaves(state)
        b = self._bufs
        same = (b is not None and len(b["leaves"]) == len(leaves) and all(
            x.shape == y.shape and x.device == y.device
            for x, y in zip(b["leaves"], leaves)))
        if not same:
            home = leaves[0].device
            params = clone_tree(state.params)
            mu, nu = (clone_tree(state.opt_state.mu),
                      clone_tree(state.opt_state.nu))
            ema = (clone_tree(state.ema_params)
                   if state.ema_params is not None else None)
            b = self._bufs = {
                "params": params, "mu": mu, "nu": nu, "ema": ema,
                "key": torch.zeros(2, dtype=torch.int64, device=home),
                "steps": torch.zeros(self.block, dtype=torch.int64,
                                     device=home),
                "rows": torch.zeros(self.block, len(ROW),
                                    dtype=torch.float32, device=home),
                "counter": torch.zeros(1, dtype=torch.int64, device=home)}
            b["leaves"] = state_leaves(self._state(0, 0))
            self._graphs.clear()
        elif any(x is not y for x, y in zip(b["leaves"], leaves)):
            torch._foreach_copy_(b["leaves"], leaves)
        return b

    def _state(self, step: int, count: int) -> TrainState:
        b = self._bufs
        return TrainState(params=b["params"],
                          opt_state=AdamState(count=count, mu=b["mu"],
                                              nu=b["nu"]),
                          step=step, ema_params=b["ema"])

    def _body(self, occupancy, images, poses, train_idx, precrop: bool,
              write: bool = True) -> dict:
        """One step of the block: row ``counter`` of the tables, the step,
        its new state written into the static buffers, the counter
        advanced. ``write=False`` (the warm-up) drops the results."""
        b = self._bufs
        idx = b["counter"]
        key = fold_in(b["key"], b["steps"].index_select(0, idx))
        row = b["rows"].index_select(0, idx)[0]
        new, metrics = self.core(self._state(0, 0), occupancy, key, row,
                                 images, poses, train_idx, precrop)
        if write:
            torch._foreach_copy_(b["leaves"], state_leaves(new))
            idx.add_(1)
        return metrics

    def _graph(self, occupancy, images, poses, train_idx, precrop: bool):
        """The graph of this variant, captured on first use (and again when
        the data or the grid is another tensor or another shape)."""
        home = self._bufs["counter"].device
        sig = _graph_sig(home, occupancy, images, poses, train_idx)
        if not precrop:
            # Precrop blocks come first in a run: free their graph's pool
            # (a later precrop block would capture again).
            self._graphs.pop(True, None)
        got = self._graphs.get(precrop)
        if got is not None and got[0] == sig:
            return got[1], got[2]
        captured = self._capture(
            home, self.mesh, "all-reduce",
            lambda: self._body(occupancy, images, poses, train_idx, precrop),
            lambda: self._body(occupancy, images, poses, train_idx, precrop,
                               write=False))
        if captured is None:
            return None
        self._graphs[precrop] = (sig, *captured)
        return captured

    def __call__(self, state: TrainState, occupancy, base_key, images,
                 poses, train_idx, start: int, precrop: bool):
        with tracing.span("train.block", steps=self.block) as sp:
            with tracing.span("train.prep"):
                b = self._static(state)
                home = b["counter"].device
                rows = np.stack([step_row(self.cfg, self.opt,
                                          state.step + k,
                                          state.opt_state.count + k)
                                 for k in range(self.block)])
                b["rows"].copy_(staged(rows, home))
                b["steps"].copy_(staged(np.arange(start, start + self.block,
                                                  dtype=np.int64), home))
                b["key"].copy_(key_on(base_key, home))
                b["counter"].zero_()
                self._check_cards(home, self.mesh)
                captures = self.stats["captures"]
                captured = None
                if home.type == "cuda" and self.eager_reason is None:
                    captured = self._graph(occupancy, images, poses,
                                           train_idx, precrop)
                    if captured is None:
                        b["counter"].zero_()
            sp.set(captured=self.stats["captures"] > captures)
            if captured is not None:
                graph, out = captured
                with tracing.span("train.replay"):
                    self._replay(graph, self.block)
                metrics = {k: v.clone() for k, v in out.items()}
                self.stats["replayed_steps"] += self.block
            else:
                with tracing.span("train.eager"):
                    for _ in range(self.block):
                        metrics = self._body(occupancy, images, poses,
                                             train_idx, precrop)
                self.stats["eager_steps"] += self.block
        return (self._state(state.step + self.block,
                            state.opt_state.count + self.block), metrics)


def make_train_scan(cfg: TrainConfig, block: int, mesh: Mesh | None = None,
                    with_occupancy: bool = False,
                    opt: Adam | None = None) -> Callable:
    """``scan_fn(state, base_key, images, poses, train_idx, start, precrop)
    -> (new_state, last_metrics)`` runs ``block`` consecutive steps
    ``start .. start + block - 1`` (the JAX ``make_train_scan``; with
    ``with_occupancy=True`` the grid follows the state, as in
    ``make_train_step``). Step ``i``'s key is ``fold_in(base_key, i)`` and
    its scalars ``step_row`` of the state's step and count advanced by
    ``i - start``, so the block is bitwise ``block`` single steps.

    The state's tensors move into static buffers owned by the scan (a
    copy, unless the state passed in is the one the last block returned),
    the block's keys' step indices and scalar rows into static tables
    (one pinned copy each), and every step reads its row through a device
    counter and writes its new state back into the buffers. The returned
    state holds those buffers: like the JAX scan's donated input, it is
    overwritten by the next block, so a caller that keeps a copy copies
    it before then (a checkpoint's host copy does).

    On a card (``mesh=None``, a one-shard mesh, or shards that share one
    card) one step is captured in a CUDA graph after one eager warm-up step
    on a side stream, one graph per ``precrop`` value (the precrop graph is
    dropped once a block without precrop runs), recaptured when the data or
    the grid is another tensor or another shape (``Trainer.set_occupancy``
    refreshes its grid in place, so a rebake keeps the graph), and a block
    is ``block`` replays with no host read of a device value. Launch counters count Python calls, so
    the captured steps' launches are counted once at capture (``stats``:
    captures, replayed and eager steps, capture seconds, the bytes the
    captures reserved). Under a NCCL
    process group the all-reduce is captured too; where NCCL refuses, the
    blocks run as eager steps and one line says so. Several cards in one
    process run eager steps (``eager_reason``), and the CPU runs the same
    body ``block`` times without a graph."""
    runner = _Block(cfg, block, mesh, with_occupancy, opt)
    if with_occupancy:
        def scan_fn(state: TrainState, occupancy, base_key: torch.Tensor,
                    images, poses, train_idx: torch.Tensor, start: int,
                    precrop: bool):
            return runner(state, occupancy, base_key, images, poses,
                          train_idx, start, precrop)
    else:
        def scan_fn(state: TrainState, base_key: torch.Tensor, images,
                    poses, train_idx: torch.Tensor, start: int,
                    precrop: bool):
            return runner(state, None, base_key, images, poses, train_idx,
                          start, precrop)
    scan_fn.runner = runner
    return scan_fn


class Trainer:
    """Host-side training driver: the step, the per-step keys
    (``fold_in(PRNGKey(seed), i)``) and the periodic callbacks, as the JAX
    ``Trainer`` runs them. The data goes to the device of the state's
    params (the image indices too, and the base key); with a ``mesh``, the
    state goes to the mesh's first device and the images, poses and any
    occupancy grid are replicated over it (``replicate_to_mesh``).
    ``steps_per_call > 1`` runs full blocks of that many steps through
    ``make_train_scan`` (on a card, one dispatch of graph replays); a
    block ends where the precrop flag changes and where a callback fires,
    and a shorter stretch runs as single steps (``_block_len``). With
    ``utils.tracing`` on, ``run`` is a ``train.run`` span holding its
    blocks (``train.block``), single steps (``train.step``), host reads of
    the metrics (``train.read``) and fired callbacks
    (``train.callbacks``)."""

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
        # One optimizer for every step function: its stats count them all.
        self.opt = optimizer_for(cfg)
        self.step_fn = make_train_step(cfg, mesh, opt=self.opt)
        self.steps_per_call = max(1, steps_per_call)
        self.scan_fn = (make_train_scan(cfg, self.steps_per_call, mesh,
                                        opt=self.opt)
                        if self.steps_per_call > 1 else None)
        self.state = state if mesh is None else to_device(state, mesh.home)
        # Occupancy training: set_occupancy installs a grid and the
        # occupancy step (and scan); a rebake refreshes the grid in place.
        self.occupancy = None
        self._step_fn_occ: Callable | None = None
        self._scan_fn_occ: Callable | None = None
        dev = tree_leaves(self.state.params)[0].device
        self.base_key = key_on(PRNGKey(seed), dev)
        self.images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        self.poses = torch.as_tensor(poses, dtype=torch.float32)[:, :3, :4]
        self.poses = self.poses.to(dev)
        if mesh is not None:
            self.images = replicate_to_mesh(self.images, mesh)
            self.poses = replicate_to_mesh(self.poses, mesh)
        # On the device: the image draw gathers from it there.
        self.train_idx = torch.as_tensor(np.asarray(train_idx),
                                         dtype=torch.int64).to(dev)
        self.callbacks: list[tuple[int, Callable]] = []
        self._last_metrics: dict[str, Any] = {}

    def set_occupancy(self, grid) -> None:
        """Install (or refresh) a baked ``OccupancyGrid``: the following
        steps are occupancy steps through it (replicated over the mesh).
        The first grid is installed as given; a refresh at the same
        resolution is copied into its tensors, so captured blocks keep
        reading them (the JAX trainer reuses its compiled programs the same
        way); a grid of another size replaces it."""
        new = grid if self.mesh is None else replicate_to_mesh(grid,
                                                                self.mesh)
        old = self.occupancy
        if old is not None and [(t.shape, t.device)
                                for t in _grid_tensors(old)] == [
                (t.shape, t.device) for t in _grid_tensors(new)]:
            torch._foreach_copy_(_grid_tensors(old), _grid_tensors(new))
        else:
            self.occupancy = new
        if self._step_fn_occ is None:
            self._step_fn_occ = make_train_step(self.cfg, self.mesh,
                                                with_occupancy=True,
                                                opt=self.opt)
            if self.steps_per_call > 1:
                self._scan_fn_occ = make_train_scan(
                    self.cfg, self.steps_per_call, self.mesh,
                    with_occupancy=True, opt=self.opt)

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
        with tracing.span("train.read"):
            m = {k: float(v) for k, v in metrics.items()}  # waits for it
        if rays_done > 0:
            m["rays_per_sec"] = rays_done / max(time.time() - t0, 1e-9)
        else:
            m["rays_per_sec"] = self._last_metrics.get("rays_per_sec", 0.0)
        self._last_metrics = m
        return m

    def _block_len(self, i: int, iters: int) -> int:
        """Steps to run in one dispatch starting at ``i``: the scan block
        size, shortened so the precrop flag stays constant and no callback
        would fire before the block's last step (fires after step j where
        j % every == 0 and j > 0; a fire exactly at the last step is fine —
        the block returns that step's metrics)."""
        n = min(self.steps_per_call, iters - i)
        if i < self.cfg.precrop_iters:
            n = min(n, self.cfg.precrop_iters - i)
        for every, _ in self.callbacks:
            j = i if (i % every == 0 and i > 0) else i + every - i % every
            if j < i + n - 1:
                n = j - i + 1
        return max(1, n)

    def run(self, start: int, iters: int) -> dict:
        """Train steps ``start .. iters - 1`` (the reference's 1-based
        loop): full blocks through the scan, anything shorter as single
        steps; returns the last step's metrics as floats with
        ``rays_per_sec`` over the window since the last callback."""
        if start >= iters:
            return dict(self._last_metrics)
        with tracing.span("train.run", steps=iters - start) as sp:
            out = self._run(start, iters)
            if self.cfg.model == "ngp":
                sp.set(**self.counters())
            return out

    def counters(self) -> dict:
        """The optimizer's counts (``Adam.stats``: updates, leaves and
        values under ``skip_zero``), the hash encoding's
        (``ops/hash_encode.py::stats``, prefixed ``hash_``) and the NGP
        MLPs' (``ops/ngp_mlp.py::stats``, prefixed ``mlp_``), as counted at
        eager calls and captures."""
        return {**self.opt.stats,
                **{f"hash_{k}": v for k, v in hash_encode.stats.items()},
                **{f"mlp_{k}": v for k, v in ngp_mlp.stats.items()}}

    def _run(self, start: int, iters: int) -> dict:
        t0 = time.time()
        rays_done = 0
        i = start
        while i < iters:
            precrop = i < self.cfg.precrop_iters
            n = self._block_len(i, iters)
            occ = self.occupancy
            data = (self.images, self.poses, self.train_idx)
            if n > 1 and n == self.steps_per_call:
                if occ is not None:
                    self.state, metrics = self._scan_fn_occ(
                        self.state, occ, self.base_key, *data, i, precrop)
                else:
                    self.state, metrics = self.scan_fn(
                        self.state, self.base_key, *data, i, precrop)
            else:
                n = 1
                key = fold_in(self.base_key, i)
                with tracing.span("train.step"):
                    if occ is not None:
                        self.state, metrics = self._step_fn_occ(
                            self.state, occ, key, *data, precrop)
                    else:
                        self.state, metrics = self.step_fn(
                            self.state, key, *data, precrop)
            last = i + n - 1
            i += n
            rays_done += n * self.cfg.n_rays
            fired = [fn for every, fn in self.callbacks
                     if last % every == 0 and last > 0]
            if fired:
                final_m = self._finalize_metrics(metrics, rays_done, t0)
                with tracing.span("train.callbacks", step=last):
                    for fn in fired:
                        fn(last, self, final_m)
                # Slow callbacks do not count against rays_per_sec.
                t0 = time.time()
                rays_done = 0
        return self._finalize_metrics(metrics, rays_done, t0)
