"""The coarse/fine hierarchical volume renderer (port of
the JAX package's ``render/renderer.py``): stratified coarse samples → coarse MLP
→ composite → inverse-CDF resampling on the detached weights → merge with
the coarse depths → fine MLP → composite.

Random draws are keyed by ``(key, tag, global ray id)`` through
``ops/rng.py``, bit for bit as in the JAX package: tag 1 the stratified
jitter, 2 the resample (sorted uniforms, or iid then sorted), 3 and 4 the
coarse and fine density noise. A render is therefore independent of the
chunk size. ``render_rays`` is differentiable in the params (training);
``render_rays_chunked`` is a frame's chunk loop, the JAX ``lax.map``
(``render/frames.py`` runs it inside a frame program, captured in one CUDA
graph on a card). Near and far may be Python floats, ``[n_rays]`` tensors
or 0-d tensors on the rays' device: a frame program passes 0-d tensors,
so that a captured frame reads them from device memory and nothing
renders from a value frozen at capture. With a baked occupancy grid
(``render/occupancy.py``) the grid probe replaces the coarse MLP:
``"merge"`` keeps the fine pass's shape, ``"full"`` draws every fine
sample from the probe CDF (with ``occ_floor`` of them from a stratified
coverage draw, RNG tag 5), and ``occupancy_termination`` tightens each
ray's interval by a probe march first. With a device mesh
(``parallel/mesh.py``) ``render_rays_chunked`` splits each chunk's rays
into contiguous shards with their global ids, renders each shard on its
device and puts the shards back in order (across processes through an
``all_gather``, so every rank holds the whole result); the draws' keying
makes that bitwise the unsharded render, up to the kernels' own rounding.
Which net a pass queries, and how, is the family of ``RenderConfig.mlp``
(``models/family.py``): NeRF's pair or the one Instant-NGP field.
"""

from __future__ import annotations

import dataclasses

import torch

from cvnerf_torch.models.family import family_of
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.compositing import volume_render
from cvnerf_torch.ops.rng import (key_on, ray_normal, ray_sorted_uniform,
                                  ray_uniform)
from cvnerf_torch.ops.sampling import (merge_sorted, sample_pdf,
                                       stratified_samples)
from cvnerf_torch.parallel.mesh import (Mesh, ray_sharding, shard_gather,
                                        to_device)
from cvnerf_torch.render.occupancy import occupancy_ray_bounds, probe_sigma


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-time configuration: the JAX ``RenderConfig``'s fields and
    defaults, ``pallas`` as ``kernels``."""
    n_coarse: int = 64
    n_fine: int = 128
    perturb: bool = True
    noise_std: float = 0.0
    white_bkg: bool = False
    deterministic_resample: bool = False
    # Draw the inverse-CDF uniforms pre-sorted per ray (exponential
    # spacings, ops/rng.ray_sorted_uniform); False draws iid uniforms and
    # sorts the merged depths (the reference-shaped stream).
    sorted_resample: bool = True
    # Occupancy-grid rendering (only when a grid is passed): "merge" keeps
    # the fine pass (probe depths merged with the resample), "full" runs
    # the fine net on the n_fine resamples alone.
    occupancy_mode: str = "merge"
    # The probe: "nearest" (default) or "trilinear".
    occupancy_interp: str = "nearest"
    # Full mode: this many of the n_fine samples come from a stratified
    # draw over [near, far] instead of the probe CDF (0 = none).
    occ_floor: int = 0
    # Early termination / empty-space skip epsilon (0 = off), probed at
    # termination_probes uniform depths.
    occupancy_termination: float = 0.0
    termination_probes: int = 128
    # Also return the fine pass's compositing weights and depths
    # ("weights", "t"), for the training regularizers; off by default, so
    # the chunked frame path stacks nothing extra.
    return_weights: bool = False
    mlp: NerfMLPConfig = NerfMLPConfig()
    compute_dtype: torch.dtype = torch.float32
    # MLP execution path: "on" runs the fused CUDA kernel for CUDA tensors
    # (and its plain version for CPU tensors); "off" always runs the plain
    # freq_encode + apply_nerf path (the JAX pallas="off" counterpart).
    kernels: str = "on"

    def eval_mode(self) -> "RenderConfig":
        """Test-time variant: no jitter, no density noise."""
        return dataclasses.replace(self, perturb=False, noise_std=0.0)

    def check_supported(self) -> None:
        """Raise for a configuration the port cannot render."""
        if self.kernels not in ("on", "off"):
            raise ValueError(f"kernels must be 'on' or 'off', got "
                             f"{self.kernels!r}")

    def needs_key(self) -> bool:
        """Whether a render draws random numbers (and so needs a key)."""
        return (self.perturb or self.noise_std > 0
                or (self.n_fine > 0 and not self.deterministic_resample))


def _query_mlp(net, points: torch.Tensor, viewdirs: torch.Tensor,
               cfg: RenderConfig) -> torch.Tensor:
    """One net's raw ``[n_rays, n_samples, 4]`` at ``points`` with per-ray
    ``viewdirs``, as the model's family queries it."""
    return family_of(cfg.mlp).query(net, points, viewdirs, cfg)


def render_rays(params: dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                viewdirs: torch.Tensor, near, far, cfg: RenderConfig,
                key: torch.Tensor | None = None,
                ray_ids: torch.Tensor | None = None,
                noise_scale: float | torch.Tensor = 1.0,
                occupancy=None) -> dict:
    """Hierarchical volume render of a ray batch, differentiable in the
    params.

    Args:
        params: the nets of ``cfg.mlp``'s family: ``{"coarse", "fine"}``
            (params, packed or int8 nets) or ``{"field"}``.
        rays_o, rays_d: ``[n_rays, 3]`` (possibly NDC-warped) rays.
        viewdirs: ``[n_rays, 3]`` unit directions of the pre-NDC rays.
        near, far: scalars or ``[n_rays]`` bounds.
        key: ``ops.rng`` key of the draws; needed when ``cfg.needs_key()``.
        ray_ids: ``[n_rays]`` global ray ids keying the draws (default
            ``arange``); a chunk or shard passes its rays' global positions.
        noise_scale: multiplier on the density-noise std.
        occupancy: a baked ``OccupancyGrid``: its probe at the stratified
            depths replaces the coarse MLP (no coarse noise, no coarse
            image: ``rgb_coarse`` is the fine map), and ``params["coarse"]``
            is not read.
    Returns:
        ``rgb`` (fine), ``rgb_coarse``, ``acc`` and ``depth`` (fine pass);
        with ``cfg.return_weights`` also the fine pass's ``weights`` and
        depths ``t``.
    """
    cfg.check_supported()
    family = family_of(cfg.mlp)
    if key is None and cfg.needs_key():
        raise ValueError("this configuration draws random numbers (perturb, "
                         "noise_std or a stochastic resample): pass key=")
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    if key is not None:
        key = key_on(key, dev)       # every draw below reads it there
    if ray_ids is None:
        ray_ids = torch.arange(n_rays, dtype=torch.int64, device=dev)
    if occupancy is not None and cfg.occupancy_termination > 0.0:
        # Tighten each ray's interval by a probe march before any MLP work.
        near, far = occupancy_ray_bounds(
            occupancy, rays_o, rays_d, near, far,
            eps=cfg.occupancy_termination, n_probe=cfg.termination_probes)
    u_strat = (ray_uniform(key, 1, ray_ids, cfg.n_coarse) if cfg.perturb
               else None)
    t_coarse = stratified_samples(near, far, cfg.n_coarse, n_rays,
                                  cfg.perturb, u=u_strat, device=dev)
    points = rays_o[..., None, :] + rays_d[..., None, :] * t_coarse[..., None]
    if occupancy is not None:
        # The grid's density drives the resample: no coarse MLP.
        sigma = probe_sigma(occupancy, points, cfg.occupancy_interp)
        raw = torch.cat([sigma.new_zeros(*sigma.shape, 3), sigma[..., None]],
                        -1)
        coarse = volume_render(raw, t_coarse, rays_d, noise_std=0.0,
                               white_bkg=cfg.white_bkg, noise=None)
    else:
        raw = _query_mlp(family.net(params, "coarse"), points, viewdirs,
                         cfg)
        noise_c = (ray_normal(key, 3, ray_ids, cfg.n_coarse) * noise_scale
                   if cfg.noise_std > 0 else None)
        coarse = volume_render(raw, t_coarse, rays_d,
                               noise_std=cfg.noise_std,
                               white_bkg=cfg.white_bkg, noise=noise_c)

    occ_full = (occupancy is not None and cfg.occupancy_mode == "full"
                and cfg.n_fine > 0)
    if occ_full and not 0 <= cfg.occ_floor < cfg.n_fine:
        raise ValueError(
            f"occ_floor={cfg.occ_floor} must be in [0, n_fine="
            f"{cfg.n_fine}) — the floor replaces part of the fine "
            "budget, it does not extend it")
    if cfg.n_fine > 0:
        mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
        # Full mode with a floor: k of the n_fine samples are a coverage
        # draw, so only n_fine - k come from the CDF.
        n_pdf = (cfg.n_fine - cfg.occ_floor
                 if occ_full and cfg.occ_floor > 0 else cfg.n_fine)
        if cfg.deterministic_resample:
            u_pdf = None
        elif cfg.sorted_resample:
            u_pdf = ray_sorted_uniform(key, 2, ray_ids, n_pdf)
        else:
            u_pdf = ray_uniform(key, 2, ray_ids, n_pdf)
        # The resampled depths carry no gradient (reference main.py:250).
        t_new = sample_pdf(mids, coarse["weights"][..., 1:-1].detach(),
                           n_pdf, u=u_pdf,
                           deterministic=cfg.deterministic_resample).detach()
        if occ_full:
            # Every fine sample from the probe CDF; the probe depths
            # carry nothing learned and are not merged in.
            t_fine = torch.sort(t_new, dim=-1).values
            if cfg.occ_floor > 0:
                u_floor = (ray_uniform(key, 5, ray_ids, cfg.occ_floor)
                           if cfg.perturb else None)
                t_floor = stratified_samples(near, far, cfg.occ_floor,
                                             n_rays, cfg.perturb,
                                             u=u_floor, device=dev)
                t_fine = merge_sorted(t_floor, t_fine)
        else:
            # Sorted (or evenly spaced) u gives ascending t_new, so the
            # JAX package merges; iid u sorts. Both are one sort here.
            t_fine = merge_sorted(t_coarse, t_new)
    else:
        t_fine = t_coarse

    points = rays_o[..., None, :] + rays_d[..., None, :] * t_fine[..., :, None]
    raw = _query_mlp(family.net(params, "fine"), points, viewdirs, cfg)
    noise_f = (ray_normal(key, 4, ray_ids, t_fine.shape[-1]) * noise_scale
               if cfg.noise_std > 0 else None)
    fine = volume_render(raw, t_fine, rays_d, noise_std=cfg.noise_std,
                         white_bkg=cfg.white_bkg, noise=noise_f)
    out = {"rgb": fine["rgb"],
           "rgb_coarse": fine["rgb"] if occupancy is not None
           else coarse["rgb"],
           "acc": fine["acc"], "depth": fine["depth"]}
    if cfg.return_weights:
        out["weights"] = fine["weights"]
        out["t"] = t_fine
    return out


@torch.no_grad()
def render_rays_chunked(params: dict, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, viewdirs: torch.Tensor,
                        near, far, cfg: RenderConfig,
                        chunk: int = 4096,
                        key: torch.Tensor | None = None,
                        occupancy=None, mesh: Mesh | None = None) -> dict:
    """Memory-bounded render of a flat ray batch: a Python loop over
    ``chunk``-ray slices. The rays are padded with zero rays to a chunk
    multiple, as the JAX ``lax.map`` does, and the padding is dropped on
    return, so every chunk has the same shape. ``near`` and ``far`` are
    floats or 0-d tensors on the rays' device. Each chunk keys its draws
    by its rays' global ids, so the result does not depend on ``chunk``.
    ``occupancy`` is a baked grid every chunk renders through. With
    ``mesh``, each chunk's rays split into ``mesh.size`` contiguous shards
    (``chunk`` must divide into them), each rendered on its shard's device
    with the params and grid there (``replicate_to_mesh`` values, or
    copied); the result lies on the rays' device, on every rank."""
    n = rays_o.shape[0]
    if mesh is not None and chunk % mesh.size != 0:
        raise ValueError(f"chunk={chunk} must be divisible by mesh size "
                         f"{mesh.size}")
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def pad0(x):
        return torch.cat([x, x.new_zeros(pad, *x.shape[1:])])

    out_dev = rays_o.device
    if mesh is None:
        shards = [(slice(0, chunk), out_dev)]
    else:
        shards = [(ray_sharding(mesh).rows(chunk, s), d)
                  for s, d in mesh.local_shards]
    # Per distinct device: the params, the grid and the padded rays there.
    placed = {d: (to_device(params, d), to_device(occupancy, d),
                  *(to_device(pad0(x), d) for x in (rays_o, rays_d,
                                                   viewdirs)))
              for _, d in shards}
    outs = [[] for _ in shards]
    for i in range(n_chunks):
        for j, (rows, d) in enumerate(shards):
            p, occ, ro, rd, vd = placed[d]
            sl = slice(i * chunk + rows.start, i * chunk + rows.stop)
            ids = torch.arange(sl.start, sl.stop, dtype=torch.int64,
                               device=d)
            outs[j].append(render_rays(p, ro[sl], rd[sl], vd[sl], near, far,
                                       cfg, key=key, ray_ids=ids,
                                       occupancy=occ))
    if mesh is None:
        return {k: torch.cat([o[k] for o in outs[0]])[:n] for k in outs[0][0]}
    result = {}
    for k in outs[0][0]:
        # [n_chunks, chunk / size, ...] a shard, interleaved back to the
        # chunk-major ray order.
        pieces = shard_gather(mesh, [torch.stack([o[k] for o in shard_outs])
                                     for shard_outs in outs], out_dev)
        full = torch.stack(pieces, 1)
        result[k] = full.reshape(n_chunks * chunk, *full.shape[3:])[:n]
    return result
