"""Occupancy grids: probe a baked density grid instead of running the
coarse MLP (port of the JAX package's ``render/occupancy.py``).

The coarse pass exists only to place the fine samples; once the density
field is fixed (serving) or changes slowly (``--occ_train`` past its
warm-up), its shape can be baked once into a voxel grid and probed per
sample for the cost of a gather instead of a 12-layer MLP evaluation.

The bake runs on the render device: the lattice is formed there from a
flat index (``np.linspace`` semantics, the endpoint pinned to the upper
corner), chunk by chunk through the forward kernel with zero view
directions (``fused_nerf_apply`` on weights packed once per bake; its
plain version for CPU tensors; ``kernels="off"`` runs ``apply_nerf``),
then ``relu`` and a max-pool dilation. The probes (nearest and
trilinear) are direct index gathers; they equal the JAX package's one-hot
row contractions (``tests/test_torch_port_occupancy.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, apply_nerf
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.fused_mlp import FusedNerfWeights, fused_nerf_apply
from cvnerf_torch.parallel.mesh import Mesh, replicate_to_mesh


@dataclasses.dataclass
class OccupancyGrid:
    """A baked density probe table on the render device.

    ``values``: ``[rx, ry, rz]`` float32, the ReLU'd (optionally dilated)
    sigma at the vertices of ``linspace(bbox_min, bbox_max, res)`` per
    axis; ``bbox_min`` ``[3]``; ``inv_spacing`` ``[3]`` =
    ``(res - 1) / (bbox_max - bbox_min)``."""
    values: torch.Tensor
    bbox_min: torch.Tensor
    inv_spacing: torch.Tensor


def grid_spec(bbox_min, bbox_max, resolution) -> tuple:
    """``(res (rx, ry, rz), lo [3] float32, hi [3] float32)``; raises for
    an empty box or fewer than two vertices on an axis."""
    res = tuple(int(r) for r in
                np.broadcast_to(np.asarray(resolution, np.int32), (3,)))
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    if not (hi > lo).all() or min(res) < 2:
        raise ValueError(f"bad grid spec: bbox {lo}..{hi}, res {res}")
    return res, lo, hi


def lattice_points(res: tuple, lo: np.ndarray, hi: np.ndarray, start: int,
                   count: int, device) -> torch.Tensor:
    """Vertices ``start .. start + count - 1`` of the ``res`` lattice in
    flat ``ij`` order, ``[count, 3]`` float32 on ``device``: ``lo + i ·
    step`` with ``step = (hi - lo) / (res - 1)``, each term rounded to
    float32 as the JAX bake forms it, and the last vertex of an axis
    pinned to ``hi`` (``np.linspace`` semantics)."""
    rx, ry, rz = res
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.as_tensor(hi, dtype=torch.float32, device=device)
    last = torch.tensor([rx - 1, ry - 1, rz - 1], dtype=torch.int64,
                        device=device)
    step = (hi_t - lo_t) / last.float()
    flat = torch.arange(start, start + count, dtype=torch.int64,
                        device=device)
    ijk = torch.stack([flat // (ry * rz), (flat // rz) % ry, flat % rz], -1)
    return torch.where(ijk == last, hi_t, lo_t + ijk.float() * step)


def _sigma_fn(net_params: dict, mlp: NerfMLPConfig,
              compute_dtype: torch.dtype, kernels: str):
    """``points [n, 3] → raw sigma [n]`` of one net: through the forward
    kernel with zero view directions (weights packed once, here), or the
    plain MLP with a zero direction encoding for ``kernels="off"``."""
    if kernels == "off":
        def sigma(pts):
            dir_enc = pts.new_zeros(pts.shape[0], mlp.dir_dim)
            return apply_nerf(net_params, freq_encode(pts, mlp.xyz_freqs),
                              dir_enc, mlp, compute_dtype=compute_dtype)[:, 3]
        return sigma
    if kernels != "on":
        raise ValueError(f"kernels must be 'on' or 'off', got {kernels!r}")
    weights = FusedNerfWeights(net_params, mlp, compute_dtype)

    def sigma(pts):
        return fused_nerf_apply(weights, pts, torch.zeros_like(pts))[:, 3]
    return sigma


@torch.no_grad()
def query_lattice(net_params: dict, mlp: NerfMLPConfig, res: tuple,
                  lo: np.ndarray, hi: np.ndarray, chunk: int,
                  compute_dtype: torch.dtype, kernels: str) -> torch.Tensor:
    """Raw sigma of one net on the whole lattice, ``[rx, ry, rz]`` float32
    on the net's device: ``ceil(rx·ry·rz / chunk)`` queries of at most
    ``chunk`` points each."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    device = net_params["l1"]["w"].device
    sigma = _sigma_fn(net_params, mlp, compute_dtype, kernels)
    n = res[0] * res[1] * res[2]
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        out[s:s + m] = sigma(lattice_points(res, lo, hi, s, m, device))
    return out.reshape(res)


def bake_occupancy(net_params: dict, mlp: NerfMLPConfig, bbox_min, bbox_max,
                   resolution: int = 128, dilate: int = 1,
                   chunk: int = 65536,
                   compute_dtype: torch.dtype = torch.float32,
                   kernels: str = "on") -> OccupancyGrid:
    """Sample ``relu(sigma)`` of one net on a lattice and dilate it by a
    max-pool of size ``2·dilate + 1`` (a surface between lattice vertices
    must not vanish from the resample). Runs on the net's device."""
    res, lo, hi = grid_spec(bbox_min, bbox_max, resolution)
    occ = torch.relu(query_lattice(net_params, mlp, res, lo, hi, chunk,
                                   compute_dtype, kernels))
    if dilate > 0:
        # Max-pool with -inf padding: the JAX reduce_window SAME max-pool.
        w = 2 * int(dilate) + 1
        occ = F.max_pool3d(occ[None, None], w, stride=1,
                           padding=int(dilate))[0, 0]
    device = occ.device
    inv_spacing = (np.asarray(res, np.float32) - 1) / (hi - lo)
    return OccupancyGrid(
        values=occ.float().contiguous(),
        bbox_min=torch.as_tensor(lo, device=device),
        inv_spacing=torch.as_tensor(inv_spacing, device=device))


def scene_bbox(ndc: bool, bound: float) -> tuple[tuple, tuple]:
    """The region the model was trained in: the NDC box (x, y ∈ [-1, 1],
    z ∈ [0, 1]) for NDC scenes, a ``±bound`` cube otherwise."""
    if ndc:
        return (-1.0, -1.0, 0.0), (1.0, 1.0, 1.0)
    return (-bound,) * 3, (bound,) * 3


def bake_scene_occupancy(params: dict, mlp: NerfMLPConfig, *, ndc: bool,
                         bound: float, n_fine: int, resolution: int = 192,
                         dilate: int = 1,
                         compute_dtype: torch.dtype = torch.float32,
                         kernels: str = "on", mesh: Mesh | None = None):
    """Box choice, net choice (``fine`` unless ``n_fine == 0``) and bake:
    the one entry point of ``NerfRenderer.enable_occupancy`` and the
    CLI's ``--occ_train`` and ``--render_only --occupancy``. With
    ``mesh`` the grid comes back replicated over it
    (``replicate_to_mesh``)."""
    bb_min, bb_max = scene_bbox(ndc, bound)
    net = "fine" if n_fine > 0 else "coarse"
    grid = bake_occupancy(params[net], mlp, bb_min, bb_max,
                          resolution=resolution, dilate=dilate,
                          compute_dtype=compute_dtype, kernels=kernels)
    return grid if mesh is None else replicate_to_mesh(grid, mesh)


def occupied_fraction(grid: OccupancyGrid) -> float:
    """Fraction of lattice vertices with positive baked density; 0 means
    the bake found no surface (``--occ_train`` then refuses the grid)."""
    return float((grid.values > 0).float().mean())


def probe_sigma(grid: OccupancyGrid, points: torch.Tensor,
                interp: str = "nearest") -> torch.Tensor:
    """Probe the grid at ``points [..., 3]`` → ``[...]``: ``"nearest"``
    (the production default) or ``"trilinear"``."""
    if interp == "trilinear":
        return occupancy_sigma_trilinear(grid, points)
    if interp == "nearest":
        return occupancy_sigma(grid, points)
    raise ValueError(f"bad occupancy interp: {interp!r}")


def _upper(grid: OccupancyGrid, minus: int) -> torch.Tensor:
    """``res - minus`` per axis, float32 on the grid's device, filled there
    (no host copy, so a probe can be captured in a CUDA graph)."""
    up = grid.values.new_empty(3)
    for axis, r in enumerate(grid.values.shape):
        up[axis].fill_(r - minus)
    return up


def occupancy_sigma(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """Nearest-vertex sigma at ``points [..., 3]``: the index rounds half to
    even (``jnp.round``), and points outside the box clamp to its
    boundary vertices."""
    _, ry, rz = grid.values.shape
    idx = torch.round((points - grid.bbox_min) * grid.inv_spacing)
    idx = torch.minimum(torch.clamp(idx, min=0.0),
                        _upper(grid, 1)).to(torch.int64)
    flat = (idx[..., 0] * ry + idx[..., 1]) * rz + idx[..., 2]
    return grid.values.reshape(-1)[flat]


def occupancy_sigma_trilinear(grid: OccupancyGrid,
                              points: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolated sigma at ``points [..., 3]``, with the
    nearest probe's clamp to the box, and equal to it at the vertices:
    the z lerp, then y, then x, each ``a·(1 - f) + b·f``."""
    _, ry, rz = grid.values.shape
    c = (points.float() - grid.bbox_min) * grid.inv_spacing
    c = torch.minimum(torch.clamp(c, min=0.0), _upper(grid, 1))
    i0 = torch.minimum(torch.clamp(torch.floor(c), min=0.0), _upper(grid, 2))
    f = c - i0
    i0 = i0.to(torch.int64)
    x0, y0, z0 = i0.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    v = grid.values.reshape(-1)

    def zlerp(x, y):
        base = (x * ry + y) * rz + z0
        return v[base] * (1.0 - fz) + v[base + 1] * fz

    vx0 = zlerp(x0, y0) * (1.0 - fy) + zlerp(x0, y0 + 1) * fy
    vx1 = zlerp(x0 + 1, y0) * (1.0 - fy) + zlerp(x0 + 1, y0 + 1) * fy
    return vx0 * (1.0 - fx) + vx1 * fx


def occupancy_ray_bounds(grid: OccupancyGrid, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, near, far, eps: float = 1e-3,
                         n_probe: int = 128
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tighten each ray's ``[near, far]`` from the grid: march ``n_probe``
    uniform probes (nearest), composite them with the compositor's math,
    then move near to one probe step before the first occupied probe and
    far to one step after the transmittance first drops below ``eps``.
    Rays that never meet density (or never saturate) keep their bound."""
    n = rays_o.shape[0]
    dev = rays_o.device
    near = torch.as_tensor(near, dtype=torch.float32,
                           device=dev).broadcast_to((n,))
    far = torch.as_tensor(far, dtype=torch.float32,
                          device=dev).broadcast_to((n,))
    step = (far - near) / (n_probe - 1)
    t = near[:, None] + step[:, None] * torch.arange(
        n_probe, dtype=torch.float32, device=dev)[None, :]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    sigma = probe_sigma(grid, pts, "nearest")

    delta = step[:, None] * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.clamp(sigma, min=0.0) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)

    def first(mask):
        """``(any, index of the first True)`` along the probes."""
        lead = (torch.cumsum(mask.to(torch.int32), dim=-1) == 0)
        return mask.any(-1), lead.sum(-1).float()

    any_occ, first_occ = first(sigma > 0.0)
    any_term, first_term = first(trans < eps)
    t_first = near + first_occ * step
    t_term = near + first_term * step
    new_near = torch.where(any_occ, torch.maximum(t_first - step, near), near)
    new_far = torch.where(any_term, torch.minimum(t_term + step, far), far)
    # A minimal positive interval keeps stratified sampling well formed.
    new_far = torch.maximum(new_far, new_near + 1e-4 * (far - near))
    return new_near, new_far
