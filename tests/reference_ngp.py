"""A plain PyTorch Instant-NGP field for the port's tests (Müller et al.
2022, arXiv:2201.05989; widths from its Table 1 and §5.4):
the multiresolution hash encoding (int64 arithmetic masked to 32 bits for
the hash), degree-4 spherical harmonics, the density and colour MLPs,
NeRF's stratified and inverse-CDF sampling with one field queried by both
passes, the loss MSE(fine) + MSE(coarse), gradients by autograd and Adam
with the paper's rule (β₂ and ε of the configuration, L2 on the MLP
weights, no update of a table entry whose gradient is exactly 0).

It imports nothing of ``cvnerf_torch`` or ``cvnerf_tpu`` and no JAX, and
computes in float32 with TF32 off (``no_tf32``). ``nerfbench/reference/
ngp.py`` is its copy for the benchmark (the same functions, with the
benchmark's draws); a test holds the two bitwise.

Departures from the paper: NeRF's stratified + importance samples in place
of occupancy-grid marching; MSE in place of the Huber loss; no density
noise, no EMA of the weights, the learning rate held at ``lrate``; Adam's
bias correction by the global update count; MLPs without biases, as
tiny-cuda-nn's ``FullyFusedMLP``.

Configuration keys: those of ``nerfbench/configs/ngp-llff-fern.json``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

INF_DIST = 1e10


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off) inside the block."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32."""
    return x @ w


def pixel_rays(px, py, width, height, focal, c2w):
    """World ray origins and (unnormalized) directions of pixels ``(px,
    py)`` of a pinhole camera looking down its -z axis."""
    d = torch.stack([(px.float() - width * 0.5) / focal,
                     -(py.float() - height * 0.5) / focal,
                     -torch.ones_like(px, dtype=torch.float32)], -1)
    rays_d = d @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def ndc(height, width, focal, near, rays_o, rays_d):
    """Rays of a forward-facing capture in normalized device coordinates
    (the paper's appendix C): origins moved to the near plane ``z =
    -near``, then projected."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    o = rays_o + t[..., None] * rays_d
    ox, oy = -2.0 * focal / width, -2.0 * focal / height
    o0 = ox * o[..., 0] / o[..., 2]
    o1 = oy * o[..., 1] / o[..., 2]
    o2 = 1.0 + 2.0 * near / o[..., 2]
    d0 = ox * (rays_d[..., 0] / rays_d[..., 2] - o[..., 0] / o[..., 2])
    d1 = oy * (rays_d[..., 1] / rays_d[..., 2] - o[..., 1] / o[..., 2])
    d2 = -2.0 * near / o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def stratified(near, far, n_rays, n, u, device):
    """``n`` depths a ray from ``near`` to ``far``; with uniforms ``u``
    each moves inside the bin between its neighbours' midpoints."""
    s = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    near = torch.as_tensor(near, dtype=torch.float32,
                           device=device).reshape(-1, 1).expand(n_rays, 1)
    far = torch.as_tensor(far, dtype=torch.float32,
                          device=device).reshape(-1, 1).expand(n_rays, 1)
    t = near * (1.0 - s) + far * s
    if u is not None:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], -1)
        lower = torch.cat([t[..., :1], mids], -1)
        t = lower + (upper - lower) * u
    return t


def sample_pdf(bins, weights, n, u):
    """``n`` depths a ray by inverse-transform sampling of the piecewise
    constant density ``weights + 1e-5`` over ``bins`` (one wider than the
    weights); ``u`` the uniforms, or None for ``linspace(0, 1, n)``."""
    eps = 1e-5
    w = weights + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n)
    u = u.contiguous()
    nb = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo, hi = (idx - 1).clamp(0, nb - 1), idx.clamp(max=nb - 1)
    c0, c1 = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    b0, b1 = torch.gather(bins, -1, lo), torch.gather(bins, -1, hi)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def composite(raw, t, rays_d, white, noise):
    """Pixel colour, weights and opacity of raw samples along rays: the
    density (plus ``noise``) through a ReLU into opacities over the
    intervals (the last one 1e10), scaled by the direction's length."""
    delta = torch.cat([t[..., 1:] - t[..., :-1],
                       torch.full_like(t[..., :1], INF_DIST)], -1)
    delta = delta * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans
    rgb = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), -2)
    acc = weights.sum(-1)
    if white:
        rgb = rgb + (1.0 - acc[..., None])
    return rgb, weights


def leaves(tree: dict) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def rebuild(tree: dict, flat) -> dict:
    it = iter(flat)

    def go(t):
        return ({k: go(v) for k, v in t.items()} if isinstance(t, dict)
                else next(it))
    return go(tree)


def fresh_state(params: dict) -> dict:
    """Adam's state before its first update."""
    zeros = [torch.zeros_like(p) for p in leaves(params)]
    return {"params": params, "mu": rebuild(params, zeros),
            "nu": rebuild(params, [z.clone() for z in zeros]), "count": 0}


PRIMES = (1, 2654435761, 805459861)
M32 = 0xFFFFFFFF
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792,
        0.94617469575755997, 0.31539156525251999, 0.54627421529603959,
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)


def levels(cfg: dict) -> list[dict]:
    """Each level's float32 scale ``N_min · b^l - 1`` (formed in float64,
    rounded once), resolution ``ceil(scale) + 1``, entries ``min(T, res³
    rounded up to 8)`` and whether it is indexed densely (``res³ <= T``)."""
    n, lo, hi = (cfg["n_levels"], cfg["base_resolution"],
                 cfg["max_resolution"])
    growth = math.log2(hi / lo) / (n - 1) if n > 1 else 0.0
    t = 2 ** cfg["log2_hashmap_size"]
    out = []
    for level in range(n):
        scale = float(np.float32(2.0 ** (level * growth) * lo - 1.0))
        res = math.ceil(scale) + 1
        entries = min(t, -(-res ** 3 // 8) * 8)
        out.append({"scale": scale, "res": res, "entries": entries,
                    "dense": res ** 3 <= entries})
    return out


def mlp_layers(cfg: dict) -> list[tuple[str, str, int, int]]:
    """``(net, layer, fan_in, fan_out)`` of the density and colour MLPs."""
    h, geo = cfg["n_neurons"], cfg["geo_feat_dim"]
    enc = cfg["n_levels"] * cfg["n_features_per_level"]
    out = [("density", f"l{k}", a, b) for k, (a, b) in enumerate(
        zip([enc] + [h] * cfg["n_hidden_layers"],
            [h] * cfg["n_hidden_layers"] + [geo]))]
    widths = [geo + cfg["sh_degree"] ** 2] + [h] * cfg["rgb_n_hidden_layers"]
    return out + [("color", f"l{k}", a, b) for k, (a, b) in enumerate(
        zip(widths, widths[1:] + [3]))]


def hash_index(lv: dict, q: list[torch.Tensor]) -> torch.Tensor:
    """The table index of integer corners ``q`` (three int64 tensors):
    ``x0 + x1 res + x2 res²`` on a dense level, else the uint32 hash ``x0·1
    ⊕ x1·2654435761 ⊕ x2·805459861`` (int64 products masked to 32 bits),
    modulo the level's entries."""
    if lv["dense"]:
        idx = q[0] + q[1] * lv["res"] + q[2] * lv["res"] ** 2
    else:
        idx = ((q[0] * PRIMES[0]) & M32) ^ ((q[1] * PRIMES[1]) & M32) \
            ^ ((q[2] * PRIMES[2]) & M32)
    return idx % lv["entries"]


def encode(unit: torch.Tensor, tables: list, lvs: list) -> torch.Tensor:
    """``[n, 2L]`` features of unit-cube positions ``[n, 3]`` (clamped to
    [0, 1]): per level, ``pos = x · scale + 0.5``, the cell ``floor(pos)``
    and fraction ``pos - floor(pos)``, and the 8 corners blended
    trilinearly (corner ``c`` upper in dimension ``d`` where bit ``d`` of
    ``c`` is set; weights multiplied in dimension order; corners summed in
    order)."""
    x = unit.clamp(0.0, 1.0)
    out = []
    for lv, table in zip(lvs, tables):
        pos = x * lv["scale"] + 0.5
        cell = torch.floor(pos)
        frac = pos - cell
        cell = cell.to(torch.int64)
        acc = 0.0
        for c in range(8):
            w = torch.ones_like(frac[:, 0])
            q = []
            for d in range(3):
                up = (c >> d) & 1
                w = w * (frac[:, d] if up else 1.0 - frac[:, d])
                q.append(cell[:, d] + up)
            acc = acc + w[:, None] * table[hash_index(lv, q)]
        out.append(acc)
    return torch.cat(out, -1)


def sh(d: torch.Tensor) -> torch.Tensor:
    """The 16 real spherical harmonics of degree < 4 of unit directions
    ``[..., 3]``, tiny-cuda-nn's order and constants."""
    x, y, z = d.unbind(-1)
    c = SH_C
    xy, yz, xz, x2, y2, z2 = x * y, y * z, x * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, c[0]), -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * xy, -c[2] * yz, c[3] * z2 - c[4], -c[2] * xz,
        c[5] * x2 - c[5] * y2, c[6] * y * (-3.0 * x2 + y2), c[7] * xy * z,
        c[8] * y * (1.0 - 5.0 * z2), c[9] * z * (5.0 * z2 - 3.0),
        c[8] * x * (1.0 - 5.0 * z2), c[10] * z * (x2 - y2),
        c[6] * x * (-x2 + 3.0 * y2)], -1)


def field(p: dict, pts: torch.Tensor, viewdirs: torch.Tensor, cfg: dict,
          q=fp32) -> torch.Tensor:
    """Raw ``(r, g, b, σ)`` ``[R, S, 4]`` at points ``[R, S, 3]`` of the
    ``[-bound, bound]³`` box with per-ray unit ``viewdirs [R, 3]``: the
    encoding, the density MLP (ReLU between layers, none after), ``σ =
    exp(output 0)``, the colour MLP on the 16 density outputs and the SH of
    the direction."""
    f = p["field"]
    b = cfg["bound"]
    lvs = levels(cfg)
    unit = ((pts.reshape(-1, 3) + b) / (2.0 * b))
    h = encode(unit, [f["table"][str(k)] for k in range(len(lvs))], lvs)
    dens = f["density"]
    for k in range(len(dens)):
        h = q(h, dens[f"l{k}"])
        if k < len(dens) - 1:
            h = torch.relu(h)
    geo = h
    s = sh(viewdirs)[:, None, :].expand(*pts.shape[:2], 16).reshape(-1, 16)
    h = torch.cat([geo, s], -1)
    col = f["color"]
    for k in range(len(col)):
        h = q(h, col[f"l{k}"])
        if k < len(col) - 1:
            h = torch.relu(h)
    sigma = torch.exp(geo[:, :1])
    return torch.cat([h, sigma], -1).reshape(*pts.shape[:2], 4)


def render_rays(params, rays_o, rays_d, viewdirs, near, far, cfg, q,
                draws=None):
    """Coarse then fine render of a ray batch through the one field:
    ``(rgb fine, rgb coarse)`` (``draws``: ``reference/nerf.py``'s)."""
    draws = draws or {}
    n_rays, dev = rays_o.shape[0], rays_o.device
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    white = cfg["white_bkgd"]
    t = stratified(near, far, n_rays, nc, draws.get("u_strat"), dev)
    pts = rays_o[:, None] + rays_d[:, None] * t[..., None]
    raw = field(params, pts, viewdirs, cfg, q)
    rgb_c, w = composite(raw, t, rays_d, white, draws.get("noise_c"))
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    t_new = sample_pdf(mids, w[..., 1:-1].detach(), nf,
                       draws.get("u_pdf")).detach()
    t_fine = torch.sort(torch.cat([t, t_new], -1), -1).values
    pts = rays_o[:, None] + rays_d[:, None] * t_fine[..., None]
    raw = field(params, pts, viewdirs, cfg, q)
    rgb_f, _ = composite(raw, t_fine, rays_d, white, draws.get("noise_f"))
    return rgb_f, rgb_c


def frame_rays(cfg, c2w, device):
    """All rays of a frame, row-major: origins, directions (in NDC for a
    forward-facing scene) and the unit view directions."""
    h, w, f = cfg["H"], cfg["W"], np.float32(cfg["focal"])
    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    o, d = pixel_rays(px.reshape(-1), py.reshape(-1), w, h, float(f), c2w)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    if cfg["ndc"]:
        o, d = ndc(h, w, float(f), 1.0, o, d)
    return o, d, vd


@torch.no_grad()
def render_frame(params, cfg, c2w, q=fp32, chunk=8192) -> torch.Tensor:
    """The deterministic ``[H, W, 3]`` frame of pose ``c2w``."""
    o, d, vd = frame_rays(cfg, c2w, c2w.device)
    near, far = cfg["near"], cfg["far"]
    out = [render_rays(params, o[i:i + chunk], d[i:i + chunk],
                       vd[i:i + chunk], near, far, cfg, q)[0]
           for i in range(0, o.shape[0], chunk)]
    return torch.cat(out).reshape(cfg["H"], cfg["W"], 3)


def adam_scalars(cfg: dict, count: int) -> tuple[torch.Tensor, ...]:
    """``(lr, 1 - β₁^(count + 1), 1 - β₂^(count + 1))`` in float32; the
    rate decays by 10x every ``1000 lrate_decay`` updates where
    ``lrate_decay`` is positive."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    lr = f32(cfg["lrate"])
    if count > 0 and cfg["lrate_decay"] > 0:
        lr = lr * torch.pow(f32(0.1), f32(count) / (1000 * cfg["lrate_decay"]))
    return (lr, 1 - f32(cfg["beta1"]) ** (count + 1),
            1 - f32(cfg["beta2"]) ** (count + 1))


def adam_update(state: dict, grads, cfg: dict) -> dict:
    """One Adam update (β₁, β₂, ε of the configuration) of ``state`` by the
    gradients ``grads`` (``leaves`` order): the MLP weights' gradients take
    ``l2_reg`` times the weight; a table entry whose gradient is exactly 0
    keeps its value and moments."""
    dev = grads[0].device
    lr, bc1, bc2 = (x.to(dev) for x in adam_scalars(cfg, state["count"]))
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["epsilon"]
    tree = state["params"]
    table = [k[0] == "table" for k in _paths(tree["field"])]
    ps, ms, vs = (leaves(state[k]) for k in ("params", "mu", "nu"))
    new_p, new_m, new_v = [], [], []
    for g, p, m, v, is_table in zip(grads, ps, ms, vs, table):
        p = p.detach()
        if not is_table:
            g = g + cfg["l2_reg"] * p
        m2 = (1 - b1) * g + b1 * m
        v2 = (1 - b2) * (g * g) + b2 * v
        p2 = p - lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
        if is_table:
            keep = g == 0
            p2, m2, v2 = (torch.where(keep, a, b)
                          for a, b in ((p, p2), (m, m2), (v, v2)))
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return {"params": rebuild(tree, new_p), "mu": rebuild(tree, new_m),
            "nu": rebuild(tree, new_v), "count": state["count"] + 1}


def _paths(tree: dict, prefix=()) -> list[tuple]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _step(state, rays_o, rays_d, vd, near, far, target, cfg, q, draws,
          rows=None):
    params = rebuild(state["params"], [p.detach().requires_grad_()
                                       for p in leaves(state["params"])])
    rgb_f, rgb_c = render_rays(params, rays_o, rays_d, vd, near, far, cfg,
                               q, draws)
    if rows is not None:
        rgb_f, rgb_c, target = rgb_f[:rows], rgb_c[:rows], target[:rows]
    loss = torch.mean((rgb_f - target) ** 2) + torch.mean((rgb_c - target)
                                                          ** 2)
    grads = torch.autograd.grad(loss, leaves(params))
    seen = [g if k[0] == "table" else g + cfg["l2_reg"] * p.detach()
            for g, p, k in zip(grads, leaves(state["params"]),
                               _paths(state["params"]["field"]))]
    return (adam_update(state, grads, cfg),
            {"loss": loss.detach(), "grads": rebuild(state["params"],
                                                     seen)})


