"""A plain PyTorch NeRF (Mildenhall et al. 2020, arXiv:2003.08934): the
frequency encoding, the two 8 x 256 MLPs with the skip into layer 6 and the
128-wide view-dependent head, pinhole and NDC rays, stratified and
inverse-CDF hierarchical sampling, alpha compositing, the photometric loss
and Adam with the exponential learning-rate decay of ``bmild/nerf``.

It is the benchmark's yardstick: it imports nothing of the program under
test and computes in float32 with TF32 off (``common.fp32``). Every matrix
product of the nets goes through a product function ``q``, so the same code
computes the control in a lower precision (``common.fp8``).

Parameters are ``{"coarse": net, "fine": net}``, a net ``{"l1": {"w": [in,
out], "b": [out]}, ..., "alpha", "l10", "l11"}`` (``LAYERS``).
"""

from __future__ import annotations

import numpy as np
import torch

from nerfbench.reference import rng
from nerfbench.reference.common import fp32, pixel_rays

INF_DIST = 1e10


def layers(cfg: dict) -> list[tuple[str, int, int]]:
    """``(name, fan_in, fan_out)`` of one net, in evaluation order."""
    w, h = cfg["netwidth"], cfg["netwidth"] // 2
    xd, dd = enc_dim(cfg["multires"]), enc_dim(cfg["multires_views"])
    return [("l1", xd, w), ("l2", w, w), ("l3", w, w), ("l4", w, w),
            ("l5", w, w), ("l6", w + xd, w), ("l7", w, w), ("l8", w, w),
            ("l9", w, w), ("alpha", w, 1), ("l10", w + dd, h),
            ("l11", h, 3)]


def enc_dim(n_freqs: int) -> int:
    return 3 + 6 * n_freqs


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x | sin(2^0 x) cos(2^0 x) | ... | sin(2^(L-1) x) cos(2^(L-1) x)]``."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    return torch.cat([x, sc.reshape(*x.shape[:-1], -1)], dim=-1)


def mlp(net: dict, xe: torch.Tensor, de: torch.Tensor, q) -> torch.Tensor:
    """Raw ``(r, g, b, sigma)`` of one net at encoded points ``xe`` with
    encoded view directions ``de``: five ReLU layers, the skip
    ``[xe | h]`` into l6, two more, the density head off h8, the linear
    feature layer l9, ``[feature | de]`` into the ReLU l10, linear rgb."""
    def lin(name, x):
        return q(x, net[name]["w"]) + net[name]["b"]
    h = xe
    for name in ("l1", "l2", "l3", "l4", "l5"):
        h = torch.relu(lin(name, h))
    h = torch.relu(lin("l6", torch.cat([xe, h], -1)))
    h = torch.relu(lin("l7", h))
    h = torch.relu(lin("l8", h))
    sigma = lin("alpha", h)
    feat = lin("l9", h)
    h = torch.relu(lin("l10", torch.cat([feat, de], -1)))
    return torch.cat([lin("l11", h), sigma], -1)


def query(net, pts, viewdirs, cfg, q) -> torch.Tensor:
    """``mlp`` at ``pts [R, S, 3]`` with per-ray ``viewdirs [R, 3]``."""
    xe = encode(pts, cfg["multires"])
    de = encode(viewdirs, cfg["multires_views"])
    de = de[:, None, :].expand(*pts.shape[:2], de.shape[-1])
    return mlp(net, xe, de, q)


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


def render_rays(params, rays_o, rays_d, viewdirs, near, far, cfg, q,
                draws=None):
    """Coarse then fine render of a ray batch: ``(rgb fine, rgb
    coarse)``. ``draws`` holds the stratified jitter ``u_strat``, the
    resample uniforms ``u_pdf`` and the scaled density noise ``noise_c``,
    ``noise_f`` (each None where the render draws none); without it the
    render is the deterministic one of serving."""
    draws = draws or {}
    n_rays, dev = rays_o.shape[0], rays_o.device
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    white = cfg["white_bkgd"]
    t = stratified(near, far, n_rays, nc, draws.get("u_strat"), dev)
    pts = rays_o[:, None] + rays_d[:, None] * t[..., None]
    raw = query(params["coarse"], pts, viewdirs, cfg, q)
    rgb_c, w = composite(raw, t, rays_d, white, draws.get("noise_c"))
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    t_new = sample_pdf(mids, w[..., 1:-1].detach(), nf,
                       draws.get("u_pdf")).detach()
    t_fine = torch.sort(torch.cat([t, t_new], -1), -1).values
    pts = rays_o[:, None] + rays_d[:, None] * t_fine[..., None]
    raw = query(params["fine"], pts, viewdirs, cfg, q)
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
def render_frame(params, cfg, c2w, q=fp32, chunk=16384) -> torch.Tensor:
    """The deterministic ``[H, W, 3]`` frame of pose ``c2w`` (no jitter,
    no noise, evenly spaced resample uniforms), in chunks of rays."""
    o, d, vd = frame_rays(cfg, c2w, c2w.device)
    near, far = cfg["near"], cfg["far"]
    out = [render_rays(params, o[i:i + chunk], d[i:i + chunk],
                       vd[i:i + chunk], near, far, cfg, q)[0]
           for i in range(0, o.shape[0], chunk)]
    return torch.cat(out).reshape(cfg["H"], cfg["W"], 3)


def step_draws(cfg, seed: int, step: int, n_train: int, precrop: bool):
    """What step ``step`` of a run keyed by ``seed`` draws: the image (an
    index into the train split), the pixels ``(py, px)`` and the render's
    per-ray draws, keyed ``fold_in(PRNGKey(seed), step)`` split into image,
    pixel and render keys."""
    key = rng.fold_in(rng.prng_key(seed), step)
    k_img, k_pix, k_render = rng.split(key, 3)
    h, w, n = cfg["H"], cfg["W"], cfg["N_rand"]
    j = int(rng.randint(k_img, 1, 0, n_train)[0])
    if precrop:
        dh = int(h // 2 * cfg["precrop_frac"])
        dw = int(w // 2 * cfg["precrop_frac"])
        y0, x0, gh, gw = h // 2 - dh, w // 2 - dw, 2 * dh, 2 * dw
    else:
        y0 = x0 = 0
        gh, gw = h, w
    flat = rng.without_replacement(k_pix, n, gh * gw)
    ids = np.arange(n)
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    draws = {"u_strat": torch.from_numpy(rng.uniforms(k_render, 1, ids, nc)),
             "u_pdf": rng.sorted_uniforms(k_render, 2, ids, nf)}
    std = cfg["raw_noise_std"]
    if std > 0:
        draws["noise_c"] = rng.normals(k_render, 3, ids, nc) * std
        draws["noise_f"] = rng.normals(k_render, 4, ids, nc + nf) * std
    return j, y0 + flat // gw, x0 + flat % gw, draws


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


def adam_scalars(cfg, count: int) -> tuple[torch.Tensor, ...]:
    """``(lr(count), 1 - 0.9^(count + 1), 1 - 0.999^(count + 1))`` in
    float32: the rate decays by 10x every ``1000 lrate_decay`` updates."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    lr = f32(cfg["lrate"])
    if count > 0:
        lr = lr * torch.pow(f32(0.1), f32(count) / (1000 * cfg["lrate_decay"]))
    return (lr, 1 - f32(0.9) ** (count + 1), 1 - f32(0.999) ** (count + 1))


def train_step(state: dict, cfg: dict, data: dict, seed: int, step: int,
               q=fp32, precrop: bool = False,
               rows: int | None = None) -> tuple[dict, dict]:
    """One train step from ``state`` (``params``, ``mu``, ``nu``,
    ``count``): the draws of ``step_draws``, the rays, the render, the loss
    MSE(fine) + MSE(coarse) against the pixels' colours, its gradients and
    one Adam update (``adam_update``). ``data`` holds the
    ``images [N, H, W, 3]``, ``poses [N, 3+, 4]`` and ``train_idx`` on the
    device. ``rows`` (a control's planted fault) averages the loss over the
    first ``rows`` rays only. Returns the new state and ``{"loss",
    "grads"}``."""
    images, poses, train_idx = data["images"], data["poses"], data["train_idx"]
    dev = images.device
    j, py, px, draws = step_draws(cfg, seed, step, len(train_idx), precrop)
    im = int(train_idx[j])
    py, px = torch.from_numpy(py).to(dev), torch.from_numpy(px).to(dev)
    draws = {k: v.to(dev) for k, v in draws.items()}
    target = images[im][py, px]
    h, w, f = cfg["H"], cfg["W"], float(np.float32(cfg["focal"]))
    rays_o, rays_d = pixel_rays(px, py, w, h, f, poses[im].float())
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if cfg["ndc"]:
        rays_o, rays_d = ndc(h, w, f, 1.0, rays_o, rays_d)
    n = rays_o.shape[0]
    near = torch.full((n,), cfg["near"], dtype=torch.float32, device=dev)
    far = torch.full((n,), cfg["far"], dtype=torch.float32, device=dev)
    params = rebuild(state["params"], [p.detach().requires_grad_()
                                       for p in leaves(state["params"])])
    rgb_f, rgb_c = render_rays(params, rays_o, rays_d, vd, near, far, cfg,
                               q, draws)
    if rows is not None:
        rgb_f, rgb_c, target = rgb_f[:rows], rgb_c[:rows], target[:rows]
    loss = torch.mean((rgb_f - target) ** 2) + torch.mean((rgb_c - target)
                                                          ** 2)
    grads = torch.autograd.grad(loss, leaves(params))
    return (adam_update(state, grads, cfg),
            {"loss": loss.detach(), "grads": rebuild(state["params"],
                                                     grads)})


def adam_update(state: dict, grads, cfg: dict) -> dict:
    """One Adam update (b1 0.9, b2 0.999, eps 1e-8) of ``state`` by the
    gradients ``grads`` (a list in ``leaves`` order)."""
    dev = grads[0].device
    lr, bc1, bc2 = (x.to(dev) for x in adam_scalars(cfg, state["count"]))
    mu = [0.1 * g + 0.9 * m for g, m in zip(grads, leaves(state["mu"]))]
    nu = [0.001 * (g * g) + 0.999 * v
          for g, v in zip(grads, leaves(state["nu"]))]
    new = [p.detach() - lr * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8))
           for p, m, v in zip(leaves(state["params"]), mu, nu)]
    tree = state["params"]
    return {"params": rebuild(tree, new), "mu": rebuild(tree, mu),
            "nu": rebuild(tree, nu), "count": state["count"] + 1}


def fresh_state(params: dict) -> dict:
    """Adam's state before its first update."""
    zeros = [torch.zeros_like(p) for p in leaves(params)]
    return {"params": params, "mu": rebuild(params, zeros),
            "nu": rebuild(params, [z.clone() for z in zeros]), "count": 0}
