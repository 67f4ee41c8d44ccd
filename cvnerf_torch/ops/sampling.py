"""Stratified and inverse-CDF hierarchical sampling (port of
the JAX package's ``ops/sampling.py``).

``stratified_samples`` and ``sample_pdf`` take pre-drawn uniforms ``u``
(the renderer draws them with ``ops/rng.py``) or run their deterministic
paths. The TPU's masked-reduction bracketing becomes
``torch.searchsorted(right=True)`` + ``gather`` and its bitonic merge a
``torch.sort`` of the concatenation — both give the same values.
"""

from __future__ import annotations

import torch


def stratified_samples(near, far, n_samples: int, n_rays: int,
                       perturb: bool,
                       u: torch.Tensor | None = None,
                       device: str | torch.device | None = None
                       ) -> torch.Tensor:
    """Depths ``[n_rays, n_samples]`` of ``near·(1-s) + far·s`` for
    ``s = linspace(0, 1, n)``; with ``perturb``, each sample moves by
    ``u`` inside the bin bounded by its neighbours' midpoints."""
    if perturb and u is None:
        raise ValueError("perturbed stratified samples need pre-drawn "
                         "uniforms u")
    if device is None:
        device = near.device if torch.is_tensor(near) else "cpu"
    s = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=device)
    near = torch.as_tensor(near, dtype=torch.float32,
                           device=device).reshape(-1, 1).expand(n_rays, 1)
    far = torch.as_tensor(far, dtype=torch.float32,
                          device=device).reshape(-1, 1).expand(n_rays, 1)
    t = near * (1.0 - s) + far * s
    if perturb:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = torch.cat([mids, t[..., -1:]], dim=-1)
        lower = torch.cat([t[..., :1], mids], dim=-1)
        t = lower + (upper - lower) * u
    return t


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two per-ray ascending arrays ``[n, la]`` and ``[n, lb]`` into
    one ascending ``[n, la + lb]``."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               deterministic: bool = False,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-transform sampling from a piecewise-constant weight PDF.

    ``bins`` ``[n_rays, n_weights + 1]`` (ascending) is one wider than
    ``weights``, aligning with the zero-prepended CDF. Brackets are
    right-bisect: the last cdf ``<= u`` and the first cdf ``> u``; a ``u``
    at or past every cdf is clamped to the last bin. ε = 1e-5 smoothing and
    the degenerate-bin guard follow the JAX package.
    """
    eps = 1e-5
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    if bins.shape[-1] != cdf.shape[-1]:
        raise ValueError(
            f"bins must be one wider than weights: got bins[..., "
            f"{bins.shape[-1]}] vs weights[..., {weights.shape[-1]}]")
    if deterministic:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    elif u is None:
        raise ValueError("stochastic resampling needs pre-drawn uniforms u")
    u = u.contiguous()

    nb = cdf.shape[-1]
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)  # first cdf > u
    lo = (idx - 1).clamp(0, nb - 1)
    hi = idx.clamp(max=nb - 1)
    cdf_lo = torch.gather(cdf, -1, lo)
    cdf_hi = torch.gather(cdf, -1, hi)
    bin_lo = torch.gather(bins, -1, lo)
    bin_hi = torch.gather(bins, -1, hi)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    frac = (u - cdf_lo) / denom
    return bin_lo + frac * (bin_hi - bin_lo)
