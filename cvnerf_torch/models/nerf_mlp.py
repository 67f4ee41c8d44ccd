"""The NeRF MLP over a plain dict of tensors (port of
the JAX package's ``models/nerf_mlp.py``).

Parameter layout is the JAX package's, leaf for leaf: ``{"l1": {"w": [in,
out], "b": [out]}, ..., "alpha", "l10", "l11"}`` — so a JAX pytree converts
with ``np.asarray`` and no transposes (``utils.convert.params_from_jax``).

Layer graph: 5 ReLU trunk layers → ``[xyz_enc | h]`` skip into l6 → 2 more
ReLU layers → density head off h8 (no activation) and a feature layer l9
with NO ReLU → ``[feat | dir_enc]`` into the 128-wide ReLU l10 → linear rgb.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvnerf_torch.ops.encoding import encoding_dim
from cvnerf_torch.ops.rng import split, uniform


@dataclasses.dataclass(frozen=True)
class NerfMLPConfig:
    """Static architecture hyperparameters."""
    xyz_freqs: int = 10
    dir_freqs: int = 4
    trunk_width: int = 256
    head_width: int = 128

    @property
    def xyz_dim(self) -> int:
        return encoding_dim(3, self.xyz_freqs)   # 63

    @property
    def dir_dim(self) -> int:
        return encoding_dim(3, self.dir_freqs)   # 27


def _layer_dims(cfg: NerfMLPConfig) -> list[tuple[str, int, int]]:
    w, h = cfg.trunk_width, cfg.head_width
    return [
        ("l1", cfg.xyz_dim, w),
        ("l2", w, w),
        ("l3", w, w),
        ("l4", w, w),
        ("l5", w, w),
        ("l6", w + cfg.xyz_dim, w),   # skip: [xyz_enc | h5]
        ("l7", w, w),
        ("l8", w, w),
        ("l9", w, w),                 # feature layer, no ReLU
        ("alpha", w, 1),              # density head off h8
        ("l10", w + cfg.dir_dim, h),  # [feat | dir_enc]
        ("l11", h, 3),                # rgb head, no sigmoid
    ]


def init_nerf_params(key: torch.Tensor,
                     cfg: NerfMLPConfig = NerfMLPConfig(),
                     device: str | torch.device = "cpu") -> dict:
    """One network's params: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
    weight and bias (``nn.Linear``'s default), drawn from the ``PRNGKey``
    ``key`` (``ops/rng.py``) on the CPU and then moved to ``device``. The
    draws are the JAX package's ``init_nerf_params(key)`` bit for bit (a key
    per weight and per bias, ``jax.random.uniform`` with the bound in
    float32), so a key gives the same weights on every device."""
    dims = _layer_dims(cfg)
    keys = split(key, 2 * len(dims))
    params = {}
    for i, (name, fan_in, fan_out) in enumerate(dims):
        bound = float(np.float32(1.0) / np.sqrt(np.float32(fan_in)))
        w = uniform(keys[2 * i], (fan_in, fan_out), "cpu", -bound, bound)
        b = uniform(keys[2 * i + 1], (fan_out,), "cpu", -bound, bound)
        params[name] = {"w": w.to(device), "b": b.to(device)}
    return params


def nerf_param_count(params: dict) -> int:
    """The number of values in a (nested) params dict."""
    if isinstance(params, dict):
        return sum(nerf_param_count(v) for v in params.values())
    return int(params.numel())


def freq_window(n_freqs: int, alpha: float | torch.Tensor) -> torch.Tensor:
    """Per-band linear anneal window: band ``k`` weighs ``clip(alpha - k,
    0, 1)`` (FreeNeRF eq. 3), in float32; a 0-d tensor ``alpha`` gives the
    window on its device."""
    if not torch.is_tensor(alpha):
        alpha = torch.tensor(alpha, dtype=torch.float32)
    k = torch.arange(n_freqs, dtype=torch.float32, device=alpha.device)
    return torch.clamp(alpha - k, 0.0, 1.0)


def encoding_mask(dim: int, n_freqs: int,
                  alpha: float | torch.Tensor) -> torch.Tensor:
    """Feature-space anneal mask in :func:`freq_encode`'s layout: identity
    features pass, band ``k``'s ``2*dim`` features scale by the window."""
    band = freq_window(n_freqs, alpha).repeat_interleave(2 * dim)
    return torch.cat([torch.ones(dim, device=band.device), band])


def anneal_nerf_params(params: dict, cfg: NerfMLPConfig,
                       progress: float | torch.Tensor) -> dict:
    """Coarse-to-fine frequency annealing as a weight-row transform: scale
    the encoding-facing rows of ``l1``, of ``l6``'s skip part and of
    ``l10``'s dir part. Identical to masking the encodings themselves, so
    the kernel and the plain version anneal alike. ``progress`` is rounded
    to float32 first and ``alpha = progress · L`` formed in float32, as
    the JAX transform forms them. A 0-d float32 tensor ``progress`` on the
    params' device (the train step's) forms the masks there, without a
    host copy: the float32 product rounds as the float64 one of its two
    float32 factors does."""
    w1 = params["l1"]["w"]
    if not torch.is_tensor(progress):
        progress = float(np.float32(progress))
    mx = encoding_mask(3, cfg.xyz_freqs,
                       progress * cfg.xyz_freqs).to(w1.device, w1.dtype)
    md = encoding_mask(3, cfg.dir_freqs,
                       progress * cfg.dir_freqs).to(w1.device, w1.dtype)
    out = dict(params)
    out["l1"] = {**params["l1"], "w": w1 * mx[:, None]}
    w6 = params["l6"]["w"]
    nx = mx.shape[0]
    out["l6"] = {**params["l6"],
                 "w": torch.cat([w6[:nx] * mx[:, None], w6[nx:]], dim=0)}
    w10 = params["l10"]["w"]
    n_feat = w10.shape[0] - md.shape[0]
    out["l10"] = {**params["l10"],
                  "w": torch.cat([w10[:n_feat], w10[n_feat:] * md[:, None]],
                                 dim=0)}
    return out


def anneal_model_params(params: dict, cfg: NerfMLPConfig,
                        progress: float | torch.Tensor) -> dict:
    """:func:`anneal_nerf_params` over a ``{"coarse", "fine"}`` dict."""
    return {name: anneal_nerf_params(net, cfg, progress)
            for name, net in params.items()}


def _dense(params: dict, name: str, x: torch.Tensor,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w + b`` with operands rounded to ``compute_dtype`` and the
    product accumulated in fp32 — the JAX ``preferred_element_type=f32``
    contract. A bf16 ``torch.matmul`` would round its result to bf16 before
    the bias, so the operands are rounded and then multiplied in fp32
    (a bf16×bf16 product is exact in fp32)."""
    w = params[name]["w"]
    if compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    elif compute_dtype != torch.float32:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return x.float() @ w.float() + params[name]["b"].float()


def apply_nerf(params: dict, xyz_enc: torch.Tensor, dir_enc: torch.Tensor,
               cfg: NerfMLPConfig = NerfMLPConfig(),
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Evaluate the MLP on pre-encoded inputs ``[..., 63]``/``[..., 27]``.

    Returns ``[..., 4]`` raw ``(r, g, b, sigma)`` in fp32.
    """
    relu = torch.relu
    h = relu(_dense(params, "l1", xyz_enc, compute_dtype))
    h = relu(_dense(params, "l2", h, compute_dtype))
    h = relu(_dense(params, "l3", h, compute_dtype))
    h = relu(_dense(params, "l4", h, compute_dtype))
    h = relu(_dense(params, "l5", h, compute_dtype))
    h = torch.cat([xyz_enc, h], dim=-1)
    h = relu(_dense(params, "l6", h, compute_dtype))
    h = relu(_dense(params, "l7", h, compute_dtype))
    h = relu(_dense(params, "l8", h, compute_dtype))

    sigma = _dense(params, "alpha", h, compute_dtype)
    feat = _dense(params, "l9", h, compute_dtype)

    h = torch.cat([feat, dir_enc], dim=-1)
    h = relu(_dense(params, "l10", h, compute_dtype))
    rgb = _dense(params, "l11", h, compute_dtype)
    return torch.cat([rgb, sigma], dim=-1)
