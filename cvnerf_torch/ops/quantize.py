"""Post-training int8 quantization of the NeRF MLP for serving (port of the
JAX package's ``ops/quantize.py``).

Scheme, as in the JAX package: symmetric, max-abs calibrated.

* **Weights** carry per-output-channel scales. The input activation scales
  are folded into the weight rows before quantization (``W' = W * s_in``),
  so every dot is int8×int8→int32 and dequantization is one per-channel
  multiply-add ``acc * s + b``.
* **Activations** carry per-channel scales everywhere (encodings and hidden
  layers). The next activation's requant multiplier ``127/max`` is folded
  into the producing layer's ``s`` and ``b``, so the whole inter-layer
  epilogue is ``clip(round(acc * s + b), lo, 127)``: ``lo = 0`` is the
  ReLU, ``-127`` the signed feature layer.
* **Heads** (sigma and rgb) stay fp32: raw dequantized accumulators.
* **Calibration** records per-channel maxima from one fp32 forward over
  sample points (:func:`calibrate_nerf_quant`).

Every step keeps the JAX module's order of operations, so the same
calibration maxima give bitwise the same ``qw``, ``s``, ``b`` and
``inv_act``, and :func:`apply_nerf_quant` the same int8 activations: the
scales are divided (``w_folded / s_out``, ``1.0 / s``), the encodings are
quantized by a multiply with the stored inverse (``round(enc * inv)``; a
divide would round differently), and the epilogue is a multiply then an
add, each rounded (no fused multiply-add). The integer products run in
float64, where every product and partial sum of int8 operands is an exact
integer, and are cast to fp32, which is exact below 2^24
(|acc| ≤ 127·127·319): the same values as JAX's int32 dot and cast, on the
CPU and on the card alike.

The int8 kernel (``csrc/fused_mlp_int8.cu``, wrapped by
``ops/fused_mlp_int8.py``) reproduces :func:`apply_nerf_quant` composed
with ``freq_encode``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops import rng
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.rays import ndc_rays

# Hidden activations that carry a per-channel scale, in forward order.
HIDDEN = ("h1", "h2", "h3", "h4", "h5", "h6", "h7", "h8", "feat", "h10")
LAYERS = ("l1", "l2", "l3", "l4", "l5", "l6", "l7", "l8", "l9", "alpha",
          "l10", "l11")
# The activation whose requant multiplier folds into each layer's scale and
# bias; the heads (alpha, l11) stay raw fp32.
_OUT_ACT = {"l1": "h1", "l2": "h2", "l3": "h3", "l4": "h4", "l5": "h5",
            "l6": "h6", "l7": "h7", "l8": "h8", "l9": "feat", "l10": "h10"}


@dataclasses.dataclass(frozen=True)
class QuantizedNerfParams:
    """One network's int8 parameters.

    ``layers[name]``: ``{"qw": int8 [fan_in, fan_out], "s": fp32 [fan_out],
    "b": fp32 [fan_out]}``, ``s`` and ``b`` holding the folded input scale
    and, for every layer but the heads, the output requant multiplier.
    ``inv_act``: the ``127/max`` multipliers of the two encodings,
    ``enc_x`` [xyz_dim] and ``enc_d`` [dir_dim].

    The renderer dispatches on this type (and on its packed form,
    ``ops.fused_mlp_int8.QuantizedNerfWeights``). Quantization is serving
    state: checkpoints hold float params.
    """
    layers: dict
    inv_act: dict

    def to(self, device: str | torch.device) -> "QuantizedNerfParams":
        return QuantizedNerfParams(
            layers={n: {k: t.to(device) for k, t in lay.items()}
                    for n, lay in self.layers.items()},
            inv_act={k: t.to(device) for k, t in self.inv_act.items()})

    @property
    def device(self) -> torch.device:
        return self.layers["l1"]["qw"].device


def _maxabs(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    x = x.abs()
    return x.max() if dim is None else x.amax(dim=dim)


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 products without TF32: the calibration maxima set every scale."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


@torch.no_grad()
def calibrate_nerf_quant(params: dict, cfg: NerfMLPConfig,
                         points: torch.Tensor,
                         viewdirs: torch.Tensor) -> dict:
    """Per-channel maxima of every activation over one fp32 forward at
    ``points``/``viewdirs`` ``[n, 3]``: ``enc_x``, ``enc_d``, ``h1``..``h8``,
    ``feat``, ``h10`` (fp32 vectors) — the input of
    :func:`quantize_nerf_params`."""
    xyz_enc = freq_encode(points.float(), cfg.xyz_freqs)
    dir_enc = freq_encode(viewdirs.float(), cfg.dir_freqs)

    def dense(name, x):
        return x @ params[name]["w"].float() + params[name]["b"].float()

    relu = torch.relu
    out = {"enc_x": _maxabs(xyz_enc, 0), "enc_d": _maxabs(dir_enc, 0)}
    with _full_fp32_matmul():
        h = relu(dense("l1", xyz_enc)); out["h1"] = _maxabs(h, 0)
        h = relu(dense("l2", h)); out["h2"] = _maxabs(h, 0)
        h = relu(dense("l3", h)); out["h3"] = _maxabs(h, 0)
        h = relu(dense("l4", h)); out["h4"] = _maxabs(h, 0)
        h = relu(dense("l5", h)); out["h5"] = _maxabs(h, 0)
        h = relu(dense("l6", torch.cat([xyz_enc, h], dim=-1)))
        out["h6"] = _maxabs(h, 0)
        h = relu(dense("l7", h)); out["h7"] = _maxabs(h, 0)
        h = relu(dense("l8", h)); out["h8"] = _maxabs(h, 0)
        feat = dense("l9", h); out["feat"] = _maxabs(feat, 0)
        h = relu(dense("l10", torch.cat([feat, dir_enc], dim=-1)))
        out["h10"] = _maxabs(h, 0)
    return out


def _act_scale(m: torch.Tensor) -> torch.Tensor:
    """max-abs → symmetric int8 scale ``max/127``, zero-range safe."""
    return torch.clamp(m, min=1e-8).float() / 127.0


def _inverse(s: torch.Tensor) -> torch.Tensor:
    """``1.0 / s`` as one rounded division (``1.0 / tensor`` would go
    through ``reciprocal`` and a multiply)."""
    return torch.ones_like(s) / s


def _quantize_weight(w: torch.Tensor, s_in: torch.Tensor,
                     b: torch.Tensor) -> dict:
    """Fold the input scales into ``w``'s rows, quantize per output
    channel."""
    w_folded = w.float() * s_in[:, None]
    s_out = _act_scale(_maxabs(w_folded, 0))
    qw = torch.clamp(torch.round(w_folded / s_out[None, :]), -127, 127)
    return {"qw": qw.to(torch.int8), "s": s_out, "b": b.float()}


@torch.no_grad()
def quantize_nerf_params(params: dict, cfg: NerfMLPConfig,
                         calib: dict) -> QuantizedNerfParams:
    """Float params + calibration maxima → int8 serving params, on the
    params' device."""
    dev = params["l1"]["w"].device
    calib = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in calib.items()}
    s_ex = _act_scale(calib["enc_x"])
    s_ed = _act_scale(calib["enc_d"])
    s_h = {k: _act_scale(calib[k]) for k in HIDDEN}
    in_scales = {
        "l1": s_ex,
        "l2": s_h["h1"], "l3": s_h["h2"], "l4": s_h["h3"], "l5": s_h["h4"],
        "l6": torch.cat([s_ex, s_h["h5"]]),        # [xyz_enc | hidden]
        "l7": s_h["h6"], "l8": s_h["h7"],
        "l9": s_h["h8"], "alpha": s_h["h8"],
        "l10": torch.cat([s_h["feat"], s_ed]),     # [feat | dir_enc]
        "l11": s_h["h10"],
    }
    layers = {}
    for name in LAYERS:
        lay = _quantize_weight(params[name]["w"], in_scales[name],
                               params[name]["b"])
        act = _OUT_ACT.get(name)
        if act is not None:
            inv = _inverse(s_h[act])
            lay = {"qw": lay["qw"], "s": lay["s"] * inv, "b": lay["b"] * inv}
        layers[name] = lay
    return QuantizedNerfParams(
        layers=layers,
        inv_act={"enc_x": _inverse(s_ex), "enc_d": _inverse(s_ed)})


def _requant(y: torch.Tensor, lo: int) -> torch.Tensor:
    """Pre-folded fp32 pre-activation → int8; ``lo = 0`` is the ReLU."""
    return torch.clamp(torch.round(y), lo, 127).to(torch.int8)


def _idot(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., in]`` @ int8 ``[in, out]`` → the exact integer sums as
    fp32 (float64 products: every partial sum is an integer below 2^53)."""
    return (qa.double() @ qw.double()).float()


def _quant_enc(enc: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """fp32 encoding → int8 by ``round(enc * inv)`` into ±127."""
    return torch.clamp(torch.round(enc.float() * inv), -127, 127).to(
        torch.int8)


def apply_nerf_quant(qp: QuantizedNerfParams, xyz_enc: torch.Tensor,
                     dir_enc: torch.Tensor,
                     cfg: NerfMLPConfig = NerfMLPConfig()) -> torch.Tensor:
    """The int8 graph on pre-encoded inputs (the plain int8 MLP): every
    dense layer int8×int8 → exact integer sum → ``acc * s + b`` in fp32.
    Returns ``[..., 4]`` raw ``(r, g, b, sigma)`` in fp32."""
    L, A = qp.layers, qp.inv_act

    def dq(name, qa):
        return _idot(qa, L[name]["qw"]) * L[name]["s"] + L[name]["b"]

    q_ex = _quant_enc(xyz_enc, A["enc_x"])
    q_ed = _quant_enc(dir_enc, A["enc_d"])
    q = _requant(dq("l1", q_ex), 0)
    q = _requant(dq("l2", q), 0)
    q = _requant(dq("l3", q), 0)
    q = _requant(dq("l4", q), 0)
    q = _requant(dq("l5", q), 0)
    q = _requant(dq("l6", torch.cat([q_ex, q], dim=-1)), 0)
    q = _requant(dq("l7", q), 0)
    q = _requant(dq("l8", q), 0)
    sigma = dq("alpha", q)                                  # fp32 out
    q_feat = _requant(dq("l9", q), -127)                    # no ReLU
    q = _requant(dq("l10", torch.cat([q_feat, q_ed], dim=-1)), 0)
    rgb = dq("l11", q)                                      # fp32 out
    return torch.cat([rgb, sigma], dim=-1)


def quantize_nerf(params: dict, cfg: NerfMLPConfig, points: torch.Tensor,
                  viewdirs: torch.Tensor) -> QuantizedNerfParams:
    """Calibrate and quantize in one step."""
    return quantize_nerf_params(
        params, cfg, calibrate_nerf_quant(params, cfg, points, viewdirs))


def calibration_samples(key: torch.Tensor, n: int, bbox_min, bbox_max,
                        device: str | torch.device = "cpu"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform positions in the box and uniform unit directions, drawn as
    the JAX package draws them from ``key``. The box must cover what the
    renderer queries: an under-sized box clips the position encoding.
    Prefer :func:`ray_calibration_samples` where camera poses exist."""
    kp, kd = rng.split(key)
    lo = torch.tensor(bbox_min, dtype=torch.float32, device=device)
    hi = torch.tensor(bbox_max, dtype=torch.float32, device=device)
    pts = rng.uniform(kp, (n, 3), device) * (hi - lo) + lo
    d = rng.normal(kd, (n, 3), device)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
    return pts, d


def ray_calibration_samples(key: torch.Tensor, n: int, poses,
                            height: int, width: int, focal: float,
                            near: float, far: float, ndc: bool = False,
                            ndc_variant: str = "canonical",
                            device: str | torch.device = "cpu"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Calibration ``(points, viewdirs)`` from real render queries: random
    pixels of random poses, uniform depths in ``[near, far]`` along their
    rays (NDC-warped where the scene is), as the JAX package draws them."""
    poses = torch.as_tensor(poses, dtype=torch.float32,
                            device=device)[:, :3, :4]
    kp, ki, kj, kt = rng.split(key, 4)
    pick = rng.randint(kp, (n,), 0, poses.shape[0], device).long()
    ii = rng.randint(ki, (n,), 0, width, device).float()
    jj = rng.randint(kj, (n,), 0, height, device).float()
    c2w = poses[pick]
    dirs_cam = torch.stack([(ii - width * 0.5) / focal,
                            -(jj - height * 0.5) / focal,
                            -torch.ones_like(ii)], dim=-1)
    rays_d = torch.einsum("nk,njk->nj", dirs_cam, c2w[:, :, :3])
    rays_o = c2w[:, :, 3]
    viewdirs = rays_d / torch.clamp(
        torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-8)
    if ndc:
        rays_o, rays_d = ndc_rays(height, width, focal, 1.0, rays_o, rays_d,
                                  variant=ndc_variant)
    t = rng.uniform(kt, (n, 1), device) * (far - near) + near
    return rays_o + t * rays_d, viewdirs
