"""Instant-NGP's radiance field (Müller et al. 2022, arXiv:2201.05989;
widths from its Table 1 and §5.4): a multiresolution hash encoding
(``ops/hash_encode.py``) feeding a density MLP, whose 16 outputs with the
view direction's degree-4 spherical harmonics (``ops/encoding.py::
sh_encode``) feed a colour MLP.

- Encoding: 16 levels of 2 features, 2^19 entries a level, resolutions 16
  to 2048 (levels 0-4 dense, 5-15 hashed): 6,098,120 entries, 12,196,240
  values. A point ``x`` of the ``[-bound, bound]³`` box enters as ``(x +
  bound) / (2 bound)``; an NDC scene's box is ``[-1, 1]³``.
- Density MLP: 32 → 64 → 16, ReLU, no biases (tiny-cuda-nn's
  ``FullyFusedMLP`` has none); output 0 is the log-density, ``σ = exp``.
- Colour MLP: the 16 density outputs and 16 SH values, 32 → 64 → 64 → 3,
  ReLU, no biases; the renderer's sigmoid makes the colour.

Params: ``{"field": {"table": {"0": [entries, 2], ..., "15": ...},
"density": {"l0": [32, 64], "l1": [64, 16]}, "color": {"l0": [32, 64],
"l1": [64, 64], "l2": [64, 3]}}}``, each level its own leaf. One field
serves both render passes. The table and its gradient stay float32.

The MLPs (``ops/ngp_mlp.py``): on a card in bfloat16 they run as one
hand-written forward kernel and one backward kernel a pass
(``csrc/ngp_mlp.cu``), the encoding's kernels beside them in one autograd
node (``FusedField``); on the CPU, with ``kernels="off"``, and in float32
on a card, as ``torch.matmul`` on operands in the compute dtype
(``ngp_mlp_plain``). Both round at the same points: operands in the
compute dtype; each hidden layer's float32 sum rounded to it after its
ReLU; the two output layers (the density MLP's, whose first output is the
log-density, and the colour MLP's) return float32 sums of those operands'
products, as the NeRF kernels' epilogues do, so ``σ = exp`` reads no
bfloat16 rounding of its exponent; ``geo`` and the SH rounded to the
compute dtype as the colour MLP's input. Backward, the kernels keep the
output layers' upstream gradients, the weight gradients and the features'
gradient in float32 (the ``torch.matmul`` chain rounds the last two and
the hidden input gradients to bfloat16).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from cvnerf_torch.ops import ngp_mlp
from cvnerf_torch.ops.encoding import sh_encode
from cvnerf_torch.ops.hash_encode import (FEATURES, GridLevel, grid_levels,
                                          hash_encode, total_entries)


# The published widths that the kernels and the tree fix: 2 features a
# level (the kernels' float2 entries), 16 density outputs, two hidden
# layers in the colour MLP, degree-4 SH (16 values).
GEO_FEATURES = 16
COLOR_LAYERS = 2
SH_DEGREE = 4


@dataclasses.dataclass(frozen=True)
class NgpFieldConfig:
    """The field's grid and MLP width (the published ones by default), its
    box, the table's initial range, and the optimizer settings of the
    paper's §4 that go with it (Adam's β₂ and ε, the L2 factor of the MLP
    weights; :meth:`adam`)."""
    n_levels: int = 16
    log2_table: int = 19
    base_res: int = 16
    max_res: int = 2048
    hidden: int = 64
    bound: float = 1.0
    init_scale: float = 1e-4
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
    l2_reg: float = 1e-6

    @property
    def levels(self) -> tuple[GridLevel, ...]:
        return _levels(self.n_levels, self.log2_table, self.base_res,
                       self.max_res)

    def mlp_layers(self) -> list[tuple[str, str, int, int]]:
        """``(net, layer, fan_in, fan_out)`` of both MLPs."""
        h = self.hidden
        widths = [GEO_FEATURES + SH_DEGREE ** 2] + [h] * COLOR_LAYERS + [3]
        return ([("density", "l0", FEATURES * self.n_levels, h),
                 ("density", "l1", h, GEO_FEATURES)]
                + [("color", f"l{k}", a, b)
                   for k, (a, b) in enumerate(zip(widths, widths[1:]))])

    def adam(self) -> dict:
        """``Adam``'s settings for the field: β₂, ε, the L2 factor on the
        MLP weights, and no update of a table entry whose gradient is
        exactly 0 (paper §4)."""
        return {"b2": self.adam_b2, "eps": self.adam_eps, "l2": self.l2_reg,
                "skip_zero": ("field/table",),
                "l2_on": ("field/density", "field/color")}


@functools.lru_cache(maxsize=None)
def _levels(n_levels, log2_table, base_res, max_res):
    return grid_levels(n_levels, log2_table, base_res, max_res)


def is_ngp(cfg) -> bool:
    return isinstance(cfg, NgpFieldConfig)


def ngp_param_count(cfg: NgpFieldConfig) -> tuple[int, int]:
    """``(table values, MLP weights)`` of a field."""
    return (FEATURES * total_entries(cfg.levels),
            sum(a * b for _, _, a, b in cfg.mlp_layers()))


def empty_ngp_params(cfg: NgpFieldConfig,
                     device: str | torch.device = "meta") -> dict:
    """The field's tree of uninitialised leaves (its shapes)."""
    f = {"table": {str(k): torch.empty(lv.entries, FEATURES,
                                       device=device)
                   for k, lv in enumerate(cfg.levels)},
         "density": {}, "color": {}}
    for net, name, fi, fo in cfg.mlp_layers():
        f[net][name] = torch.empty(fi, fo, device=device)
    return {"field": f}


def init_ngp_params(key: torch.Tensor,
                    cfg: NgpFieldConfig = NgpFieldConfig(),
                    device: str | torch.device = "cpu") -> dict:
    """A fresh field on ``device`` from the ``PRNGKey`` ``key``: each
    level's entries ``U(-init_scale, init_scale)`` (the paper's §4), drawn
    on ``device``; each MLP weight Xavier-uniform ``U(±sqrt(6 / (fan_in +
    fan_out)))``, tiny-cuda-nn's initialisation, drawn on the CPU."""
    from cvnerf_torch.ops.rng import split, uniform
    layers = cfg.mlp_layers()
    keys = split(key, cfg.n_levels + len(layers))
    s = cfg.init_scale
    table = {str(k): uniform(keys[k], (lv.entries, FEATURES), device,
                             -s, s)
             for k, lv in enumerate(cfg.levels)}
    field = {"table": table, "density": {}, "color": {}}
    for j, (net, name, fi, fo) in enumerate(layers):
        bound = float(np.float32(math.sqrt(6.0 / (fi + fo))))
        field[net][name] = uniform(keys[cfg.n_levels + j], (fi, fo), "cpu",
                                   -bound, bound).to(device)
    return {"field": field}


def unit_positions(points: torch.Tensor, cfg: NgpFieldConfig) -> torch.Tensor:
    """Points of the ``[-bound, bound]³`` box in the grid's unit cube,
    ``[n, 3]``: ``(x + bound) / (2 bound)``."""
    return ((points.reshape(-1, 3) + cfg.bound) / (2.0 * cfg.bound)) \
        .contiguous()


def apply_ngp(params: dict, points: torch.Tensor, viewdirs: torch.Tensor,
              cfg: NgpFieldConfig = NgpFieldConfig(),
              compute_dtype: torch.dtype = torch.float32,
              kernels: str = "on") -> torch.Tensor:
    """Raw ``(r, g, b, σ)`` ``[..., 4]`` of a field (``params["field"]`` or
    the field itself) at ``points [..., 3]`` with ``viewdirs`` of the same
    shape, or one a ray (``[R, 3]`` for ``[R, S, 3]`` points). RGB are
    logits; ``σ = exp(log-density) >= 0``, so the renderer's ReLU leaves it
    as it is.

    Card tensors in bfloat16 go through the kernels (``ngp_mlp.
    fused_field``; a field of other widths raises); CPU tensors, and
    ``kernels="off"``, through the encoding's and the MLPs' plain versions;
    float32 on a card through the encoding's kernel and the plain MLPs
    (``torch.matmul``: a plain large product, which no cell runs)."""
    field = params.get("field", params)
    lead = points.shape[:-1]
    tables = [field["table"][str(k)] for k in range(cfg.n_levels)]
    dt = compute_dtype
    unit = unit_positions(points, cfg)
    # One SH row a ray, or a sample where the directions are per sample.
    per_ray = viewdirs.dim() == points.dim() - 1
    spr = points.shape[-2] if per_ray else 1
    sh = sh_encode(viewdirs, SH_DEGREE).reshape(-1, SH_DEGREE ** 2)
    if points.is_cuda and kernels != "off" and dt == torch.bfloat16:
        ngp_mlp.check_kernel_config(cfg)
        weights = [field[net][name] for net, name, _, _ in ngp_mlp.LAYERS]
        raw = ngp_mlp.fused_field(unit, tables, cfg.levels, sh, spr, weights)
    else:
        # The features in the dtype the first layer reads.
        feats = hash_encode(unit, tables, cfg.levels, out_dtype=dt,
                            plain=kernels == "off")
        raw = ngp_mlp.ngp_mlp_plain(feats, sh, spr, field, dt)
    return raw.reshape(*lead, 4)
