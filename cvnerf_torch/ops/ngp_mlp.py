"""The Instant-NGP field's two MLPs (density 32 → 64 → 16, colour 32 → 64 →
64 → 3, no biases): the CUDA kernels' wrappers (``csrc/ngp_mlp.cu``), their
plain PyTorch version and the ``torch.autograd.Function`` that runs the
field on a card.

It replaces no TPU kernel: the JAX package has no hash-grid field. It was
added because the MLPs, as ``torch.matmul`` on bf16 operands, cost a train
step several dozen launches a pass (five GEMMs, casts, ReLUs, the SH
expanded to every sample, three concatenations, and autograd's ten GEMMs,
threshold and cast backwards), each moving ``[n, 32..64]`` activations
through device memory. What bounds the work on this card: bytes and
launches, not the tensor cores (9,408 multiply-adds a sample, ~290 B of
features and gradients in and out). The kernels keep every activation in
registers: one forward launch, and one backward launch that recomputes the
forward, writes the features' gradient in float32 and a slab of weight
gradients a block, which ``ngp_mlp_wgrad_reduce`` sums in a fixed order.

The arithmetic is :func:`ngp_mlp_plain`'s, the ``torch.matmul`` chain the
field ran before: bf16 operands, each hidden layer's float32 sum rounded to
bf16 after its ReLU, the two output layers (density l1, colour l2) as
float32 sums of bf16 products, ``geo`` and the SH rounded to bf16 as the
colour MLP's input, ``σ = exp(geo[0])``. Backward, the output layers'
float32 upstream gradients meet their weights in float32 (FFMA); the hidden
deltas are bf16 operands with float32 sums; the weight gradients and the
features' gradient are float32 sums (the chain rounded both to bf16). Sums
run in another order than cuBLAS's, so the kernels agree with the plain
version to bf16 rounding, and their weight gradients are the same bits from
run to run.

:func:`fused_field` (:class:`FusedField`) runs the hash encoding's kernels
(``ops/hash_encode.py``, unchanged) and these as one autograd node, so the
features' float32 gradient reaches ``hash_encode_bwd`` as it is: autograd
casts a gradient to its input's dtype, and the features are bf16. ``stats``
counts the kernels' launches, the plain version's calls and the samples
either computed, at eager calls and at captures, not at replays (as
``hash_encode.stats``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cvnerf_torch.ops import hash_encode as he
from cvnerf_torch.ops.fused_mlp import load_library

# The widths the kernels take: 32 hash features (16 levels of 2), 64
# hidden, 16 density outputs, degree-4 SH (16 values), 3 colours.
FEATURES = 32
HIDDEN = 64
GEO = 16
SH = 16
# The leaves in the kernels' order, with their shapes ([in, out]).
LAYERS = (("density", "l0", FEATURES, HIDDEN), ("density", "l1", HIDDEN, GEO),
          ("color", "l0", GEO + SH, HIDDEN), ("color", "l1", HIDDEN, HIDDEN),
          ("color", "l2", HIDDEN, 3))
WEIGHTS = sum(a * b for _, _, a, b in LAYERS)      # 9,408
# csrc/ngp_mlp.cu: 8 warps a block, 16-sample tiles, backward chunks of 128.
WARPS = 8
TILE = 16
CHUNK = WARPS * TILE

stats = {"fwd_launches": 0, "bwd_launches": 0, "plain_calls": 0,
         "samples": 0}


def ngp_mlp_plain(feats: torch.Tensor, sh: torch.Tensor,
                  samples_per_ray: int, field: dict,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """Raw ``(r, g, b, σ)`` ``[n, 4]`` of the two MLPs at features ``feats
    [n, 32]`` (in the compute dtype) with ``sh [n / samples_per_ray, 16]``,
    sample ``i`` reading row ``i // samples_per_ray``: the products through
    ``torch.matmul`` on operands in the compute dtype, the two output layers
    as float32 sums of those operands' products (TF32 is off for float32
    matmuls by default)."""
    n = feats.shape[0]
    stats["plain_calls"] += 1
    stats["samples"] += n
    dt = compute_dtype

    def lin(x, w, out32=False):
        x, w = x.to(dt), w.to(dt)
        if out32:
            return torch.matmul(x.float(), w.float())
        return torch.matmul(x, w)
    h = torch.relu(lin(feats, field["density"]["l0"]))
    geo = lin(h, field["density"]["l1"], out32=True)      # [n, 16] float32
    h = torch.cat([geo, sample_sh(sh, n, samples_per_ray)], -1)
    color = field["color"]
    n_color = len(color)
    for k in range(n_color):
        last = k == n_color - 1
        h = lin(h, color[f"l{k}"], out32=last)
        if not last:
            h = torch.relu(h)
    sigma = torch.exp(geo[:, :1])
    return torch.cat([h, sigma], -1)


def sample_sh(sh: torch.Tensor, n: int, samples_per_ray: int) -> torch.Tensor:
    """The SH of each of ``n`` samples, ``[n, 16]``: row ``i //
    samples_per_ray`` of ``sh``, as the kernels read it."""
    return sh[:, None, :].expand(-1, samples_per_ray, -1).reshape(n, -1)


def check_kernel_config(cfg) -> None:
    """Raise for a field whose widths the kernels do not take (use
    ``kernels="off"`` for those)."""
    feats = he.FEATURES * cfg.n_levels
    if (cfg.hidden, feats) != (HIDDEN, FEATURES):
        raise ValueError(
            f"the fused NGP MLP kernels take {FEATURES} features and "
            f"{HIDDEN} hidden, got {feats} and {cfg.hidden}; use "
            f"kernels='off'")


def _check(feats: torch.Tensor, sh: torch.Tensor, samples_per_ray: int,
           weights: list) -> torch.device:
    dev = feats.device
    if (feats.dtype != torch.bfloat16 or feats.dim() != 2
            or feats.shape[1] != FEATURES or not feats.is_contiguous()):
        raise ValueError(f"features must be contiguous bfloat16 [n, "
                         f"{FEATURES}], got {feats.dtype} "
                         f"{list(feats.shape)}; use kernels='off'")
    n = feats.shape[0]
    if (sh.device != dev or sh.dtype != torch.float32 or sh.dim() != 2
            or sh.shape[1] != SH or not sh.is_contiguous()
            or samples_per_ray < 1 or sh.shape[0] * samples_per_ray != n):
        raise ValueError(f"SH must be contiguous float32 [n / "
                         f"samples_per_ray, {SH}] on {dev}, got {sh.dtype} "
                         f"{list(sh.shape)} on {sh.device} for {n} samples "
                         f"at {samples_per_ray} a ray; use kernels='off'")
    if len(weights) != len(LAYERS):
        raise ValueError(f"{len(weights)} weights for {len(LAYERS)} layers")
    for w, (net, name, a, b) in zip(weights, LAYERS):
        if (w.device != dev or w.dtype != torch.float32
                or tuple(w.shape) != (a, b) or not w.is_contiguous()):
            raise ValueError(f"{net} {name} must be contiguous float32 "
                             f"[{a}, {b}] on {dev}, got {w.dtype} "
                             f"{list(w.shape)} on {w.device}; use "
                             f"kernels='off'")
    if dev.type != "cuda":
        raise ValueError(f"the fused NGP MLP kernels run on a card, not "
                         f"{dev}; the plain version is ngp_mlp_plain")
    return dev


def _bind(lib) -> None:
    p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cvnerf_ngp_mlp_fwd.argtypes = [p, p, q, i, p, p, i, p]
    lib.cvnerf_ngp_mlp_bwd.argtypes = [p, p, p, q, i, p, p, p, i, p]
    lib.cvnerf_ngp_mlp_wgrad_reduce.argtypes = [p, i, p, p]
    for fn in (lib.cvnerf_ngp_mlp_fwd, lib.cvnerf_ngp_mlp_bwd,
               lib.cvnerf_ngp_mlp_wgrad_reduce, lib.cvnerf_ngp_mlp_weights,
               lib.cvnerf_ngp_mlp_chunk):
        fn.restype = i
    if (lib.cvnerf_ngp_mlp_weights(), lib.cvnerf_ngp_mlp_chunk()) \
            != (WEIGHTS, CHUNK):
        raise RuntimeError("csrc/ngp_mlp.cu and ops/ngp_mlp.py disagree on "
                           "the weights or the chunk")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_plan(n: int, sms: int) -> dict:
    """The kernels' grids at ``n`` samples on a card of ``sms`` SMs: the
    forward two blocks an SM at most, over 16-sample tiles, 8 a block; the
    backward one block an SM at most (its 184 KB of shared memory), over
    chunks of 128 samples, each block a slab of the weight gradients."""
    return {"fwd": max(1, min(-(-n // (TILE * WARPS)), 2 * sms)),
            "bwd": max(1, min(-(-n // CHUNK), sms))}


def _ptrs(weights: list) -> np.ndarray:
    return np.array([w.data_ptr() for w in weights], dtype=np.int64)


def _run(fn_name: str, dev, *args) -> None:
    lib = load_library("ngp_mlp", _bind)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def ngp_mlp_fwd(feats: torch.Tensor, sh: torch.Tensor, samples_per_ray: int,
                weights: list) -> torch.Tensor:
    """``[n, 4]`` raw ``(r, g, b, σ)`` float32 of the kernel ``ngp_mlp_fwd``
    at card tensors: features ``[n, 32]`` bf16, ``sh [n / samples_per_ray,
    16]`` float32 and the five float32 leaves of :data:`LAYERS`; raises on
    anything else."""
    dev = _check(feats, sh, samples_per_ray, weights)
    n = feats.shape[0]
    out = torch.empty(n, 4, dtype=torch.float32, device=dev)
    if n:
        w = _ptrs(weights)
        _run("cvnerf_ngp_mlp_fwd", dev, feats.data_ptr(), sh.data_ptr(), n,
             samples_per_ray, w.ctypes.data, out.data_ptr(),
             launch_plan(n, _sms(dev))["fwd"])
    stats["fwd_launches"] += 1
    stats["samples"] += n
    return out


def ngp_mlp_bwd(feats: torch.Tensor, sh: torch.Tensor, samples_per_ray: int,
                weights: list, grad: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """The kernels ``ngp_mlp_bwd`` and ``ngp_mlp_wgrad_reduce``: from the
    outputs' gradient ``grad [n, 4]`` (float32), the features' gradient
    ``[n, 32]`` float32 and the five leaves' gradients (float32, views of one
    buffer), at the forward's inputs."""
    dev = _check(feats, sh, samples_per_ray, weights)
    n = feats.shape[0]
    grad = grad.float().contiguous()
    if tuple(grad.shape) != (n, 4) or grad.device != dev:
        raise ValueError(f"gradient {list(grad.shape)} on {grad.device} for "
                         f"{n} samples on {dev}")
    fgrad = torch.empty(n, FEATURES, dtype=torch.float32, device=dev)
    flat = torch.empty(WEIGHTS, dtype=torch.float32, device=dev)
    if n:
        grid = launch_plan(n, _sms(dev))["bwd"]
        slabs = torch.empty(grid, WEIGHTS, dtype=torch.float32, device=dev)
        w = _ptrs(weights)
        _run("cvnerf_ngp_mlp_bwd", dev, feats.data_ptr(), sh.data_ptr(),
             grad.data_ptr(), n, samples_per_ray, w.ctypes.data,
             fgrad.data_ptr(), slabs.data_ptr(), grid)
        _run("cvnerf_ngp_mlp_wgrad_reduce", dev, slabs.data_ptr(), grid,
             flat.data_ptr())
    else:
        flat.zero_()
    stats["bwd_launches"] += 1
    out, at = [], 0
    for _, _, a, b in LAYERS:
        out.append(flat[at:at + a * b].view(a, b))
        at += a * b
    return fgrad, out


class FusedField(torch.autograd.Function):
    """The hash encoding and both MLPs on a card, differentiable in the
    level tables and the five MLP leaves (positions and SH are data):
    ``hash_encode_fwd`` (bf16 features), ``ngp_mlp_fwd``; backward
    ``ngp_mlp_bwd`` and its reduction, then ``hash_encode_bwd`` on the
    features' float32 gradient."""

    @staticmethod
    def forward(ctx, unit, sh, samples_per_ray, levels, n_tables, *leaves):
        tables, weights = list(leaves[:n_tables]), list(leaves[n_tables:])
        feats = he.hash_encode_fwd(unit, tables, levels, torch.bfloat16)
        out = ngp_mlp_fwd(feats, sh, samples_per_ray, weights)
        ctx.save_for_backward(unit, feats, sh, *weights)
        ctx.samples_per_ray, ctx.levels = samples_per_ray, levels
        return out

    @staticmethod
    def backward(ctx, g):
        unit, feats, sh, *weights = ctx.saved_tensors
        fgrad, wgrads = ngp_mlp_bwd(feats, sh, ctx.samples_per_ray, weights,
                                    g)
        flat = he.hash_encode_bwd(unit, fgrad, ctx.levels)
        return (None, None, None, None, None,
                *(flat[lv.offset:lv.offset + lv.entries]
                  for lv in ctx.levels), *wgrads)


def fused_field(unit: torch.Tensor, tables: list, levels, sh: torch.Tensor,
                samples_per_ray: int, weights: list) -> torch.Tensor:
    """``[n, 4]`` raw ``(r, g, b, σ)`` of the field at unit positions ``unit
    [n, 3]`` through the kernels (:class:`FusedField`)."""
    return FusedField.apply(unit.contiguous(), sh.contiguous(),
                            samples_per_ray, levels, len(tables), *tables,
                            *weights)
