"""Fused encode→int8 NeRF-MLP forward for serving: the CUDA kernel's wrapper
and its plain PyTorch version (port of the JAX package's
``ops/pallas/fused_mlp_int8.py``).

``fused_nerf_apply_int8(weights, points, viewdirs)`` computes
``freq_encode`` of both inputs followed by the int8 graph of
``ops/quantize.py::apply_nerf_quant`` and returns ``[n, 4]`` raw ``(r, g,
b, sigma)`` in fp32. For CUDA tensors it launches the hand-written kernel
in ``cvnerf_torch/csrc/fused_mlp_int8.cu`` (or raises); for CPU tensors it
runs :func:`fused_nerf_int8_plain`. The kernel is built and bound like the
float kernels (``utils/kernels.py``).

A net's :class:`~cvnerf_torch.ops.quantize.QuantizedNerfParams` are packed
once, by :class:`QuantizedNerfWeights`, into the kernel's operand layout
(:func:`pack_qparams`): the output rows of the twelve matrices the kernel
streams by TMA are stored in :func:`row_order`, so that a layer's
accumulator fragment packs straight into the next layer's int8 A fragment.
"""

from __future__ import annotations

import ctypes

import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.fused_mlp import (SMEM_LIMIT, _round_up,
                                       check_kernel_inputs,
                                       check_point_inputs)
from cvnerf_torch.ops.quantize import QuantizedNerfParams, apply_nerf_quant
from cvnerf_torch.utils.kernels import load_library


def check_int8_kernel_config(cfg: NerfMLPConfig) -> None:
    """Raise for an architecture the int8 kernel does not take (serve those
    with ``kernels="off"``)."""
    w, h = cfg.trunk_width, cfg.head_width
    if w % 16 or h % 16 or not 16 <= h <= w <= 256:
        raise ValueError(
            f"the int8 kernel needs trunk/head widths that are multiples of "
            f"16 with head <= trunk <= 256, got {w}/{h}; use kernels='off'")
    if not 0 <= cfg.xyz_freqs <= 20 or not 0 <= cfg.dir_freqs <= 20:
        raise ValueError("the int8 kernel takes at most 20 frequency bands; "
                         "use kernels='off'")


def qmat_blocks(cfg: NerfMLPConfig) -> list[tuple[str, int, int]]:
    """The packed int8 matrices in operand order, as ``(name, fan-out,
    padded fan-in)``; each is stored ``[out, in]`` row-major, the first
    twelve (``l1`` .. ``l10b``, the kernel's TMA tensors) with their rows in
    :func:`row_order`."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    return ([("l1", w, kx)] + [(f"l{i}", w, w) for i in range(2, 6)]
            + [("l6a", w, w), ("l6b", w, kx)]
            + [(f"l{i}", w, w) for i in (7, 8, 9)]
            + [("l10a", h, w), ("l10b", h, kd), ("alpha", 1, w),
               ("l11", 3, h)])


def qvec_blocks(cfg: NerfMLPConfig) -> list[tuple[str, int]]:
    """The packed fp32 vectors in operand order, as ``(name, length)``."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    out = [("inv_x", kx), ("inv_d", kd)]
    for i in range(1, 10):
        out += [(f"s{i}", w), (f"b{i}", w)]
    return out + [("s10", h), ("b10", h), ("sa", 4), ("ba", 4), ("s11", 4),
                  ("b11", 4)]


# The matrices the kernel stages by TMA and multiplies by wgmma (the heads
# "alpha" and "l11" it reads as dot products, in logical order).
STAGED = ("l1", "l2", "l3", "l4", "l5", "l6a", "l6b", "l7", "l8", "l9",
          "l10a", "l10b")


def row_order(n: int) -> torch.Tensor:
    """The logical output row stored at each packed row of a staged matrix
    with ``n`` rows (a multiple of 16): within each 32-row block, packed row
    ``c = 8 j + 2 t + e`` holds logical row ``16 (j >> 1) + 4 t + 2 (j & 1)
    + e``. Accumulator column ``c`` of the kernel's wgmma then computes that
    logical output, and the four a thread holds for one row in each 16-row
    half are the four consecutive bytes of its next A fragment register. A
    16-row tail block maps onto itself."""
    c = torch.arange(n)
    j, t, e = (c % 32) // 8, (c % 8) // 2, c % 2
    return c - c % 32 + 16 * (j // 2) + 4 * t + 2 * (j % 2) + e


def pack_qparams(qp: QuantizedNerfParams, cfg: NerfMLPConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One net's int8 params → ``(qmat, qvec)`` in the kernel's operand
    layout (``csrc/fused_mlp_int8.cu``), on the params' device: the weights
    ``[out, in]`` int8, l6 split into its hidden and encoding parts, l10 into
    its feature and dir-encoding parts, the encoding fan-ins zero-padded to
    a multiple of 16 (with zero ``inv_act`` at the pad entries), the rows of
    the staged matrices in :func:`row_order`; scales, biases and
    ``inv_act`` as fp32 vectors in logical order. Every block starts
    16-byte aligned with rows of 16-byte multiples (TMA's requirement:
    every width is a multiple of 16)."""
    check_int8_kernel_config(cfg)
    L = qp.layers
    xd, w = cfg.xyz_dim, cfg.trunk_width

    def out_in(name):                    # [in, out] → [out, in]
        return L[name]["qw"].t()

    def pad(t, n):                       # zero-pad the last dim to n
        return torch.nn.functional.pad(t, (0, n - t.shape[-1]))

    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    mats = {f"l{i}": out_in(f"l{i}") for i in (2, 3, 4, 5, 7, 8, 9)}
    mats.update(l1=pad(out_in("l1"), kx), l6a=out_in("l6")[:, xd:],
                l6b=pad(out_in("l6")[:, :xd], kx), l10a=out_in("l10")[:, :w],
                l10b=pad(out_in("l10")[:, w:], kd), alpha=out_in("alpha"),
                l11=out_in("l11"))
    for name in STAGED:
        mats[name] = mats[name][row_order(mats[name].shape[0]).to(
            mats[name].device)]
    qmat = torch.cat([mats[name].reshape(-1)
                      for name, _, _ in qmat_blocks(cfg)])
    vecs = {"inv_x": pad(qp.inv_act["enc_x"].float(), kx),
            "inv_d": pad(qp.inv_act["enc_d"].float(), kd)}
    for i in range(1, 11):
        vecs[f"s{i}"] = L[f"l{i}"]["s"].float()
        vecs[f"b{i}"] = L[f"l{i}"]["b"].float()
    for name, key in (("sa", "alpha"), ("s11", "l11")):
        vecs[name] = pad(L[key]["s"].float(), 4)
    for name, key in (("ba", "alpha"), ("b11", "l11")):
        vecs[name] = pad(L[key]["b"].float(), 4)
    qvec = torch.cat([vecs[name] for name, _ in qvec_blocks(cfg)])
    return qmat.to(torch.int8).contiguous(), qvec.contiguous()


class QuantizedNerfWeights:
    """One net's int8 parameters together with their kernel packing, made
    once (when a renderer quantizes its nets) and reused for every
    launch."""

    def __init__(self, qp: QuantizedNerfParams, cfg: NerfMLPConfig):
        self.qp = qp
        self.cfg = cfg
        self.device = qp.device
        self.qmat, self.qvec = (pack_qparams(qp, cfg)
                                if self.device.type == "cuda" else (None, None))

    def to(self, device: torch.device) -> "QuantizedNerfWeights":
        """The same net packed on ``device`` (itself when it lies there)."""
        if self.device == device:
            return self
        return QuantizedNerfWeights(self.qp.to(device), self.cfg)


def fused_nerf_int8_plain(qp: QuantizedNerfParams, points: torch.Tensor,
                          viewdirs: torch.Tensor,
                          cfg: NerfMLPConfig) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``freq_encode`` (fp32) +
    :func:`~cvnerf_torch.ops.quantize.apply_nerf_quant`."""
    fused_nerf_int8_plain.calls += 1
    xe = freq_encode(points.float(), cfg.xyz_freqs)
    de = freq_encode(viewdirs.float(), cfg.dir_freqs)
    return apply_nerf_quant(qp, xe, de, cfg)


fused_nerf_int8_plain.calls = 0


# The kernel (csrc/fused_mlp_int8.cu, fused_nerf_int8_wgmma): the bf16
# kernel's block (two consumer warpgroups of 64 points and one TMA producer
# warpgroup, a persistent grid of one block per SM), weights staged in
# 128-column chunks (the trunk width rounded up to 64 rows x 128 B each) in
# a ring of at most 8 stages beside each warpgroup's int8 encodings
# [64, KX' + 16] and [64, KD' + 16] (the fan-ins rounded up to 32), fp32
# raw inputs [2, 64 x 3] and a copy of the head weights (W + 3H bytes), and
# the block's copy of qvec up to b10 (the encodings' inverses, the requant
# scales and biases; fp32).
INT8_TILE = 128
INT8_THREADS = 384
_MAX_STAGES = 8


def int8_launch_plan(cfg: NerfMLPConfig, n: int, sm_count: int) -> dict:
    """The int8 kernel's launch for ``n`` points on a card of ``sm_count``
    SMs, as ``cvnerf_fused_nerf_int8_plan`` computes it: blocks, threads,
    dynamic shared-memory bytes, weight stages, and whether the kernel has
    the widths at compile time (the lego net's: trunk 256, head 128, KX 64,
    KD 32)."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    stage = _round_up(w, 64) * 128
    enc = 2 * (64 * (_round_up(kx, 32) + 16 + _round_up(kd, 32) + 16)
               + 2 * 64 * 3 * 4 + w + 3 * h)
    vec = (kx + kd + 18 * w + 2 * h) * 4
    stages = min(_MAX_STAGES, (SMEM_LIMIT - 1024 - enc - vec
                               - 2 * _MAX_STAGES * 8) // stage)
    return {"blocks": min(-(-n // INT8_TILE), sm_count),
            "threads": INT8_THREADS,
            "smem_bytes": 1024 + stages * stage + enc + vec + 2 * stages * 8,
            "stages": stages,
            "fixed": int((w, h, kx, kd) == (256, 128, 64, 32))}


def kernel_int8_plan(cfg: NerfMLPConfig, n: int) -> dict:
    """The same plan as the built kernel computes it on the current card."""
    lib = load_library("fused_mlp_int8", _bind)
    plan = (ctypes.c_int * 5)()
    err = lib.cvnerf_fused_nerf_int8_plan(n, cfg.trunk_width, cfg.head_width,
                                          cfg.xyz_freqs, cfg.dir_freqs, plan)
    if err != 0:
        raise RuntimeError(f"cvnerf_fused_nerf_int8_plan: CUDA error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes", "stages", "fixed"),
                    plan))


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cvnerf_fused_nerf_int8_forward.argtypes = [p, p, p, p, p, i, i, i, i,
                                                   i, p]
    lib.cvnerf_fused_nerf_int8_forward.restype = ctypes.c_int
    lib.cvnerf_fused_nerf_int8_plan.argtypes = [i, i, i, i, i,
                                                ctypes.POINTER(ctypes.c_int)]
    lib.cvnerf_fused_nerf_int8_plan.restype = ctypes.c_int
    for fn in (lib.cvnerf_fused_nerf_int8_mat_elems,
               lib.cvnerf_fused_nerf_int8_vec_elems):
        fn.argtypes = [i, i, i, i]
        fn.restype = ctypes.c_long


def fused_nerf_apply_int8(weights: QuantizedNerfWeights, points: torch.Tensor,
                          viewdirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the int8 encode→MLP pipeline at ``points``/``viewdirs``
    ``[n, 3]``.

    CUDA tensors go to the kernel (launch count in
    ``fused_nerf_apply_int8.launches``); CPU tensors to
    :func:`fused_nerf_int8_plain`. Returns ``[n, 4]`` fp32 ``(r, g, b,
    sigma)``.
    """
    check_point_inputs(points, viewdirs)
    if points.device.type == "cpu":
        return fused_nerf_int8_plain(weights.qp, points, viewdirs,
                                     weights.cfg)
    check_kernel_inputs(points, viewdirs, weights.device,
                        weights.qmat is not None)
    if weights.qmat.data_ptr() % 16 or weights.qvec.data_ptr() % 16:
        raise ValueError("packed int8 weights must start 16-byte aligned "
                         "(TMA, float4 loads)")
    cfg = weights.cfg
    lib = load_library("fused_mlp_int8", _bind)
    n = points.shape[0]
    w, h, lx, ld = cfg.trunk_width, cfg.head_width, cfg.xyz_freqs, cfg.dir_freqs
    if (lib.cvnerf_fused_nerf_int8_mat_elems(w, h, lx, ld)
            != weights.qmat.numel()
            or lib.cvnerf_fused_nerf_int8_vec_elems(w, h, lx, ld)
            != weights.qvec.numel()):
        raise ValueError("packed int8 weights do not match the kernel's "
                         "layout")
    out = torch.empty((n, 4), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.cvnerf_fused_nerf_int8_forward(
            points.data_ptr(), viewdirs.data_ptr(), weights.qmat.data_ptr(),
            weights.qvec.data_ptr(), out.data_ptr(), n, w, h, lx, ld, stream)
    if err != 0:
        raise RuntimeError(f"int8 kernel launch failed: CUDA error {err}")
    fused_nerf_apply_int8.launches += 1
    return out


fused_nerf_apply_int8.launches = 0
