"""Fused encode→NeRF-MLP forward: the CUDA kernel's wrapper and its plain
PyTorch version (port of the JAX package's ``ops/pallas/fused_mlp.py``).

``fused_nerf_apply(weights, points, viewdirs)`` computes ``freq_encode`` of
both inputs followed by the full 12-layer MLP and returns ``[n, 4]`` raw
``(r, g, b, sigma)`` in fp32. For CUDA tensors it launches the hand-written
kernel in ``cvnerf_torch/csrc/fused_mlp.cu`` (or raises); for CPU tensors it
runs :func:`fused_nerf_plain`. The kernel is built at first use
(``utils/kernels.py``) and bound with ``ctypes``.

Weights are packed once, by :class:`FusedNerfWeights`, into the kernels'
operand layout (``csrc/nerf_common.cuh``): the l6 and l10 weights are split
into their hidden/feature and encoding parts, encoding inputs zero-padded to
a multiple of 16, and every operand rounded to the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, apply_nerf
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.utils.kernels import load_library


def forward_flops(cfg: NerfMLPConfig) -> int:
    """FLOP per point of the forward MLP (2 × MACs of all 12 layers)."""
    w, h = cfg.trunk_width, cfg.head_width
    macs = (cfg.xyz_dim * w + 6 * w * w + (w + cfg.xyz_dim) * w + w * w + w
            + (w + cfg.dir_dim) * h + 3 * h)
    return 2 * macs


def _bind_forward(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cvnerf_fused_nerf_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.cvnerf_fused_nerf_forward.restype = ctypes.c_int
    lib.cvnerf_fused_nerf_bf16_plan.argtypes = [i, i, i, i, i,
                                                ctypes.POINTER(ctypes.c_int)]
    lib.cvnerf_fused_nerf_bf16_plan.restype = ctypes.c_int
    lib.cvnerf_fused_nerf_fp32_plan.argtypes = [i, i, i, i, i,
                                                ctypes.POINTER(ctypes.c_int)]
    lib.cvnerf_fused_nerf_fp32_plan.restype = ctypes.c_int
    for fn in (lib.cvnerf_fused_nerf_mat_elems, lib.cvnerf_fused_nerf_vec_elems):
        fn.argtypes = [i, i, i, i]
        fn.restype = ctypes.c_long


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def check_kernel_config(cfg: NerfMLPConfig) -> None:
    """Raise for an architecture the kernel does not take (use
    ``kernels="off"`` for those)."""
    w, h = cfg.trunk_width, cfg.head_width
    if w % 16 or h % 16 or not 16 <= h <= w <= 256:
        raise ValueError(
            f"the fused kernel needs trunk/head widths that are multiples of "
            f"16 with head <= trunk <= 256, got {w}/{h}; use kernels='off'")
    if not 0 <= cfg.xyz_freqs <= 20 or not 0 <= cfg.dir_freqs <= 20:
        raise ValueError("the fused kernel takes at most 20 frequency bands")


# The bf16 kernel (csrc/fused_mlp.cu, fused_nerf_wgmma): two consumer
# warpgroups of 64 points and one TMA producer warpgroup a block, a
# persistent grid of one block per SM, weights staged in 64-column chunks
# (the trunk width rounded up to 64 rows x 128 B each) in a ring of at most
# 8 stages beside each warpgroup's bf16 encodings [64, KX + 8] and
# [64, KD + 8] and fp32 raw inputs [2, 64 x 3].
BF16_TILE = 128
BF16_THREADS = 384
SMEM_LIMIT = 232_448          # a block's dynamic shared memory on sm_90
_MAX_STAGES = 8


def bf16_launch_plan(cfg: NerfMLPConfig, n: int, sm_count: int) -> dict:
    """The bf16 kernel's launch for ``n`` points on a card of ``sm_count``
    SMs, as ``cvnerf_fused_nerf_bf16_plan`` computes it: blocks, threads,
    dynamic shared-memory bytes, weight stages, and whether the kernel has
    the widths at compile time (the lego net's: trunk 256, head 128,
    KX 64, KD 32)."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    stage = _round_up(w, 64) * 64 * 2
    enc = 2 * (64 * (kx + 8 + kd + 8) * 2 + 2 * 64 * 3 * 4)
    stages = min(_MAX_STAGES,
                 (SMEM_LIMIT - 1024 - enc - 2 * _MAX_STAGES * 8) // stage)
    return {"blocks": min(-(-n // BF16_TILE), sm_count),
            "threads": BF16_THREADS,
            "smem_bytes": 1024 + stages * stage + enc + 2 * stages * 8,
            "stages": stages,
            "fixed": int((w, h, kx, kd) == (256, 128, 64, 32))}


def kernel_bf16_plan(cfg: NerfMLPConfig, n: int) -> dict:
    """The same plan as the built kernel computes it on the current card."""
    lib = load_library("fused_mlp", _bind_forward)
    plan = (ctypes.c_int * 5)()
    err = lib.cvnerf_fused_nerf_bf16_plan(n, cfg.trunk_width, cfg.head_width,
                                          cfg.xyz_freqs, cfg.dir_freqs, plan)
    if err != 0:
        raise RuntimeError(f"cvnerf_fused_nerf_bf16_plan: CUDA error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes", "stages", "fixed"),
                    plan))


# The fp32 kernel (csrc/fused_mlp.cu, fused_nerf_ffma; csrc/nerf_ffma.cuh):
# eight FFMA consumer warps and one producer warp a block, a persistent grid
# of one block per SM walking 64-point tiles, weights streamed by bulk
# copies in K-slabs of 16 rows (16 x trunk width fp32 a stage) into a ring
# of at most 8 stages beside the activation buffer [trunk, 64], the
# encodings [KX, 64] and [KD, 64] (fp32), the raw inputs [64 x 6] and the
# head partials [4, 64, 4] (fp32), then the stages' mbarriers.
FP32_TILE = 64
FP32_THREADS = 288
_FP32_SLAB = 16


def fp32_block_plan(cfg: NerfMLPConfig, own: int) -> tuple[int, int]:
    """The weight stages and dynamic shared-memory bytes of the fp32 kernels'
    block (csrc/nerf_ffma.cuh ``plan``; the forward and the backward's pass
    1), given the kernel's ``own`` bytes."""
    w = cfg.trunk_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    stage = _FP32_SLAB * w * 4
    fixed = FP32_TILE * (w + kx + kd) * 4 + FP32_TILE * 6 * 4 + own
    stages = min(_MAX_STAGES,
                 (SMEM_LIMIT - fixed - 2 * _MAX_STAGES * 8) // stage)
    return stages, stages * stage + fixed + 2 * stages * 8


def fp32_launch_plan(cfg: NerfMLPConfig, n: int, sm_count: int) -> dict:
    """The fp32 kernel's launch for ``n`` points on a card of ``sm_count``
    SMs, as ``cvnerf_fused_nerf_fp32_plan`` computes it: blocks, threads,
    dynamic shared-memory bytes, weight stages, and whether the kernel has
    the widths at compile time (the lego net's)."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    stages, smem = fp32_block_plan(cfg, 4 * FP32_TILE * 4 * 4)
    return {"blocks": min(-(-n // FP32_TILE), sm_count),
            "threads": FP32_THREADS, "smem_bytes": smem, "stages": stages,
            "fixed": int((w, h, kx, kd) == (256, 128, 64, 32))}


def kernel_fp32_plan(cfg: NerfMLPConfig, n: int) -> dict:
    """The same plan as the built kernel computes it on the current card."""
    lib = load_library("fused_mlp", _bind_forward)
    plan = (ctypes.c_int * 5)()
    err = lib.cvnerf_fused_nerf_fp32_plan(n, cfg.trunk_width, cfg.head_width,
                                          cfg.xyz_freqs, cfg.dir_freqs, plan)
    if err != 0:
        raise RuntimeError(f"cvnerf_fused_nerf_fp32_plan: CUDA error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes", "stages", "fixed"),
                    plan))


def mat_blocks(cfg: NerfMLPConfig) -> list[tuple[str, int, int]]:
    """The packed matrices in operand order, as ``(name, padded fan-in,
    fan-out)``; the backward kernel's gradients use the same layout."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _round_up(cfg.xyz_dim, 16), _round_up(cfg.dir_dim, 16)
    return ([("l1", kx, w)] + [(f"l{i}", w, w) for i in range(2, 6)]
            + [("l6a", w, w), ("l6b", kx, w)]
            + [(f"l{i}", w, w) for i in (7, 8, 9)]
            + [("l10a", w, h), ("l10b", kd, h)])


def packed_size(cfg: NerfMLPConfig) -> int:
    """Elements of ``wmat`` plus ``wvec`` (the matrices, then b1..b9, b10,
    wa, w11, ba[4], b11[4])."""
    w, h = cfg.trunk_width, cfg.head_width
    mats = sum(fin * fout for _, fin, fout in mat_blocks(cfg))
    return mats + 9 * w + h + w + 3 * h + 4 + 4


def pack_params(params: dict, cfg: NerfMLPConfig,
                compute_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One net's params → ``(wmat, wvec)`` in the kernel's operand layout,
    on the params' device. Matrices are ``[out, in]`` for bf16 (the wgmma
    K-major B operand, each block a TMA tensor: 16-byte aligned, rows of
    16-byte multiples) and ``[in, out]`` for fp32 (each K-slab of rows one
    contiguous bulk copy)."""
    check_kernel_config(cfg)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    kx = _round_up(cfg.xyz_dim, 16)
    kd = _round_up(cfg.dir_dim, 16)
    xd, w = cfg.xyz_dim, cfg.trunk_width

    def f32(name, part="w"):
        return params[name][part].detach().float()

    def pad_in(mat, rows):  # mat [in, out] → [rows, out], zero rows appended
        return torch.cat([mat, mat.new_zeros(rows - mat.shape[0], mat.shape[1])])

    blocks = {f"l{i}": f32(f"l{i}") for i in (2, 3, 4, 5, 7, 8, 9)}
    blocks.update(l1=pad_in(f32("l1"), kx), l6a=f32("l6")[xd:],
                  l6b=pad_in(f32("l6")[:xd], kx), l10a=f32("l10")[:w],
                  l10b=pad_in(f32("l10")[w:], kd))
    mats = [blocks[name] for name, _, _ in mat_blocks(cfg)]
    if compute_dtype == torch.bfloat16:
        wmat = torch.cat([m.t().contiguous().reshape(-1) for m in mats])
    else:
        wmat = torch.cat([m.contiguous().reshape(-1) for m in mats])
    wmat = wmat.to(compute_dtype).contiguous()

    def rounded(t):  # head weights: rounded to the compute dtype, kept fp32
        return t.to(compute_dtype).float()

    def pad4(t):
        return torch.cat([t, t.new_zeros(4 - t.numel())])

    vec = [f32(f"l{i}", "b") for i in range(1, 10)] + [
        f32("l10", "b"), rounded(f32("alpha")[:, 0]),
        rounded(f32("l11").t().contiguous().reshape(-1)),
        pad4(f32("alpha", "b")), pad4(f32("l11", "b"))]
    wvec = torch.cat(vec).contiguous()
    return wmat, wvec


class FusedNerfWeights:
    """One net's parameters together with their kernel packing, made once
    (when a renderer loads its weights) and reused for every launch."""

    def __init__(self, params: dict, cfg: NerfMLPConfig,
                 compute_dtype: torch.dtype):
        self.params = params
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = params["l1"]["w"].device
        self.wmat, self.wvec = (pack_params(params, cfg, compute_dtype)
                                if self.device.type == "cuda" else (None, None))

    def to(self, device: torch.device) -> "FusedNerfWeights":
        """The same net packed on ``device`` (itself when it lies there)."""
        if self.device == device:
            return self
        return FusedNerfWeights(
            {name: {k: t.to(device) for k, t in layer.items()}
             for name, layer in self.params.items()},
            self.cfg, self.compute_dtype)


def fused_nerf_plain(params: dict, points: torch.Tensor,
                     viewdirs: torch.Tensor, cfg: NerfMLPConfig,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``freq_encode`` + the MLP,
    with the same cast points (encodings fp32, operands rounded to the
    compute dtype, fp32 accumulation, bias + ReLU in fp32)."""
    fused_nerf_plain.calls += 1
    xe = freq_encode(points.float(), cfg.xyz_freqs)
    de = freq_encode(viewdirs.float(), cfg.dir_freqs)
    return apply_nerf(params, xe, de, cfg, compute_dtype=compute_dtype)


fused_nerf_plain.calls = 0


def check_point_inputs(points: torch.Tensor, viewdirs: torch.Tensor) -> None:
    """Raise unless ``points`` and ``viewdirs`` are ``[n, 3]`` tensors of
    one length on one device."""
    for name, t in (("points", points), ("viewdirs", viewdirs)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be [n, 3], got {list(t.shape)}")
    if points.shape[0] != viewdirs.shape[0]:
        raise ValueError("points and viewdirs must have the same length")
    if points.device != viewdirs.device:
        raise ValueError("points and viewdirs must be on one device")


def check_kernel_inputs(points: torch.Tensor, viewdirs: torch.Tensor,
                        weights_device: torch.device, packed: bool) -> None:
    """Raise unless a forward kernel can take these inputs: CUDA tensors,
    contiguous float32, fewer than 2^31 points, and weights packed on the
    points' device."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if not packed or weights_device != points.device:
        raise ValueError(f"weights live on {weights_device}, points on "
                         f"{points.device}: pack the weights on the "
                         "points' device")
    for name, t in (("points", points), ("viewdirs", viewdirs)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if points.shape[0] >= 2 ** 31:
        raise ValueError(f"n={points.shape[0]} points exceeds the kernel's "
                         "int32 range")


def fused_nerf_apply(weights: FusedNerfWeights, points: torch.Tensor,
                     viewdirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the encode→MLP pipeline at ``points``/``viewdirs`` ``[n, 3]``.

    CUDA tensors go to the kernel (launch count in
    ``fused_nerf_apply.launches``); CPU tensors to :func:`fused_nerf_plain`.
    Returns ``[n, 4]`` fp32 ``(r, g, b, sigma)``.
    """
    check_point_inputs(points, viewdirs)
    if points.device.type == "cpu":
        return fused_nerf_plain(weights.params, points, viewdirs, weights.cfg,
                                weights.compute_dtype)
    check_kernel_inputs(points, viewdirs, weights.device,
                        weights.wmat is not None)
    if weights.wmat.data_ptr() % 16:
        raise ValueError("packed weights must start 16-byte aligned (TMA)")
    cfg = weights.cfg
    lib = load_library("fused_mlp", _bind_forward)
    n = points.shape[0]
    w, h, lx, ld = cfg.trunk_width, cfg.head_width, cfg.xyz_freqs, cfg.dir_freqs
    if (lib.cvnerf_fused_nerf_mat_elems(w, h, lx, ld) != weights.wmat.numel()
            or lib.cvnerf_fused_nerf_vec_elems(w, h, lx, ld)
            != weights.wvec.numel()):
        raise ValueError("packed weights do not match the kernel's layout")
    out = torch.empty((n, 4), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.cvnerf_fused_nerf_forward(
            points.data_ptr(), viewdirs.data_ptr(), weights.wmat.data_ptr(),
            weights.wvec.data_ptr(), out.data_ptr(), n, w, h, lx, ld,
            int(weights.compute_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_nerf kernel launch failed: CUDA error {err}")
    fused_nerf_apply.launches += 1
    return out


fused_nerf_apply.launches = 0
