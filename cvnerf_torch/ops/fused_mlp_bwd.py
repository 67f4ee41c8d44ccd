"""Backward of the fused encode→NeRF-MLP: the CUDA kernel's wrapper, its
plain PyTorch version and the ``torch.autograd.Function`` that makes the
fused pipeline differentiable (port of the JAX package's
``ops/pallas/fused_mlp_bwd.py``).

Strategy, as in the JAX package: the forward saves no activations; the
backward kernel (``cvnerf_torch/csrc/fused_mlp_bwd.cu``) recomputes the
forward per tile of points and backpropagates the upstream ``g [n, 4]``
through all 12 layers, returning fp32 weight and bias gradients summed
over all points in the packed operand layout. :func:`unpack_grads` maps
them to the params layout. In bf16 its pass 1 is ``fused_nerf_bwd_wgmma``
(TMA-fed ``wgmma`` with the activations and deltas in registers; launch
plan :func:`bwd_launch_plan`), which reads the input-gradient weights
from :func:`in_out_matrices`, and its weight gradients ``wgrad_wgmma``
(TMA-fed ``wgmma`` on the stashed operands). In fp32 its pass 1 is
``fused_nerf_bwd_ffma`` (true fp32 products on the FFMA pipe in register
micro-tiles, weights streamed by bulk copies; launch plan
:func:`bwd32_launch_plan`), which reads the input-gradient weights from
:func:`out_in_matrices`, and its weight gradients ``wgrad_ffma``.

Gradients flow to the **parameters only**. Sample positions enter the loss
through depths the renderer detaches and ray origins/directions are data,
so d(points) and d(viewdirs) are zero by contract (``None`` from the
autograd function). Pose or ray optimisation would have to extend the
backward.
"""

from __future__ import annotations

import ctypes

import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops.fused_mlp import (FP32_THREADS, SMEM_LIMIT,
                                        FusedNerfWeights, fp32_block_plan,
                                        forward_flops, fused_nerf_apply,
                                        mat_blocks, packed_size)
from cvnerf_torch.utils.kernels import load_library

# Param leaves in the order the autograd function takes them.
LEAVES = tuple((name, part)
               for name in ("l1", "l2", "l3", "l4", "l5", "l6", "l7", "l8",
                            "l9", "alpha", "l10", "l11")
               for part in ("w", "b"))


def backward_flops(cfg: NerfMLPConfig) -> int:
    """FLOP per point of the least backward work: the weight gradient of
    all 12 layers plus the input gradient of every layer but l1 (2 × MACs
    each). The kernel also recomputes the forward, which this omits."""
    w, h = cfg.trunk_width, cfg.head_width
    wgrad = forward_flops(cfg) // 2          # one MAC per weight
    # No input gradient of the encodings (l1, l6's skip part, l10's dirs).
    dgrad = wgrad - 2 * cfg.xyz_dim * w - cfg.dir_dim * h
    return 2 * (wgrad + dgrad)


def _bind_backward(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cvnerf_fused_nerf_backward.argtypes = [p, p, p, p, p, p, p,
                                               ctypes.c_long, p, i, i, i, i,
                                               i, i, p]
    lib.cvnerf_fused_nerf_backward.restype = ctypes.c_int
    lib.cvnerf_fused_nerf_bwd_workspace.argtypes = [i, i, i, i, i, i]
    lib.cvnerf_fused_nerf_bwd_workspace.restype = ctypes.c_long
    lib.cvnerf_fused_nerf_bwd_plan.argtypes = [i, i, i, i, i, i,
                                               ctypes.POINTER(ctypes.c_long)]
    lib.cvnerf_fused_nerf_bwd_plan.restype = ctypes.c_int


def _transposed_blocks(wmat: torch.Tensor, cfg: NerfMLPConfig,
                       rows_are_in: bool) -> torch.Tensor:
    """Every packed block of ``wmat`` transposed, at the same offsets: a
    block stored ``[in, out]`` (``rows_are_in``) becomes ``[out, in]`` and
    the other way round."""
    parts, p = [], 0
    for _, fin, fout in mat_blocks(cfg):
        shape = (fin, fout) if rows_are_in else (fout, fin)
        parts.append(wmat[p:p + fin * fout].reshape(shape).t().reshape(-1))
        p += fin * fout
    return torch.cat(parts)


def out_in_matrices(weights: FusedNerfWeights) -> torch.Tensor:
    """``weights.wmat`` with every block in the ``[out, in]`` layout, which
    the fp32 kernel's input gradients ``d_prev[64, in] = d[64, out] W[out,
    in]`` stream in K-slabs of contiguous ``out`` rows (16-byte aligned:
    every block's size is a multiple of 256 elements). The bf16 packing
    already is; the fp32 one is ``[in, out]`` and is transposed here, block
    by block."""
    if weights.compute_dtype == torch.bfloat16:
        return weights.wmat
    return _transposed_blocks(weights.wmat, weights.cfg, rows_are_in=True)


def in_out_matrices(weights: FusedNerfWeights) -> torch.Tensor:
    """The bf16 packing ``weights.wmat`` with every block transposed to
    ``[in, out]``, at the packing's offsets: the K-major B operand of the
    bf16 kernel's input gradients ``d_prev[64, in] = d[64, out] W[out, in]``
    (``in`` the product's N rows, ``out`` its depth), read by TMA like the
    forward's blocks (each block starts 16-byte aligned and its rows,
    ``out`` wide, are multiples of 16 bytes). Built once per backward call:
    1.19 MB at full width."""
    if weights.compute_dtype != torch.bfloat16:
        raise ValueError("in_out_matrices is the bf16 kernel's operand")
    return _transposed_blocks(weights.wmat, weights.cfg, rows_are_in=False)


# The bf16 backward's pass 1 (csrc/fused_mlp_bwd.cu, fused_nerf_bwd_wgmma):
# the bf16 forward's block (one TMA producer warpgroup and two consumer
# warpgroups of 64 points, one block per SM, at most one per 128-point tile)
# with, beside each consumer warpgroup's encodings and raw inputs, its rows'
# upstream g [64, 4] (fp32) and the ReLU masks of h1..h8 (one 32-bit word a
# thread, 4 words a layer). Points go in chunks of 2^18; each chunk's stash
# holds every weight gradient's operands in bf16 for rows rounded up to the
# tile; weight gradients are split-K partials over about 16,384 points (at
# most 16 a chunk); vector slabs: one per block and one per consumer warp.
_BWD_CHUNK = 1 << 18
_BWD_TILE = 128
_BWD_MASK_BYTES = 8 * 4 * 128 * 4
_SPLIT_POINTS = 16384
_MAX_SPLITS = 16


def _splits(cn: int) -> int:
    return min(max(-(-cn // _SPLIT_POINTS), 1), _MAX_SPLITS)


def _r(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_launch_plan(cfg: NerfMLPConfig, n: int, sm_count: int) -> dict:
    """The bf16 backward's launch for ``n`` points on a card of
    ``sm_count`` SMs, as ``cvnerf_fused_nerf_bwd_plan`` computes it: pass
    1's blocks, threads, dynamic shared-memory bytes and weight stages, the
    stash's rows, the workspace bytes (block and warp vector slabs, split-K
    partials, the stash of one chunk, each 256-byte aligned) and the
    split-K partials over all chunks."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _r(cfg.xyz_dim, 16), _r(cfg.dir_dim, 16)
    stage = _r(w, 64) * 64 * 2
    per_wg = (64 * (kx + 8 + kd + 8) * 2 + 2 * 64 * 3 * 4 + 64 * 4 * 4
              + _BWD_MASK_BYTES)
    stages = min(8, (SMEM_LIMIT - 1024 - 2 * per_wg - 2 * 8 * 8) // stage)
    first = min(n, _BWD_CHUNK)
    blocks = min(-(-first // _BWD_TILE), sm_count)
    rows = _r(first, _BWD_TILE)
    vec = 9 * w + h + w + 3 * h + 8
    vstride, mstride = _r(vec, 64), _r(packed_size(cfg) - vec, 64)
    splits = sum(_splits(min(_BWD_CHUNK, n - p0))
                 for p0 in range(0, n, _BWD_CHUNK))
    stash = rows * (kx + kd + 9 * w + 9 * w + h) * 2
    workspace = (_r(blocks * vstride * 4, 256) + _r(8 * blocks * vstride * 4, 256)
                 + _r(splits * mstride * 4, 256) + _r(stash, 256))
    return {"blocks": blocks, "threads": 384,
            "smem_bytes": 1024 + stages * stage + 2 * per_wg + 2 * stages * 8,
            "stages": stages, "stash_rows": rows,
            "workspace_bytes": workspace, "splits": splits}


# The fp32 backward's pass 1 (csrc/fused_mlp_bwd.cu, fused_nerf_bwd_ffma):
# the fp32 forward's block (eight FFMA consumer warps and one producer warp,
# one block per SM, at most one per 64-point tile, weight stages of 16 rows)
# with, beside the activation buffer and the encodings, the tile's upstream
# g [64, 4] and the ReLU masks of h1..h8 (two 32-bit words a consumer thread
# a layer). Its stash is fp32, its rows rounded up to 64; vector slabs: one
# per block and row of four consumer warps; the weight gradients
# (wgrad_ffma, 128 x 128 output tiles, two blocks an SM) are split-K
# partials as in bf16, their split count raised until the blocks fill
# whole waves.
_BWD32_TILE = 64
_BWD32_OWN = 64 * 4 * 4 + 8 * 2 * 256 * 4
_WGRAD32_TILE = 128
_WGRAD32_PER_SM = 2
_MIN_SPLIT32 = 1024
_MAX_SPLITS32 = 32


def _wgrad32_tiles(cfg: NerfMLPConfig) -> int:
    """Output tiles of the fp32 weight gradients: 128 x 128 tiles of every
    weight block (fan-out x padded fan-in)."""
    return sum(-(-fout // _WGRAD32_TILE) * -(-fin // _WGRAD32_TILE)
               for _, fin, fout in mat_blocks(cfg))


def _splits32(cn: int, cfg: NerfMLPConfig, sm_count: int) -> int:
    """The fp32 weight gradients' split count for a chunk of ``cn`` points
    (``splits32_for``): the least from :func:`_splits` up whose blocks
    (tiles x splits) fill at least 90% of their waves of two blocks an SM,
    with at least 1,024 points a split and at most 32 splits."""
    s0, tiles = _splits(cn), _wgrad32_tiles(cfg)
    slots = _WGRAD32_PER_SM * sm_count
    for s in range(s0, min(cn // _MIN_SPLIT32, _MAX_SPLITS32) + 1):
        blocks = tiles * s
        if blocks * 10 >= -(-blocks // slots) * slots * 9:
            return s
    return s0


def bwd32_launch_plan(cfg: NerfMLPConfig, n: int, sm_count: int) -> dict:
    """The fp32 backward's launch for ``n`` points on a card of
    ``sm_count`` SMs, as ``cvnerf_fused_nerf_bwd_plan`` computes it with
    ``bf16 = 0``: the keys of :func:`bwd_launch_plan`."""
    w, h = cfg.trunk_width, cfg.head_width
    kx, kd = _r(cfg.xyz_dim, 16), _r(cfg.dir_dim, 16)
    stages, smem = fp32_block_plan(cfg, _BWD32_OWN)
    first = min(n, _BWD_CHUNK)
    blocks = min(-(-first // _BWD32_TILE), sm_count)
    rows = _r(first, _BWD32_TILE)
    vec = 9 * w + h + w + 3 * h + 8
    vstride, mstride = _r(vec, 64), _r(packed_size(cfg) - vec, 64)
    splits = sum(_splits32(min(_BWD_CHUNK, n - p0), cfg, sm_count)
                 for p0 in range(0, n, _BWD_CHUNK))
    stash = rows * (kx + kd + 9 * w + 9 * w + h) * 4
    workspace = (_r(2 * blocks * vstride * 4, 256)
                 + _r(splits * mstride * 4, 256) + _r(stash, 256))
    return {"blocks": blocks, "threads": FP32_THREADS, "smem_bytes": smem,
            "stages": stages, "stash_rows": rows,
            "workspace_bytes": workspace, "splits": splits}


def kernel_bwd_plan(cfg: NerfMLPConfig, n: int,
                    compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The plan of :func:`bwd_launch_plan` (bf16) or
    :func:`bwd32_launch_plan` (fp32) as the built kernel computes it on the
    current card."""
    lib = load_library("fused_mlp_bwd", _bind_backward)
    plan = (ctypes.c_long * 7)()
    err = lib.cvnerf_fused_nerf_bwd_plan(n, cfg.trunk_width, cfg.head_width,
                                         cfg.xyz_freqs, cfg.dir_freqs,
                                         int(compute_dtype == torch.bfloat16),
                                         plan)
    if err != 0:
        raise RuntimeError(f"cvnerf_fused_nerf_bwd_plan: CUDA error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes", "stages",
                     "stash_rows", "workspace_bytes", "splits"), plan))


def unpack_grads(flat: torch.Tensor, cfg: NerfMLPConfig,
                 compute_dtype: torch.dtype) -> dict:
    """Packed gradients → params-layout gradients (``w`` is ``[in, out]``,
    ``l6`` is ``[xyz_enc | hidden]``, ``l10`` is ``[feat | dir_enc]``). The
    matrices are ``[out, in]`` when the compute dtype is bf16 and ``[in,
    out]`` in fp32, as the weights were packed; gradients of the encoding
    pad rows are dropped."""
    if flat.shape != (packed_size(cfg),):
        raise ValueError(f"packed gradients must be [{packed_size(cfg)}], got "
                         f"{list(flat.shape)}")
    mats, p = {}, 0
    for name, fin, fout in mat_blocks(cfg):
        blk = flat[p:p + fin * fout]
        p += fin * fout
        mats[name] = (blk.reshape(fout, fin).t()
                      if compute_dtype == torch.bfloat16
                      else blk.reshape(fin, fout))
    w, h = cfg.trunk_width, cfg.head_width

    def take(k):
        nonlocal p
        p += k
        return flat[p - k:p]

    b = [take(w) for _ in range(9)]
    b10, wa, w11, ba, b11 = take(h), take(w), take(3 * h), take(4), take(4)
    xd, dd = cfg.xyz_dim, cfg.dir_dim
    out = {"l1": {"w": mats["l1"][:xd], "b": b[0]}}
    for i in (2, 3, 4, 5, 7, 8, 9):
        out[f"l{i}"] = {"w": mats[f"l{i}"], "b": b[i - 1]}
    out["l6"] = {"w": torch.cat([mats["l6b"][:xd], mats["l6a"]]), "b": b[5]}
    out["alpha"] = {"w": wa[:, None], "b": ba[:1]}
    out["l10"] = {"w": torch.cat([mats["l10a"], mats["l10b"][:dd]]), "b": b10}
    out["l11"] = {"w": w11.reshape(3, h).t(), "b": b11[:3]}
    return {k: {p: t.contiguous() for p, t in out[k].items()}
            for k, _ in LEAVES[::2]}


def fused_nerf_bwd_plain(params: dict, points: torch.Tensor,
                         viewdirs: torch.Tensor, g: torch.Tensor,
                         cfg: NerfMLPConfig,
                         compute_dtype: torch.dtype = torch.float32) -> dict:
    """The plain PyTorch version of the backward kernel, layer by layer
    (the JAX ``_bwd_kernel``'s arithmetic, in the params layout): the
    forward is recomputed with the kernel's cast points, each ReLU mask is
    ``h > 0`` of the rounded activation, each upstream delta is rounded to
    the compute dtype before either product and the bias gradients sum the
    fp32 deltas. Not autograd of :func:`fused_nerf_plain`: autograd would
    round each product's output gradient instead of its input delta."""
    fused_nerf_bwd_plain.calls += 1
    if compute_dtype == torch.bfloat16:
        def rc(x):
            return x.to(torch.bfloat16).float()
    elif compute_dtype == torch.float32:
        def rc(x):
            return x
    else:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    relu = torch.relu
    wt = {k: rc(v["w"].detach().float()) for k, v in params.items()}
    bs = {k: v["b"].detach().float() for k, v in params.items()}
    xd, w = cfg.xyz_dim, cfg.trunk_width
    xe = rc(freq_encode(points.float(), cfg.xyz_freqs))
    de = rc(freq_encode(viewdirs.float(), cfg.dir_freqs))
    g = g.float()

    hs = [rc(relu(xe @ wt["l1"] + bs["l1"]))]
    for i in range(2, 6):
        hs.append(rc(relu(hs[-1] @ wt[f"l{i}"] + bs[f"l{i}"])))
    hs.append(rc(relu(hs[-1] @ wt["l6"][xd:] + xe @ wt["l6"][:xd]
                      + bs["l6"])))
    for i in (7, 8):
        hs.append(rc(relu(hs[-1] @ wt[f"l{i}"] + bs[f"l{i}"])))
    h8 = hs[7]
    feat = rc(h8 @ wt["l9"] + bs["l9"])
    h10 = rc(relu(feat @ wt["l10"][:w] + de @ wt["l10"][w:] + bs["l10"]))

    grads = {}
    d_rgb, d_sig = g[:, :3], g[:, 3:4]
    d_rgb_c, d_sig_c = rc(d_rgb), rc(d_sig)
    grads["l11"] = {"w": h10.t() @ d_rgb_c, "b": d_rgb.sum(0)}
    d = (d_rgb_c @ wt["l11"].t()) * (h10 > 0)
    dc = rc(d)
    grads["l10"] = {"w": torch.cat([feat.t() @ dc, de.t() @ dc]),
                    "b": d.sum(0)}
    d = dc @ wt["l10"][:w].t()                      # l9 has no ReLU
    dc = rc(d)
    grads["l9"] = {"w": h8.t() @ dc, "b": d.sum(0)}
    grads["alpha"] = {"w": h8.t() @ d_sig_c, "b": d_sig.sum(0)}
    d = (dc @ wt["l9"].t() + d_sig_c @ wt["alpha"].t()) * (h8 > 0)
    for i in (8, 7, 6, 5, 4, 3, 2):                 # d is d h_i here
        dc = rc(d)
        h_prev = hs[i - 2]
        wi = wt[f"l{i}"]
        if i == 6:
            grads["l6"] = {"w": torch.cat([xe.t() @ dc, h_prev.t() @ dc]),
                           "b": d.sum(0)}
            wi = wi[xd:]
        else:
            grads[f"l{i}"] = {"w": h_prev.t() @ dc, "b": d.sum(0)}
        d = (dc @ wi.t()) * (h_prev > 0)
    grads["l1"] = {"w": xe.t() @ rc(d), "b": d.sum(0)}
    return {k: grads[k] for k, _ in LEAVES[::2]}


fused_nerf_bwd_plain.calls = 0


def fused_nerf_bwd(weights: FusedNerfWeights, points: torch.Tensor,
                   viewdirs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: packed fp32 gradients ``[packed_size]``
    of the fused MLP at ``points``/``viewdirs`` ``[n, 3]`` for the upstream
    ``g [n, 4]`` (launch count in ``fused_nerf_bwd.launches``). CUDA
    tensors only: the CPU path is :func:`fused_nerf_bwd_plain`."""
    args = (("points", points, 3), ("viewdirs", viewdirs, 3), ("g", g, 4))
    for name, t, width in args:
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name} must be [n, {width}], got "
                             f"{list(t.shape)}")
        if t.shape[0] != points.shape[0]:
            raise ValueError("points, viewdirs and g must have one length")
    for name, t, _ in args:
        if t.device != points.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on the points' "
                             f"device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if weights.wmat is None or weights.device != points.device:
        raise ValueError(f"weights live on {weights.device}, points on "
                         f"{points.device}: pack the weights on the points' "
                         "device")
    cfg = weights.cfg
    n = points.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"n={n} points exceeds the kernel's int32 range")
    size = packed_size(cfg)
    if weights.wmat.numel() + weights.wvec.numel() != size:
        raise ValueError("packed weights do not match the kernel's layout")
    out = torch.empty(size, dtype=torch.float32, device=points.device)
    if n == 0:
        return out.zero_()
    lib = load_library("fused_mlp_bwd", _bind_backward)
    w, h = cfg.trunk_width, cfg.head_width
    lx, ld = cfg.xyz_freqs, cfg.dir_freqs
    bf16 = int(weights.compute_dtype == torch.bfloat16)
    with torch.cuda.device(points.device):
        nbytes = lib.cvnerf_fused_nerf_bwd_workspace(n, w, h, lx, ld, bf16)
        if nbytes <= 0:
            raise RuntimeError(f"fused_nerf_bwd: no launch configuration "
                               f"(CUDA error {-nbytes})")
        # Workspace: the stashed operands of the weight gradients and their
        # per-split fp32 partials, which the kernel sums in a fixed order
        # (no float atomics).
        ws = torch.empty(nbytes, dtype=torch.uint8, device=points.device)
        # Each block transposed: the input gradients' weights.
        wt = in_out_matrices(weights) if bf16 else out_in_matrices(weights)
        if weights.wmat.data_ptr() % 16 or wt.data_ptr() % 16:
            raise ValueError("packed weights must start 16-byte aligned (TMA)")
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.cvnerf_fused_nerf_backward(
            points.data_ptr(), viewdirs.data_ptr(), g.data_ptr(),
            weights.wmat.data_ptr(), wt.data_ptr(), weights.wvec.data_ptr(),
            ws.data_ptr(), nbytes, out.data_ptr(), n, w, h, lx, ld, bf16,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_nerf_bwd kernel launch failed: CUDA error "
                           f"{err}")
    fused_nerf_bwd.launches += 1
    return out


fused_nerf_bwd.launches = 0


class FusedNerfTrainApply(torch.autograd.Function):
    """Differentiable fused encode→MLP with parameters-only gradients.

    Forward: :func:`fused_nerf_apply` (the forward kernel for CUDA tensors,
    :func:`fused_nerf_plain` for CPU tensors) on the params packed once per
    call; no activation is saved. Backward: the backward kernel for CUDA
    tensors, :func:`fused_nerf_bwd_plain` for CPU tensors. The gradients of
    ``points`` and ``viewdirs`` are ``None``: zero by contract (the
    renderer detaches sample depths and rays are data) — NOT correct for
    pose or ray optimisation.
    """

    @staticmethod
    def forward(ctx, points, viewdirs, cfg, compute_dtype, *leaves):
        params = _tree(leaves, detach=True)
        weights = FusedNerfWeights(params, cfg, compute_dtype)
        ctx.save_for_backward(points, viewdirs)
        ctx.weights = weights
        return fused_nerf_apply(weights, points, viewdirs)

    @staticmethod
    def backward(ctx, g):
        points, viewdirs = ctx.saved_tensors
        weights = ctx.weights
        g = g.float().contiguous()
        if points.device.type == "cuda":
            grads = unpack_grads(fused_nerf_bwd(weights, points, viewdirs, g),
                                 weights.cfg, weights.compute_dtype)
        else:
            grads = fused_nerf_bwd_plain(weights.params, points, viewdirs, g,
                                         weights.cfg, weights.compute_dtype)
        return (None, None, None, None,
                *(grads[name][part] for name, part in LEAVES))


def _tree(leaves, detach: bool = False) -> dict:
    out: dict = {}
    for (name, part), t in zip(LEAVES, leaves):
        out.setdefault(name, {})[part] = t.detach() if detach else t
    return out


def fused_nerf_train_apply(params: dict, points: torch.Tensor,
                           viewdirs: torch.Tensor,
                           cfg: NerfMLPConfig = NerfMLPConfig(),
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """``[n, 4]`` raw ``(r, g, b, sigma)`` of one net at ``points`` /
    ``viewdirs`` ``[n, 3]``, differentiable in every leaf of ``params``
    (see :class:`FusedNerfTrainApply`)."""
    return FusedNerfTrainApply.apply(
        points, viewdirs, cfg, compute_dtype,
        *(params[name][part] for name, part in LEAVES))
