"""The port's fused MLP backward (``cvnerf_torch/ops/fused_mlp_bwd.py``)
against the JAX package's Pallas backward kernel.

The same numpy-seeded params, points, view directions and upstream
gradient go through JAX ``jax.vjp`` of ``fused_nerf_train_apply(...,
interpret=True)`` (the Pallas kernel in the interpreter, as
``tests/test_pallas_bwd.py`` runs it) and through the port's plain version
of its CUDA kernel, ``fused_nerf_bwd_plain``. Both compute the same cast
points, so the tolerance is per leaf, relative to the leaf's largest
gradient: 1e-4 in fp32 and 2e-3 in bf16 (the summation order differs,
which can flip a bf16 rounding). The CUDA kernel itself is held against
the plain version on the card (``chip_smoke.py``; the ``cuda`` test here).
"""

import hashlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.ops.pallas.fused_mlp_bwd import \
    fused_nerf_train_apply as jax_train_apply
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.ops import fused_mlp_bwd as fb
from cvnerf_torch.utils.convert import params_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=64, head_width=32)


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 2).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = rng.randn(n, 4).astype(np.float32)
    return pts, dirs, g


def _leaf_errors(got, want):
    return {f"{k}.{p}": float(np.abs(np.asarray(got[k][p])
                                     - np.asarray(want[k][p])).max()
                              / max(np.abs(np.asarray(want[k][p])).max(),
                                    1e-30))
            for k in want for p in ("w", "b")}


def _digest(tree, leaf=None) -> str:
    """sha1 (12 hex digits) of a gradient tree's leaves in sorted order, or
    of one ``"layer.w"`` leaf."""
    h = hashlib.sha1()
    names = [leaf] if leaf else [f"{k}.{q}" for k in sorted(tree)
                                 for q in ("w", "b")]
    for name in names:
        k, q = name.split(".")
        h.update(np.ascontiguousarray(np.asarray(tree[k][q],
                                                 np.float32)).tobytes())
    return h.hexdigest()[:12]


# The digests of both sides' gradients for the three cases, as every run
# of this test gave them on an x86-64 CPU (torch 2.13 with MKL, jax's CPU
# backend) at 1 to 8 torch threads: (torch, jax).
RECORDED = {("tiny", "float32"): ("c23f7c73f223", "3cbb3eab1827"),
            ("tiny", "bfloat16"): ("b1ef21aa1bef", "e0aa3d8e4e6b"),
            ("full", "float32"): ("1cb5df5c37fe", "49bc12090966")}


def _bwd_both(kw, dtype, n):
    """The JAX Pallas backward (interpreted) and the port's plain backward
    of the same numpy-seeded inputs: ``(port grads, jax grads)``."""
    p = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), JaxCfg(**kw)))
    pts, dirs, g = _inputs(n)
    _, vjp = jax.vjp(lambda q: jax_train_apply(
        q, jnp.asarray(pts), jnp.asarray(dirs), JaxCfg(**kw),
        getattr(jnp, dtype), 128, True), p)
    want = jax.tree.map(np.asarray, vjp(jnp.asarray(g))[0])
    got = fb.fused_nerf_bwd_plain(params_from_jax(p), torch.from_numpy(pts),
                                  torch.from_numpy(dirs), torch.from_numpy(g),
                                  NerfMLPConfig(**kw), getattr(torch, dtype))
    return got, want


def _probe(kw, dtype, n, got, want, errs) -> str:
    """The failure's own report: which side moved and in which leaf. Both
    sides are evaluated twice more in this process; every evaluation's
    digest is set beside the recorded one, and the worst leaf's digests of
    the failing evaluation beside those of the first re-evaluation."""
    case = ("full" if not kw else "tiny", dtype)
    worst = max(errs, key=errs.get)
    again = [_bwd_both(kw, dtype, n) for _ in range(2)]
    rec_t, rec_j = RECORDED[case]
    lines = [f"worst leaf {worst}: {errs[worst]:.3e} (all: {errs})",
             f"torch digests {[_digest(got)] + [_digest(a[0]) for a in again]}"
             f" (recorded {rec_t})",
             f"jax digests {[_digest(want)] + [_digest(a[1]) for a in again]}"
             f" (recorded {rec_j})",
             f"leaf {worst}: torch {_digest(got, worst)} then "
             f"{_digest(again[0][0], worst)}, jax {_digest(want, worst)} then "
             f"{_digest(again[0][1], worst)}",
             f"torch threads {torch.get_num_threads()}"]
    return "\n".join(lines)


@pytest.mark.parametrize("kw,dtype,n", [
    (TINY, "float32", 200), (TINY, "bfloat16", 200), ({}, "float32", 200)])
def test_plain_backward_matches_jax_bwd_kernel(kw, dtype, n):
    """On failure the message names the side that moved (see ``_probe``);
    ROADMAP Queue 3 records the one failure this case has shown."""
    got, want = _bwd_both(kw, dtype, n)
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        for q in ("w", "b"):
            assert tuple(got[k][q].shape) == np.asarray(want[k][q]).shape
    errs = _leaf_errors(got, want)
    tol = 1e-4 if dtype == "float32" else 2e-3
    assert max(errs.values()) <= tol, _probe(kw, dtype, n, got, want, errs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_grads_inverts_the_packing(dtype):
    """``unpack_grads`` maps the packed layout of either dtype back to the
    params layout (values representable in bf16, so the packing's cast is
    exact; the encoding pad rows are dropped)."""
    cfg = NerfMLPConfig(**TINY)
    params = {k: {p: torch.round(t * 64) / 64 for p, t in v.items()}
              for k, v in init_nerf_params(PRNGKey(3), cfg).items()}
    wmat, wvec = fm.pack_params(params, cfg, dtype)
    flat = torch.cat([wmat.float(), wvec])
    assert flat.numel() == fm.packed_size(cfg)
    back = fb.unpack_grads(flat, cfg, dtype)
    assert list(back) == list(params)
    for k, v in params.items():
        for p, t in v.items():
            torch.testing.assert_close(back[k][p], t, rtol=0, atol=0)


def test_out_in_matrices_match_the_bf16_packing_layout():
    """The fp32 weights handed to the kernel's input gradients are the
    packed blocks transposed to ``[out, in]``: the bf16 packing's layout
    (values representable in bf16, so both packings hold the same values),
    each block starting at a multiple of 256 elements, so every 16-row
    K-slab the kernel streams starts 16-byte aligned. The bf16 packing is
    passed through unchanged."""
    cfg = NerfMLPConfig(**TINY)
    params = {k: {p: torch.round(t * 64) / 64 for p, t in v.items()}
              for k, v in init_nerf_params(PRNGKey(8), cfg).items()}
    wmat32, _ = fm.pack_params(params, cfg, torch.float32)
    wmat16, _ = fm.pack_params(params, cfg, torch.bfloat16)
    as32 = SimpleNamespace(wmat=wmat32, cfg=cfg, compute_dtype=torch.float32)
    as16 = SimpleNamespace(wmat=wmat16, cfg=cfg, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(fb.out_in_matrices(as32), wmat16.float(),
                               rtol=0, atol=0)
    assert fb.out_in_matrices(as16) is wmat16
    start = 0
    for _, fan_in, fan_out in fm.mat_blocks(cfg):
        assert start % 256 == 0
        start += fan_in * fan_out


def test_autograd_function_on_cpu_is_the_plain_backward():
    """Through ``FusedNerfTrainApply`` on CPU tensors: the forward is the
    forward kernel's plain version, the backward ``fused_nerf_bwd_plain``
    (exactly), and points/viewdirs get no gradient (zero by contract)."""
    cfg = NerfMLPConfig(**TINY)
    params = init_nerf_params(PRNGKey(4), cfg)
    pts, dirs, g = map(torch.from_numpy, _inputs(150, seed=1))
    pts.requires_grad_()
    leaves = {k: {p: t.clone().requires_grad_() for p, t in v.items()}
              for k, v in params.items()}
    plain_fwd = fm.fused_nerf_plain.calls
    plain_bwd = fb.fused_nerf_bwd_plain.calls
    out = fb.fused_nerf_train_apply(leaves, pts, dirs, cfg, torch.bfloat16)
    torch.testing.assert_close(
        out, fm.fused_nerf_plain(params, pts.detach(), dirs, cfg,
                                 torch.bfloat16), rtol=0, atol=0)
    grads = torch.autograd.grad((out * g).sum(),
                                [pts] + [t for v in leaves.values()
                                         for t in v.values()],
                                allow_unused=True)
    assert grads[0] is None
    want = fb.fused_nerf_bwd_plain(params, pts.detach(), dirs, g, cfg,
                                   torch.bfloat16)
    flat_want = [t for v in want.values() for t in v.values()]
    for a, b in zip(grads[1:], flat_want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fm.fused_nerf_plain.calls == plain_fwd + 2
    assert fb.fused_nerf_bwd_plain.calls == plain_bwd + 2


def test_gradients_of_two_halves_sum_to_the_whole():
    """Gradients are sums over points: the two halves of a batch add up to
    the whole batch (1e-5 of each leaf's scale, fp32 summation order)."""
    cfg = NerfMLPConfig(**TINY)
    params = init_nerf_params(PRNGKey(5), cfg)
    pts, dirs, g = map(torch.from_numpy, _inputs(301, seed=2))
    whole = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg)
    a = fb.fused_nerf_bwd_plain(params, pts[:150], dirs[:150], g[:150], cfg)
    b = fb.fused_nerf_bwd_plain(params, pts[150:], dirs[150:], g[150:], cfg)
    summed = {k: {p: a[k][p] + b[k][p] for p in v} for k, v in a.items()}
    assert max(_leaf_errors(summed, whole).values()) <= 1e-5


def test_kernel_wrapper_refuses_cpu_tensors():
    cfg = NerfMLPConfig(**TINY)
    params = init_nerf_params(PRNGKey(6), cfg)
    pts, dirs, g = map(torch.from_numpy, _inputs(10))
    w = fm.FusedNerfWeights(params, cfg, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb.fused_nerf_bwd(w, pts, dirs, g)
    with pytest.raises(ValueError, match=r"\[n, 4\]"):
        fb.fused_nerf_bwd(w, pts, dirs, g[:, :3])


def test_backward_flops_count_the_least_work():
    """wgrad of all 12 layers (= the forward's MACs) plus dgrad of all but
    l1 (no input gradient for the encodings): 2,302,208 FLOP per point at
    full width, 1.94x the forward."""
    cfg = NerfMLPConfig()
    assert fm.forward_flops(cfg) == 1_186_816
    assert fb.backward_flops(cfg) == 2_302_208


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version (per leaf 1e-2 fp32, 2e-2
    bf16 at n = 5,000: ``chip_smoke.py`` phase 1b's tolerances; see there
    for why) and bitwise against a second launch. Needs an NVIDIA card and
    nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run chip_smoke.py there")
    cfg = NerfMLPConfig()
    params = init_nerf_params(PRNGKey(7), cfg, "cuda")
    pts, dirs, g = (torch.from_numpy(x).cuda() for x in _inputs(5000))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, tol in ((torch.float32, 1e-2), (torch.bfloat16, 2e-2)):
        w = fm.FusedNerfWeights(params, cfg, dtype)
        first = fb.fused_nerf_bwd(w, pts, dirs, g)
        assert torch.equal(first, fb.fused_nerf_bwd(w, pts, dirs, g))
        host = (fb.bwd_launch_plan if dtype == torch.bfloat16
                else fb.bwd32_launch_plan)(cfg, 5000, sms)
        assert fb.kernel_bwd_plan(cfg, 5000, dtype) == host
        want = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg, dtype)
        errs = _leaf_errors({k: {p: t.cpu() for p, t in v.items()} for k, v in
                             fb.unpack_grads(first, cfg, dtype).items()},
                            {k: {p: t.cpu() for p, t in v.items()}
                             for k, v in want.items()})
        assert max(errs.values()) <= tol, errs


# ------------------------------------------------ the bf16 kernel's layout
_WIDTHS = [(w, h) for w in range(16, 257, 16) for h in range(16, w + 1, 16)]
_BANDS = [(lx, ld) for lx in (0, 4, 10, 20) for ld in (0, 2, 4, 20)]


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_bwd_launch_plan_fits_every_accepted_width(trunk):
    """The bf16 backward's pass 1 (weight stages + encodings + g + ReLU
    masks + barriers) fits a block on sm_90 with at least three ring
    stages, for every width and band count the kernel accepts."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            fm.check_kernel_config(cfg)
            plan = fb.bwd_launch_plan(cfg, 1000, 132)
            assert 3 <= plan["stages"] <= 8, (cfg, plan)
            assert plan["smem_bytes"] <= fm.SMEM_LIMIT, (cfg, plan)
            assert plan["threads"] == 384


def test_bwd_launch_plan_grid_rows_and_workspace():
    """One block per 128-point tile of the first chunk, at most one per SM;
    stash rows rounded up to the tile; the workspace is the block and warp
    vector slabs, the split-K partials and the stash of one chunk."""
    cfg = NerfMLPConfig()
    for n, sms, blocks, rows in ((1, 132, 1, 128), (127, 132, 1, 128),
                                 (129, 132, 2, 128 * 2),
                                 (132 * 128 + 1, 132, 132, 133 * 128),
                                 (65_573, 114, 114, 513 * 128),
                                 (1024 * 192, 132, 132, 1024 * 192),
                                 (2 ** 18 + 2 ** 15 + 37, 132, 132, 2 ** 18)):
        plan = fb.bwd_launch_plan(cfg, n, sms)
        assert plan["blocks"] == min(-(-min(n, 2 ** 18) // 128), sms), n
        assert (plan["blocks"], plan["stash_rows"]) == (blocks, rows), n
    # Full width: 5 stages of 256 rows x 128 B beside each warpgroup's
    # encodings (64 + 32 wide, rows padded by 8), raw inputs, g and masks.
    plan = fb.bwd_launch_plan(cfg, 1024 * 192, 132)
    per_wg = 64 * (72 + 40) * 2 + 64 * 6 * 4 + 64 * 4 * 4 + 8 * 4 * 128 * 4
    assert plan["stages"] == 5
    assert plan["smem_bytes"] == 1024 + 5 * 32768 + 2 * per_wg + 10 * 8
    # 9,664 B a point of stash: encodings 64 + 32, h1..h8 and feat 9 x 256,
    # deltas 9 x 256 + 128, in bf16.
    w, h = 256, 128
    vec = 10 * w + 4 * h + 8      # 3,080 floats, slab stride rounded to 64
    mat = fb.packed_size(cfg) - vec
    splits = 12                   # ceil(196,608 / 16,384)
    assert plan["splits"] == splits
    assert plan["workspace_bytes"] == (
        132 * 3136 * 4 + 8 * 132 * 3136 * 4 + splits * mat * 4
        + 1024 * 192 * 9_664)
    # Two chunks: 16 partials (capped) of the first, 3 of the second.
    assert fb.bwd_launch_plan(cfg, 2 ** 18 + 2 ** 15 + 37, 132)["splits"] == 19


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_bwd32_launch_plan_fits_every_accepted_width(trunk):
    """The fp32 backward's pass 1 (weight stages + activation buffer +
    encodings + raw inputs + g + ReLU masks + barriers) fits a block on
    sm_90 with at least three ring stages, for every width and band count
    the kernel accepts."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            plan = fb.bwd32_launch_plan(cfg, 1000, 132)
            assert 3 <= plan["stages"] <= 8, (cfg, plan)
            assert plan["smem_bytes"] <= fm.SMEM_LIMIT, (cfg, plan)
            assert plan["threads"] == 288


def test_bwd32_launch_plan_grid_rows_and_workspace():
    """One block per 64-point tile of the first chunk, at most one per SM;
    stash rows rounded up to the tile; the workspace is two vector slabs a
    block (one per row of four consumer warps), the split-K partials and
    the fp32 stash of one chunk."""
    cfg = NerfMLPConfig()
    for n, sms, blocks, rows in ((1, 132, 1, 64), (63, 132, 1, 64),
                                 (65, 132, 2, 128),
                                 (132 * 64 + 1, 132, 132, 133 * 64),
                                 (65_573, 114, 114, 1025 * 64),
                                 (1024 * 192, 132, 132, 1024 * 192),
                                 (2 ** 18 + 2 ** 15 + 37, 132, 132, 2 ** 18)):
        plan = fb.bwd32_launch_plan(cfg, n, sms)
        assert (plan["blocks"], plan["stash_rows"]) == (blocks, rows), n
    # Full width: 7 stages of 16 rows x 256 fp32 beside the activation
    # buffer [256, 64], the encodings [64 + 32, 64], the raw inputs, g
    # [64, 4] and the masks of h1..h8 (2 words a thread a layer).
    plan = fb.bwd32_launch_plan(cfg, 1024 * 192, 132)
    assert plan["stages"] == 7
    assert plan["smem_bytes"] == (7 * 16 * 256 * 4 + (256 + 96) * 64 * 4
                                  + 64 * 6 * 4 + 64 * 4 * 4
                                  + 8 * 2 * 256 * 4 + 14 * 8)
    # 19,328 B a point of fp32 stash: encodings 64 + 32, h1..h8 and feat
    # 9 x 256, deltas 9 x 256 + 128.
    mat = fb.packed_size(cfg) - 3080
    assert plan["splits"] == 13
    assert plan["workspace_bytes"] == (2 * 132 * 3136 * 4 + 13 * mat * 4
                                       + 1024 * 192 * 19_328)


def test_fp32_wgrad_splits_fill_their_waves():
    """The fp32 weight gradients' 39 output tiles (128 x 128, full width)
    times the split count fill at least 90% of their waves of 2 x 132
    blocks, from the bf16 path's split count up (one split a 16,384
    points), with at least 1,024 points a split and at most 32 splits; a
    chunk too small for that keeps the bf16 count."""
    cfg = NerfMLPConfig()
    assert fb._wgrad32_tiles(cfg) == 39
    for cn, want in ((65_573, 13), (65_536, 13), (196_608, 13),
                     (2 ** 18, 19), (32_805, 13), (5_000, 1), (1, 1)):
        s = fb._splits32(cn, cfg, 132)
        assert s == want, (cn, s)
        assert s >= fb._splits(cn)
        if s > fb._splits(cn):
            blocks = 39 * s
            assert blocks * 10 >= -(-blocks // 264) * 264 * 9
            assert cn // s >= 1024
    # Two chunks: 19 partials of the first, 13 of the second.
    assert fb.bwd32_launch_plan(cfg, 2 ** 18 + 2 ** 15 + 37, 132)[
        "splits"] == 32


def _ffma_thread(tid):
    """(pg, cg) of consumer thread tid (csrc/nerf_ffma.cuh ``thr``)."""
    warp, lane = divmod(tid, 32)
    return 4 * (warp >> 2) + (lane >> 3), 8 * (warp & 3) + (lane & 7)


@pytest.mark.parametrize("width", range(16, 257, 16))
def test_fp32_relu_mask_bit_written_is_the_bit_read(width):
    """The fp32 pass 1 keeps h_l > 0 for the thread's micro-tile (point i,
    column j) at bit 8 (i % 4) + j of word i / 4 of its own slot
    (keep_mask32), and the input-gradient epilogue of d h_l, whose micro-
    tile covers the same (point, column) (the same thread map, the output
    width = h_l's), reads the same bit (apply_mask32). Every (point,
    column) of a layer ``width`` wide has one bit, within 2 words a
    thread, and with one column chunk (NCH = 1, the lego head) the bits of
    the second chunk stay unused."""
    for nch in ((1, 2) if width <= 128 else (2,)):
        written = {}
        for tid in range(256):
            pg, cg = _ffma_thread(tid)
            for i in range(8):
                for j in range(4 * nch):
                    col = 4 * cg + (j & 3) + 128 * (j >> 2)
                    if col >= width:
                        continue
                    point = 4 * pg + (i & 3) + 32 * (i >> 2)
                    word, bit = i >> 2, 8 * (i & 3) + j
                    assert bit < 32
                    slot = (word, tid, bit)
                    assert slot not in written.values()
                    written[(point, col)] = slot
        assert sorted(written) == [(p, c) for p in range(64)
                                   for c in range(width)]
        for tid in range(256):   # the reading thread finds its own bits
            pg, cg = _ffma_thread(tid)
            for i in range(8):
                for j in range(4 * nch):
                    col = 4 * cg + (j & 3) + 128 * (j >> 2)
                    if col < width:
                        point = 4 * pg + (i & 3) + 32 * (i >> 2)
                        assert written[(point, col)] == (
                            i >> 2, tid, 8 * (i & 3) + j)


@pytest.mark.parametrize("width", [16, 48, 128, 256])
def test_fp32_column_sums_count_every_point_once(width):
    """``col_sums32``: each thread sums its 8 points of a column, the xor
    8 and 16 shuffles add the 4 lanes of the warp that share the column
    group, lanes 0-7 add that to their warp row's slab, and the two warp
    rows' slabs are summed at the end (reduce_slabs): each column's bias
    gradient counts every point of the tile exactly once."""
    counted = {}
    for warp in range(8):
        lanes = {}
        for lane in range(32):
            pg, cg = _ffma_thread(32 * warp + lane)
            for j in range(8):
                col = 4 * cg + (j & 3) + 128 * (j >> 2)
                pts = [4 * pg + (i & 3) + 32 * (i >> 2) for i in range(8)]
                lanes[(lane, j)] = (col, pts)
        for lane in range(8):                       # the writers
            for j in range(8):
                col, pts = lanes[(lane, j)]
                if col >= width:
                    continue
                for m in (0, 8, 16, 24):             # xor 8, 16 partners
                    other_col, other = lanes[(lane ^ m, j)]
                    assert other_col == col
                    for p in other:
                        counted[(p, col)] = counted.get((p, col), 0) + 1
    assert counted == {(p, c): 1 for p in range(64) for c in range(width)}


def test_in_out_matrices_transpose_every_bf16_block():
    """``in_out_matrices`` is the bf16 packing with every block ``[out,
    in]`` transposed to ``[in, out]`` at the packing's offsets, each a TMA
    tensor (16-byte aligned start, rows of 16-byte multiples); it takes
    only the bf16 packing."""
    for kw in (TINY, {}, dict(xyz_freqs=0, dir_freqs=20, trunk_width=48,
                              head_width=16)):
        cfg = NerfMLPConfig(**kw)
        params = init_nerf_params(PRNGKey(9), cfg)
        wmat, _ = fm.pack_params(params, cfg, torch.bfloat16)
        w = SimpleNamespace(wmat=wmat, cfg=cfg, compute_dtype=torch.bfloat16)
        t = fb.in_out_matrices(w)
        assert t.dtype == torch.bfloat16 and t.shape == wmat.shape
        start = 0
        for name, fan_in, fan_out in fm.mat_blocks(cfg):
            size = fan_in * fan_out
            blk = wmat[start:start + size].reshape(fan_out, fan_in)
            torch.testing.assert_close(
                t[start:start + size].reshape(fan_in, fan_out), blk.t(),
                rtol=0, atol=0)
            assert (start * 2) % 16 == 0 and (fan_out * 2) % 16 == 0, name
            assert fan_in <= 256, name       # one TMA box of rows
            start += size
    with pytest.raises(ValueError, match="bf16"):
        fb.in_out_matrices(SimpleNamespace(wmat=wmat.float(), cfg=cfg,
                                           compute_dtype=torch.float32))


def _pos_bits(p):
    """``pos_bits`` of csrc/fused_mlp_bwd.cu on a packed bf16 pair (uint32):
    bit 0 the low half > 0, bit 1 the high half > 0."""
    lo = int(((p & 0xFFFF) - 1) % 2 ** 32 < 0x7FFF)
    signed = p - 2 ** 32 if p >= 2 ** 31 else p
    return lo | (int(signed > 0xFFFF) << 1)


def test_relu_bits_are_bf16_greater_than_zero():
    """The kernel's integer test of a packed pair agrees with ``> 0`` on
    every bf16 value in either half but NaN (zero, minus zero, subnormals,
    inf, negatives). A ReLU output is never NaN (``fmaxf(NaN, 0)`` is 0),
    and only ReLU outputs are tested."""
    halves = torch.arange(2 ** 16, dtype=torch.int32)
    vals = halves.to(torch.int16).view(torch.bfloat16).float()
    positive = (vals > 0).tolist()
    for i, h in enumerate(halves.tolist()):
        if vals[i].isnan():
            continue
        assert _pos_bits(h) & 1 == positive[i], h            # low half
        assert _pos_bits(h << 16) >> 1 == positive[i], h     # high half
        assert _pos_bits((h << 16) | 0x3F80) == (1 | (positive[i] << 1))


def _acc_at(tid, i):
    """(row, col) of register i of an m64nNk16 accumulator in thread tid of
    a warpgroup (hopper.cuh): row 16 warp + lane/4 + 8 (i/2 % 2), column
    8 (i/4) + 2 (lane%4) + i%2."""
    warp, lane = divmod(tid, 32)
    return (16 * warp + lane // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


def _frag_at(tid, k16, r, e):
    """(row, col) of half e of A-fragment register a[k16][r] as
    ``load_frags`` reads it (nerf_wgmma.cuh), and as ``stash_frags``
    stores it: r = 0, 1 rows lane/4 and + 8 at k0 = 16 k16 + 2 (lane%4),
    r = 2, 3 the same rows at k0 + 8."""
    warp, lane = divmod(tid, 32)
    return (16 * warp + lane // 4 + 8 * (r % 2),
            16 * k16 + 2 * (lane % 4) + 8 * (r // 2) + e)


@pytest.mark.parametrize("width", range(16, 257, 16))
def test_relu_mask_bit_written_is_the_bit_read(width):
    """The fragment walk of the bf16 backward for a layer ``width`` wide
    (h1..h8 at the trunk width, h10 at the head width), every thread of a
    warpgroup: ``epilogue`` packs accumulator registers 8c + 2k + e into
    a[c][k] half e, which is the A fragment and the stash element at the
    same (row, col); ``keep_mask`` writes that element's bit at 8c + 2k + e;
    the input-gradient epilogue reads bit 8c + j for register 8c + j of the
    accumulator of d h, which has the same layout. So every (row, col) reads
    back the bit written for it, by the same thread, within the 128 bits (4
    words) a thread keeps."""
    owner, written = {}, {}
    for tid in range(128):
        for c in range(width // 16):
            for k in range(4):
                for e in range(2):
                    reg = 8 * c + 2 * k + e           # epilogue's packing
                    rc = _acc_at(tid, reg)
                    assert _frag_at(tid, c, k, e) == rc
                    bit = 8 * (c % 4) + 2 * k + e + 32 * (c // 4)
                    assert bit < 128
                    assert rc not in written
                    owner[rc], written[rc] = tid, bit
    assert sorted(written) == [(r, col) for r in range(64)
                               for col in range(width)]
    for tid in range(128):
        for c in range(width // 16):
            for j in range(8):                        # delta_epilogue
                rc = _acc_at(tid, 8 * c + j)
                assert owner[rc] == tid
                assert written[rc] == 32 * (c // 4) + 8 * (c % 4) + j
            for h in range(2):                        # d h10 at h10
                for r in range(2):
                    for e in range(2):
                        rc = _acc_at(tid, 8 * c + 4 * h + 2 * r + e)
                        assert rc == _frag_at(tid, c, 2 * h + r, e)


@pytest.mark.parametrize("width", [16, 48, 128, 256])
def test_column_sums_reduce_over_every_row_of_the_warp(width):
    """``col_sums``: each thread first adds its two rows (registers
    8c + 4h + e and + 2), then a reduce-scatter over lane bits 16, 8, 4
    leaves lane l with the sum over all 16 rows of the warp of column
    32 b + 16 l4 + 8 l3 + 2 (l%4) + l2, each row counted once."""
    for b in range(-(-width // 32)):
        s = []
        for lane in range(32):
            vals = []
            for i in range(8):
                c, h, e = 2 * b + i // 4, (i // 2) % 2, i % 2
                terms = set()
                if c * 16 < width:
                    for reg in (8 * c + 4 * h + e, 8 * c + 4 * h + 2 + e):
                        terms.add(_acc_at(lane, reg))
                vals.append(frozenset(terms))
            s.append(vals)
        for m, half in ((16, 4), (8, 2), (4, 1)):
            new = []
            for lane in range(32):
                up = bool(lane & m)
                mine, other = s[lane], s[lane ^ m]
                # keep one half, add the partner's send: the same half
                new.append([(mine[i + half] if up else mine[i])
                            | (other[i + half] if up else other[i])
                            for i in range(half)])
            s = new
        for lane in range(32):
            v = lane // 4
            col = 32 * b + 16 * (v >> 2) + 8 * ((v >> 1) & 1) + 2 * (lane % 4) \
                + (v & 1)
            want = {(r, col) for r in range(16)} if col < width else set()
            assert s[lane][0] == want, (lane, col)



@pytest.mark.parametrize("width", [16, 48, 128, 256])
def test_stash_stores_put_every_element_in_its_place(width):
    """``stash_frags``: per 16-column group each quad transposes its four
    fragment registers in two shuffle rounds (lane bit 0 with register bit
    0, then bit 1 with bit 1), and lane q stores its four registers as 16
    contiguous bytes at row lane/4 + 8 (q & 1), column 16 c + 8 (q >> 1).
    Walked for one warp (the others differ by 16 rows): each stored pair
    of bf16 is the pair of the (row, column) it is stored at, and the
    stores cover every element of the warp's 16 rows once."""
    stored = {}
    for c in range(width // 16):
        regs = [[frozenset({_frag_at(lane, c, k, 0), _frag_at(lane, c, k, 1)})
                 for k in range(4)] for lane in range(32)]
        for bit, pairs in ((1, ((0, 1), (2, 3))), (2, ((0, 2), (1, 3)))):
            new = [r[:] for r in regs]
            for lane in range(32):
                up = bool(lane & bit)
                other = regs[lane ^ bit]
                for lo, hi in pairs:   # keep one slot, take the partner's other
                    if up:
                        new[lane][lo] = other[hi]
                    else:
                        new[lane][hi] = other[lo]
            regs = new
        for lane in range(32):
            q = lane % 4
            row = lane // 4 + 8 * (q & 1)
            for j in range(4):
                col = 16 * c + 8 * (q >> 1) + 2 * j
                assert regs[lane][j] == {(row, col), (row, col + 1)}, \
                    (c, lane, j)
                stored[(row, col)] = stored.get((row, col), 0) + 1
    assert stored == {(r, col): 1 for r in range(16)
                      for col in range(0, width, 2)}
