"""The port's fused encode→MLP module against the JAX fused kernel.

On the CPU the wrapper runs its plain version, which is held against JAX
``fused_nerf_apply(interpret=True)`` (the Pallas kernel in the interpreter)
at the tolerances of ``tests/test_pallas.py``: fp32 2e-4, bf16 0.15
max-abs. The kernel's operand packing is checked here by evaluating the MLP
straight from the packed buffers with the CUDA kernel's offsets; the kernel
itself runs only on a card (the ``cuda``-marked test, and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.ops.pallas.fused_mlp import _forward_flops
from cvnerf_tpu.ops.pallas.fused_mlp import fused_nerf_apply as jax_fused
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.utils.convert import params_from_jax

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=64, head_width=32)


def _inputs(n, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32) * 2
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


def _jax_params(cfg):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_matches_jax_fused_kernel(dtype):
    jcfg, tcfg = JaxCfg(**TINY), NerfMLPConfig(**TINY)
    jp = _jax_params(jcfg)
    n = 300   # not a tile multiple
    pts, dirs = _inputs(n)
    want = np.asarray(jax_fused(jp, jnp.asarray(pts), jnp.asarray(dirs), jcfg,
                                compute_dtype=getattr(jnp, dtype), tile=128,
                                interpret=True))
    w = fm.FusedNerfWeights(params_from_jax(jp), tcfg, getattr(torch, dtype))
    launches = fm.fused_nerf_apply.launches
    got = fm.fused_nerf_apply(w, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert fm.fused_nerf_apply.launches == launches   # CPU: no kernel launch
    assert got.shape == (n, 4) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(got.numpy() - want).max() < 0.15


def test_forward_flops_matches_jax():
    for kw in ({}, TINY):
        assert fm.forward_flops(NerfMLPConfig(**kw)) == _forward_flops(
            JaxCfg(**kw))
    assert fm.forward_flops(NerfMLPConfig()) == 1_186_816


def _kernel_from_packed(wmat, wvec, cfg, dtype, pts, dirs):
    """The kernel's arithmetic, read from its packed operands with the
    offsets of ``csrc/fused_mlp.cu`` (``offsets``), on the CPU."""
    W, H = cfg.trunk_width, cfg.head_width
    kx = -(-cfg.xyz_dim // 16) * 16
    kd = -(-cfg.dir_dim // 16) * 16
    shapes = ([(W, kx)] + [(W, W)] * 5 + [(W, kx)] + [(W, W)] * 3
              + [(H, W), (H, kd)])                # [out, in] of each matrix
    mats, p = [], 0
    for out, inn in shapes:
        flat = wmat[p:p + out * inn].float()
        p += out * inn
        mats.append(flat.reshape(out, inn).t() if dtype == torch.bfloat16
                    else flat.reshape(inn, out))   # → [in, out]
    assert p == wmat.numel()
    w1, w2, w3, w4, w5, w6a, w6b, w7, w8, w9, w10a, w10b = mats
    q = 0

    def take(k):
        nonlocal q
        q += k
        return wvec[q - k:q]
    b = [take(W) for _ in range(9)]
    b10, wa, w11 = take(H), take(W), take(3 * H).reshape(3, H)
    ba, b11 = take(4), take(4)
    assert q == wvec.numel()

    def cast(x):
        return x.to(dtype).float()

    def pad(x, k):
        return torch.cat([x, x.new_zeros(x.shape[0], k - x.shape[1])], 1)
    ex = cast(pad(freq_encode(pts, cfg.xyz_freqs), kx))
    ed = cast(pad(freq_encode(dirs, cfg.dir_freqs), kd))
    h = cast(torch.relu(ex @ w1 + b[0]))
    for wk, bk in ((w2, b[1]), (w3, b[2]), (w4, b[3]), (w5, b[4])):
        h = cast(torch.relu(h @ wk + bk))
    h = cast(torch.relu(h @ w6a + ex @ w6b + b[5]))
    h = cast(torch.relu(h @ w7 + b[6]))
    h8 = cast(torch.relu(h @ w8 + b[7]))
    sigma = h8 @ wa + ba[0]
    feat = cast(h8 @ w9 + b[8])
    h10 = cast(torch.relu(feat @ w10a + ed @ w10b + b10))
    rgb = h10 @ w11.t() + b11[:3]
    return torch.cat([rgb, sigma[:, None]], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [TINY, {}])
def test_packed_operands_reproduce_the_plain_version(kw, dtype):
    cfg = NerfMLPConfig(**kw)
    params = init_nerf_params(PRNGKey(3), cfg)
    wmat, wvec = fm.pack_params(params, cfg, dtype)
    assert wmat.dtype == dtype and wvec.dtype == torch.float32
    pts, dirs = (torch.from_numpy(a) for a in _inputs(130, seed=4))
    got = _kernel_from_packed(wmat, wvec, cfg, dtype, pts, dirs)
    want = fm.fused_nerf_plain(params, pts, dirs, cfg, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got - want).abs().max() < tol


def test_wrapper_rejects_bad_inputs():
    cfg = NerfMLPConfig(**TINY)
    w = fm.FusedNerfWeights(init_nerf_params(PRNGKey(0),
                                             cfg), cfg, torch.float32)
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        fm.fused_nerf_apply(w, torch.zeros(4, 2), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="same length"):
        fm.fused_nerf_apply(w, torch.zeros(4, 3), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        fm.fused_nerf_apply(w, torch.zeros(4, 3, device="meta"),
                            torch.zeros(4, 3, device="meta"))


@pytest.mark.parametrize("kw", [dict(trunk_width=40, head_width=16),
                                dict(trunk_width=512, head_width=128),
                                dict(trunk_width=64, head_width=128)])
def test_kernel_refuses_architectures_it_does_not_take(kw):
    cfg = NerfMLPConfig(**kw)
    params = init_nerf_params(PRNGKey(0), cfg)
    with pytest.raises(ValueError, match="kernels='off'"):
        fm.pack_params(params, cfg, torch.bfloat16)


# Every width check_kernel_config accepts: trunk/head multiples of 16 with
# head <= trunk <= 256, at most 20 bands (the encodings' padded widths go in
# steps of 16 with the bands, so the extremes and a middle cover them).
_WIDTHS = [(w, h) for w in range(16, 257, 16) for h in range(16, w + 1, 16)]
_BANDS = [(lx, ld) for lx in (0, 4, 10, 20) for ld in (0, 2, 4, 20)]


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_packed_blocks_are_tma_tensors(trunk):
    """Each packed bf16 matrix is read by TMA as a [fan-out, fan-in] tensor:
    it must start 16-byte aligned and its rows must be 16-byte multiples."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            fm.check_kernel_config(cfg)
            start = 0
            for name, fan_in, fan_out in fm.mat_blocks(cfg):
                assert (start * 2) % 16 == 0, (cfg, name)
                assert (fan_in * 2) % 16 == 0, (cfg, name)
                assert fan_out <= 256, (cfg, name)   # one TMA box of rows
                start += fan_in * fan_out


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_bf16_launch_plan_fits_every_accepted_width(trunk):
    """The wgmma kernel's shared memory (weight stages + encodings +
    barriers) fits a block on sm_90 with at least two stages, for every
    width the kernel accepts."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            plan = fm.bf16_launch_plan(cfg, 1000, 132)
            assert 2 <= plan["stages"] <= 8, (cfg, plan)
            assert plan["smem_bytes"] <= fm.SMEM_LIMIT, (cfg, plan)
            assert plan["threads"] == 384


def test_bf16_launch_plan_full_width_and_grid():
    cfg = NerfMLPConfig()
    plan = fm.bf16_launch_plan(cfg, 8192 * 192, 132)
    # 6 stages of 256 rows x 128 B, encodings of 128 points (64 + 32 wide,
    # each row padded by 8) and their raw inputs (fp32, 6 a point), 12
    # barriers, 1024 B of alignment slack.
    assert plan == {"blocks": 132, "threads": 384, "stages": 6, "fixed": 1,
                    "smem_bytes": 1024 + 6 * 32768 + 2 * 64 * (72 + 40) * 2
                    + 128 * 6 * 4 + 12 * 8}
    # Other bands or widths read their widths at run time.
    for kw in (dict(xyz_freqs=12), dict(head_width=256), TINY):
        assert fm.bf16_launch_plan(NerfMLPConfig(**kw), 1, 132)["fixed"] == 0
    # One block per 128-point tile, at most one per SM (persistent grid).
    for n, blocks in ((1, 1), (127, 1), (128, 1), (129, 2),
                      (132 * 128, 132), (132 * 128 + 1, 132), (65_573, 132),
                      (1000 * 128, 132)):
        assert fm.bf16_launch_plan(cfg, n, 132)["blocks"] == blocks, n
    assert fm.bf16_launch_plan(cfg, 10_000, 114)["blocks"] == 79


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_fp32_launch_plan_fits_every_accepted_width(trunk):
    """The FFMA kernel's shared memory (weight stages + activation buffer +
    encodings + raw inputs + head partials + barriers) fits a block on
    sm_90 with at least three stages, for every width the kernel accepts."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            plan = fm.fp32_launch_plan(cfg, 1000, 132)
            assert 3 <= plan["stages"] <= 8, (cfg, plan)
            assert plan["smem_bytes"] <= fm.SMEM_LIMIT, (cfg, plan)
            assert plan["threads"] == 288


def test_fp32_launch_plan_full_width_and_grid():
    cfg = NerfMLPConfig()
    plan = fm.fp32_launch_plan(cfg, 8192 * 192, 132)
    # 8 stages of 16 rows x 256 fp32, the activation buffer [256, 64], the
    # encodings [64 + 32, 64], the raw inputs [64 x 6], the head partials
    # [4, 64, 4] (all fp32) and 16 barriers.
    assert plan == {"blocks": 132, "threads": 288, "stages": 8, "fixed": 1,
                    "smem_bytes": 8 * 16 * 256 * 4 + 256 * 64 * 4
                    + 96 * 64 * 4 + 64 * 6 * 4 + 4 * 64 * 4 * 4 + 16 * 8}
    # Other bands or widths read their widths at run time; the widest bands
    # still leave five stages.
    for kw in (dict(xyz_freqs=12), dict(head_width=256), TINY):
        assert fm.fp32_launch_plan(NerfMLPConfig(**kw), 1, 132)["fixed"] == 0
    assert fm.fp32_launch_plan(NerfMLPConfig(xyz_freqs=20, dir_freqs=20), 1,
                               132)["stages"] == 5
    # One block per 64-point tile, at most one per SM (persistent grid).
    for n, blocks in ((1, 1), (63, 1), (64, 1), (65, 2), (132 * 64, 132),
                      (132 * 64 + 1, 132), (65_573, 132)):
        assert fm.fp32_launch_plan(cfg, n, 132)["blocks"] == blocks, n
    assert fm.fp32_launch_plan(cfg, 3_000, 114)["blocks"] == 47


def _ffma_thread(tid):
    """(pg, cg) of consumer thread tid (csrc/nerf_ffma.cuh ``thr``)."""
    warp, lane = divmod(tid, 32)
    return 4 * (warp >> 2) + (lane >> 3), 8 * (warp & 3) + (lane & 7)


def _ffma_point(pg, i):
    return 4 * pg + (i & 3) + 32 * (i >> 2)


def _ffma_col(cg, j):
    return 4 * cg + (j & 3) + 128 * (j >> 2)


def _swz(k, p):
    """``swz`` of csrc/nerf_ffma.cuh: the float index of (k, p) in a
    [K][64] buffer."""
    return k * 64 + (((p >> 2) ^ ((k >> 2) & 7)) << 2) + (p & 3)


@pytest.mark.parametrize("n_out", range(16, 257, 16))
def test_fp32_micro_tiles_cover_each_output_once(n_out):
    """The 256 consumer threads' 8 x 8 micro-tiles (points point(i),
    columns col(j), j < 4 NCH, the columns below the layer's width) cover
    every (point, column) of a 64 x n_out product exactly once, with one
    column chunk a thread (NCH = 1) at widths up to 128 and two above."""
    nch = 2 if n_out > 128 else 1
    seen = {}
    for tid in range(256):
        pg, cg = _ffma_thread(tid)
        for i in range(8):
            for j in range(4 * nch):
                col = _ffma_col(cg, j)
                if col < n_out:
                    key = (_ffma_point(pg, i), col)
                    assert key not in seen, (key, tid, seen.get(key))
                    seen[key] = tid
    assert sorted(seen) == [(p, c) for p in range(64) for c in range(n_out)]


def test_fp32_swizzle_spreads_loads_and_stores_over_the_banks():
    """The [K][64] swizzle is a permutation within each row that keeps 4
    points' 16 bytes together; a warp's A loads (4 point groups of one row)
    fall in 4 distinct 16-byte bank groups, and an epilogue's quarter-warp
    (lanes 8q .. 8q + 7: one point group, 8 rows 4 apart) stores into 8
    distinct ones, for every row the layers write."""
    for k in range(256):
        idx = [_swz(k, p) for p in range(64)]
        assert sorted(idx) == list(range(k * 64, k * 64 + 64))
        for p in range(0, 64, 4):
            assert idx[p:p + 4] == list(range(idx[p], idx[p] + 4))
            assert idx[p] % 4 == 0
    for warp in range(8):
        threads = [_ffma_thread(32 * warp + lane) for lane in range(32)]
        for k in range(256):
            for half in (0, 32):   # the two A loads: point groups pg, pg + 8
                groups = {(_swz(k, 4 * pg + half) % 32) // 4
                          for pg, _ in threads}
                assert len(groups) == 4, (warp, k)
        for q in range(4):        # quarter-warps
            quarter = threads[8 * q:8 * q + 8]
            for j in range(8):
                for half in (0, 32):
                    banks = {(_swz(_ffma_col(cg, j), 4 * pg + half) % 32) // 4
                             for pg, cg in quarter}
                    assert len(banks) == 8, (warp, q, j)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype):
    """TINY and full width, at ragged sizes around the kernels' tiles (fp32
    64 points, bf16 128) and their one-block-per-SM grids; each launches
    twice and must be bitwise equal, and the kernel's launch plan is the
    host's."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tile = 64 if dtype == torch.float32 else 128
    for kw in (TINY, {}):
        cfg = NerfMLPConfig(**kw)
        params = init_nerf_params(PRNGKey(0), cfg,
                                  cuda_device)
        w = fm.FusedNerfWeights(params, cfg, dtype)
        for n in (1, tile - 1, tile + 1, 300, sms * tile + 1, 65_573):
            pts, dirs = (torch.from_numpy(a).to(cuda_device)
                         for a in _inputs(n))
            before = fm.fused_nerf_apply.launches
            got = fm.fused_nerf_apply(w, pts, dirs)
            again = fm.fused_nerf_apply(w, pts, dirs)
            torch.cuda.synchronize()
            assert fm.fused_nerf_apply.launches == before + 2
            want = fm.fused_nerf_plain(params, pts, dirs, cfg, dtype)
            tol = 2e-4 if dtype == torch.float32 else 2e-2
            assert (got - want).abs().max().item() < tol, (kw, n)
            assert torch.equal(got, again), (kw, n)
            if dtype == torch.bfloat16:
                assert fm.kernel_bf16_plan(cfg, n) == fm.bf16_launch_plan(
                    cfg, n, sms)
            else:
                assert fm.kernel_fp32_plan(cfg, n) == fm.fp32_launch_plan(
                    cfg, n, sms)
