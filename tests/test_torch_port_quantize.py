"""The port's int8 serving path against the JAX package's: ``rng.normal``,
``ops/quantize.py``, ``ops/fused_mlp_int8.py`` (its plain version on the
CPU), the renderer's int8 dispatch and ``NerfRenderer.enable_int8``.

Tolerances, each with its reason:
* integer draws, uniforms, ``qw``/``s``/``b``/``inv_act`` from one calib
  dict, and the int8 graph on one set of encoded inputs: **bitwise** (the
  same integer arithmetic, and IEEE multiplies, divides and adds rounded
  alike in both packages);
* normals: 1e-5 absolute plus 1e-5 relative, ``ray_normal``'s tolerance
  (``tests/test_torch_port_rng.py``: the two erfinvs round apart in the
  tails), and the unit directions built from them 2e-6 absolute;
* calibration maxima: 2e-4 of each vector's largest (fp32 products summed
  in another order through ten layers);
* the wrapper (the port's own ``freq_encode``) against JAX's interpreted
  Pallas int8 kernel: 1e-6 absolute, JAX's own bound
  (``tests/test_quantize.py:122``); a sin that rounds differently moves an
  encoding by an ulp, which flips its int8 value only at a rounding tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.ops import quantize as jq
from cvnerf_tpu.ops.encoding import freq_encode as jax_encode
from cvnerf_tpu.ops.pallas.fused_mlp_int8 import (
    fused_nerf_apply_int8 as jax_int8_kernel)
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops.encoding import freq_encode
from cvnerf_torch.ops import fused_mlp as fm
from cvnerf_torch.ops import fused_mlp_int8 as fq
from cvnerf_torch.ops import quantize as tq
from cvnerf_torch.ops import rng
from cvnerf_torch.utils.convert import params_from_jax, quantized_params_from_jax

FULL = {}                                          # 256/128, L = 10/4
TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=32)
BBOX = ((-1.5,) * 3, (1.5,) * 3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def full():
    """Full-width params, JAX's calibration on 4096 box samples, and JAX's
    quantized params carried into the port."""
    cfg = JaxCfg(**FULL)
    jp = _np(jax_init(jax.random.PRNGKey(0), cfg))
    pts, dirs = jq.calibration_samples(jax.random.PRNGKey(1), 4096, *BBOX)
    calib = {k: np.array(v) for k, v in
             jq.calibrate_nerf_quant(jp, cfg, pts, dirs).items()}
    jqp = _np(jq.quantize_nerf_params(jp, cfg, calib))
    return dict(cfg=cfg, tcfg=NerfMLPConfig(**FULL), jp=jp, tp=params_from_jax(jp),
                pts=np.array(pts), dirs=np.array(dirs), calib=calib,
                jqp=jqp, tqp=quantized_params_from_jax(jqp))


def _encoded(cfg, seed, n):
    p, d = jq.calibration_samples(jax.random.PRNGKey(seed), n, *BBOX)
    return (np.array(p), np.array(d), np.array(jax_encode(p, cfg.xyz_freqs)),
            np.array(jax_encode(d, cfg.dir_freqs)))


def _pow2_heads(qp, make):
    """``qp`` with power-of-two head scales and zero head biases (the fp32
    dequant is then exact)."""
    layers = dict(qp.layers)
    for h in ("alpha", "l11"):
        s = np.asarray(layers[h]["s"])
        layers[h] = {"qw": layers[h]["qw"],
                     "s": make(np.full_like(s, 2.0 ** -10)),
                     "b": make(np.zeros_like(s))}
    return layers


# ---------------------------------------------------------------- rng
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_normal_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    shape = (4000, 3)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        rng.uniform(tk, shape, minval=float(lo), maxval=1.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=1.0)))
    want = np.asarray(jax.random.normal(jk, shape))
    got = rng.normal(tk, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_calibration_samples_match_jax():
    jp, jd = jq.calibration_samples(jax.random.PRNGKey(3), 5000, *BBOX)
    tp, td = tq.calibration_samples(rng.PRNGKey(3), 5000, *BBOX)
    # u * (hi - lo) + lo: bitwise unless a compiler contracts it (1 ulp).
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=3e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)


@pytest.mark.parametrize("ndc", [False, True])
def test_ray_calibration_samples_match_jax(ndc):
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, :3, 3] = [[0.1, -0.2, 4.0], [1.5, 0.3, 3.5], [-2.0, 1.0, 3.0]]
    poses[1, :3, :3] = [[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]]
    args = (7, 9, 11.0, 2.0, 6.0) if not ndc else (7, 9, 11.0, 0.0, 1.0)
    jk, tk = jax.random.PRNGKey(5), rng.PRNGKey(5)
    # The integer draws (pose pick, pixel column, pixel row): bitwise.
    jks, tks = jax.random.split(jk, 4), rng.split(tk, 4)
    for (j, t), hi in zip(zip(jks[:3], tks[:3]), (3, 9, 7)):
        np.testing.assert_array_equal(
            rng.randint(t, (2000,), 0, hi).numpy(),
            np.asarray(jax.random.randint(j, (2000,), 0, hi)))
    jpts, jdirs = jq.ray_calibration_samples(jk, 2000, poses, *args, ndc=ndc)
    tpts, tdirs = tq.ray_calibration_samples(tk, 2000, poses, *args, ndc=ndc)
    # fp32 rotations and the NDC divides, summed and rounded in another
    # order: a few ulps of |p| <= ~10.
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tdirs.numpy(), np.asarray(jdirs), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- quantize
def test_calibration_maxima_match_jax(full):
    got = tq.calibrate_nerf_quant(full["tp"], full["tcfg"],
                                  torch.from_numpy(full["pts"]),
                                  torch.from_numpy(full["dirs"]))
    assert got.keys() == full["calib"].keys()
    for k, want in full["calib"].items():
        assert got[k].shape == want.shape, k
        err = np.abs(got[k].numpy() - want).max() / want.max()
        assert err <= 2e-4, (k, err)


def test_quantize_nerf_params_bitwise(full):
    got = tq.quantize_nerf_params(full["tp"], full["tcfg"], full["calib"])
    want = full["jqp"]
    assert got.layers.keys() == want.layers.keys()
    for name, lay in want.layers.items():
        assert got.layers[name]["qw"].dtype == torch.int8
        for leaf in ("qw", "s", "b"):
            np.testing.assert_array_equal(got.layers[name][leaf].numpy(),
                                          lay[leaf], err_msg=f"{name}.{leaf}")
    for k in ("enc_x", "enc_d"):
        np.testing.assert_array_equal(got.inv_act[k].numpy(), want.inv_act[k])


def test_zero_calibration_is_finite():
    cfg = NerfMLPConfig(**TINY)
    params = params_from_jax(_np(jax_init(jax.random.PRNGKey(0), JaxCfg(**TINY))))
    calib = {k: torch.zeros(cfg.trunk_width) for k in tq.HIDDEN}
    calib.update(enc_x=torch.zeros(cfg.xyz_dim), enc_d=torch.zeros(cfg.dir_dim),
                 h10=torch.zeros(cfg.head_width))
    qp = tq.quantize_nerf_params(params, cfg, calib)
    for lay in qp.layers.values():
        assert all(torch.isfinite(t.float()).all() for t in lay.values())


@pytest.mark.parametrize("heads", ["pow2", "real"])
def test_apply_nerf_quant_matches_jax(full, heads):
    """On the same params and the same JAX-encoded inputs. With power-of-two
    head scales and zero head biases every int8 activation and head
    accumulator is compared exactly; with the real scales the JAX bound
    (1e-6) is allowed, though both round ``acc * s + b`` the same way."""
    _, _, ex, ed = _encoded(full["cfg"], 4, 2000)
    jqp, tqp = full["jqp"], full["tqp"]
    if heads == "pow2":
        jqp = jq.QuantizedNerfParams(_pow2_heads(jqp, jnp.asarray),
                                     jqp.inv_act)
        tqp = tq.QuantizedNerfParams(_pow2_heads(tqp, torch.from_numpy),
                                     tqp.inv_act)
    want = np.asarray(jq.apply_nerf_quant(jqp, ex, ed, full["cfg"]))
    got = tq.apply_nerf_quant(tqp, torch.from_numpy(ex), torch.from_numpy(ed),
                              full["tcfg"]).numpy()
    if heads == "pow2":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,n,tile", [(4, 300, 256), (5, 130, 128)])
def test_wrapper_matches_jax_int8_kernel(full, seed, n, tile):
    """The wrapper on CPU tensors (the plain version) against JAX's Pallas
    int8 kernel in the interpreter, full width, ragged n, on the sample
    streams of ``tests/test_quantize.py``'s kernel tests. (JAX's
    interpreted kernel is not bitwise its own oracle on every stream: on
    some others it differs from ``apply_nerf_quant`` at a few points, while
    the port's plain version matches that oracle bitwise,
    ``test_apply_nerf_quant_matches_jax``.)"""
    pts, dirs, _, _ = _encoded(full["cfg"], seed, n)
    want = np.asarray(jax_int8_kernel(full["jqp"],
                                      jnp.asarray(pts), jnp.asarray(dirs),
                                      full["cfg"], tile=tile, interpret=True))
    w = fq.QuantizedNerfWeights(full["tqp"], full["tcfg"])
    launches, calls = (fq.fused_nerf_apply_int8.launches,
                       fq.fused_nerf_int8_plain.calls)
    got = fq.fused_nerf_apply_int8(w, torch.from_numpy(pts),
                                   torch.from_numpy(dirs))
    assert fq.fused_nerf_apply_int8.launches == launches   # no kernel on CPU
    assert fq.fused_nerf_int8_plain.calls == calls + 1
    assert got.shape == (n, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_int8_wrapper_rejects_bad_inputs(full):
    w = fq.QuantizedNerfWeights(full["tqp"], full["tcfg"])
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        fq.fused_nerf_apply_int8(w, torch.zeros(4, 2), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="same length"):
        fq.fused_nerf_apply_int8(w, torch.zeros(4, 3), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        fq.fused_nerf_apply_int8(w, torch.zeros(4, 3, device="meta"),
                                 torch.zeros(4, 3, device="meta"))


# ---------------------------------------------------------------- packing
def _unpack(qmat, qvec, cfg):
    """The packed buffers split back by the layout lists."""
    mats, p = {}, 0
    for name, out, inn in fq.qmat_blocks(cfg):
        mats[name] = qmat[p:p + out * inn].reshape(out, inn)
        p += out * inn
    assert p == qmat.numel()
    vecs, p = {}, 0
    for name, size in fq.qvec_blocks(cfg):
        vecs[name] = qvec[p:p + size]
        p += size
    assert p == qvec.numel()
    return mats, vecs


@pytest.mark.parametrize("kw", [FULL, TINY])
def test_pack_qparams_round_trip(kw):
    cfg = NerfMLPConfig(**kw)
    params = params_from_jax(_np(jax_init(jax.random.PRNGKey(2), JaxCfg(**kw))))
    pts, dirs = tq.calibration_samples(rng.PRNGKey(1), 512, *BBOX)
    qp = tq.quantize_nerf(params, cfg, pts, dirs)
    qmat, qvec = fq.pack_qparams(qp, cfg)
    assert qmat.dtype == torch.int8 and qvec.dtype == torch.float32
    mats, vecs = _unpack(qmat, qvec, cfg)
    # The staged matrices' rows are stored in the kernel's row order: put
    # them back in logical order before comparing.
    for name in fq.STAGED:
        mats[name] = mats[name][torch.argsort(fq.row_order(
            mats[name].shape[0]))]
    L, xd, w = qp.layers, cfg.xyz_dim, cfg.trunk_width

    def eq(a, b):
        assert torch.equal(a, b)

    for i in (2, 3, 4, 5, 7, 8, 9):
        eq(mats[f"l{i}"], L[f"l{i}"]["qw"].t())
    eq(mats["l1"][:, :xd], L["l1"]["qw"].t())
    eq(mats["l6a"], L["l6"]["qw"].t()[:, xd:])
    eq(mats["l6b"][:, :xd], L["l6"]["qw"].t()[:, :xd])
    eq(mats["l10a"], L["l10"]["qw"].t()[:, :w])
    eq(mats["l10b"][:, :cfg.dir_dim], L["l10"]["qw"].t()[:, w:])
    eq(mats["alpha"], L["alpha"]["qw"].t())
    eq(mats["l11"], L["l11"]["qw"].t())
    for name, real in (("l1", xd), ("l6b", xd), ("l10b", cfg.dir_dim)):
        assert not mats[name][:, real:].any(), name          # zero pads
    eq(vecs["inv_x"][:xd], qp.inv_act["enc_x"])
    eq(vecs["inv_d"][:cfg.dir_dim], qp.inv_act["enc_d"])
    assert not vecs["inv_x"][xd:].any() and not vecs["inv_d"][cfg.dir_dim:].any()
    for i in range(1, 11):
        eq(vecs[f"s{i}"], L[f"l{i}"]["s"])
        eq(vecs[f"b{i}"], L[f"l{i}"]["b"])
    for name, key, k in (("sa", "alpha", 1), ("s11", "l11", 3)):
        eq(vecs[name][:k], L[key]["s"])
        eq(vecs["b" + name[1:]][:k], L[key]["b"])
        assert not vecs[name][k:].any()


def test_row_order_is_a_permutation_within_32_row_blocks():
    """Packed row c = 8 j + 2 t + e of a 32-row block holds logical row
    16 (j >> 1) + 4 t + 2 (j & 1) + e; a 16-row tail maps onto itself."""
    for n in range(16, 257, 16):
        order = fq.row_order(n)
        assert sorted(order.tolist()) == list(range(n)), n
        assert torch.equal(order // 32, torch.arange(n) // 32), n
    assert fq.row_order(32).tolist() == [
        0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15,
        16, 17, 20, 21, 24, 25, 28, 29, 18, 19, 22, 23, 26, 27, 30, 31]


def _kernel_walk(qmat, qvec, cfg, points, viewdirs):
    """The int8 kernel's data flow (csrc/fused_mlp_int8.cu), in numpy, from
    the packed buffers: a layer's A fragment byte k is logical column k of
    its input; its wgmma accumulator column c is the dot with packed row c;
    the epilogue gives thread t of 32-column block cb the accumulators
    ``acc[16 cb + 4 j + i]`` (column ``32 cb + 8 j + 2 t + (i & 1)``, rows
    ``r + 8 (i >> 1)``) and packs ``c[0], c[1], c[4], c[5]`` (scales at
    ``32 cb + 4 t + 0..3``) into A register 0 and ``c[8], c[9], c[12],
    c[13]`` (at ``+ 16``) into register 2, registers 1 and 3 the same for
    row r + 8; columns past the fan-out enter as 0; the heads dot the
    logical activation with the logical head weights."""
    mats, vecs = _unpack(qmat, qvec, cfg)
    mats = {k: v.numpy().astype(np.int64) for k, v in mats.items()}
    vecs = {k: v.numpy() for k, v in vecs.items()}
    kx, kd = mats["l1"].shape[1], mats["l10b"].shape[1]
    f32 = np.float32

    def dq(acc, s, b):            # acc * s + b, each step rounded in fp32
        return (acc.astype(f32) * f32(s)) + f32(b)

    def quant(v, lo):             # clip(rint(v), lo, 127)
        return np.clip(np.rint(v), lo, 127).astype(np.int64)

    def epilogue(acc, s, b, n_out, lo):
        nxt = np.zeros((acc.shape[0], n_out), np.int64)
        for cb in range(-(-n_out // 32)):
            for t in range(4):
                for k0, ks in ((0, (0, 1, 4, 5)), (16, (8, 9, 12, 13))):
                    if 32 * cb + k0 >= n_out:
                        continue
                    for byte, k in enumerate(ks):
                        j, i = k // 4, k % 4
                        col = 32 * cb + 8 * j + 2 * t + (i & 1)
                        logical = 32 * cb + k0 + 4 * t + byte
                        nxt[:, logical] = quant(
                            dq(acc[:, col], s[logical], b[logical]), lo)
        return nxt

    def layer(parts, i, lo):      # parts: [(activation, packed matrix)]
        acc = sum(a @ m.T for a, m in parts)
        n_out = parts[0][1].shape[0]
        return epilogue(acc, vecs[f"s{i}"], vecs[f"b{i}"], n_out, lo)

    def enc(x, freqs, inv, k):
        e = freq_encode(torch.from_numpy(x), freqs).numpy()
        e = np.pad(e, ((0, 0), (0, k - e.shape[1])))
        return np.clip(np.rint(e * inv), -127, 127).astype(np.int64)

    q_ex = enc(points, cfg.xyz_freqs, vecs["inv_x"], kx)
    q_ed = enc(viewdirs, cfg.dir_freqs, vecs["inv_d"], kd)
    h = layer([(q_ex, mats["l1"])], 1, 0)
    for i in (2, 3, 4, 5):
        h = layer([(h, mats[f"l{i}"])], i, 0)
    h = layer([(h, mats["l6a"]), (q_ex, mats["l6b"])], 6, 0)
    h = layer([(h, mats["l7"])], 7, 0)
    h = layer([(h, mats["l8"])], 8, 0)
    sigma = dq(h @ mats["alpha"][0], vecs["sa"][0], vecs["ba"][0])
    h = layer([(h, mats["l9"])], 9, -127)
    h = layer([(h, mats["l10a"]), (q_ed, mats["l10b"])], 10, 0)
    rgb = np.stack([dq(h @ mats["l11"][c], vecs["s11"][c], vecs["b11"][c])
                    for c in range(3)], -1)
    return np.concatenate([rgb, sigma[:, None]], -1)


@pytest.mark.parametrize("kw", [FULL, TINY,
                                dict(xyz_freqs=3, dir_freqs=1, trunk_width=48,
                                     head_width=16)])
def test_kernel_walk_of_the_packing_is_the_plain_version(kw):
    """The packed operands, walked as the int8 kernel walks them (its
    accumulator and A-fragment layouts, the permuted rows, columns past a
    16-wide tail entering as 0), give bitwise the plain version's output:
    the row order and the kernel's epilogue indexing agree."""
    cfg = NerfMLPConfig(**kw)
    params = params_from_jax(_np(jax_init(jax.random.PRNGKey(3),
                                          JaxCfg(**kw))))
    pts, dirs = tq.calibration_samples(rng.PRNGKey(4), 512, *BBOX)
    qp = tq.quantize_nerf(params, cfg, pts, dirs)
    qmat, qvec = fq.pack_qparams(qp, cfg)
    tp, td = tq.calibration_samples(rng.PRNGKey(5), 300, (-2.5,) * 3,
                                    (2.5,) * 3)
    want = fq.fused_nerf_int8_plain(qp, tp, td, cfg).numpy()
    got = _kernel_walk(qmat, qvec, cfg, tp.numpy(), td.numpy())
    np.testing.assert_array_equal(got, want)


# Every width check_int8_kernel_config accepts: trunk/head multiples of 16
# with head <= trunk <= 256, at most 20 bands (the encodings' padded widths
# go in steps of 16 with the bands, so the extremes and a middle cover them).
_WIDTHS = [(w, h) for w in range(16, 257, 16) for h in range(16, w + 1, 16)]
_BANDS = [(lx, ld) for lx in (0, 4, 10, 13, 20) for ld in (0, 2, 4, 20)]


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_packed_int8_blocks_are_tma_tensors(trunk):
    """Each staged int8 matrix is read by TMA as a [fan-out, fan-in] byte
    tensor: it must start 16-byte aligned, its rows must be 16-byte
    multiples and its fan-out fit one box (256 rows); the vectors start
    16-byte aligned (float4 loads of the scales)."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            fq.check_int8_kernel_config(cfg)
            start = 0
            for name, fan_out, fan_in in fq.qmat_blocks(cfg):
                assert start % 16 == 0 and fan_in % 16 == 0, (cfg, name)
                if name in fq.STAGED:
                    assert fan_out <= 256 and fan_out % 16 == 0, (cfg, name)
                start += fan_out * fan_in
            start = 0
            for name, size in fq.qvec_blocks(cfg):
                assert (start * 4) % 16 == 0, (cfg, name)
                start += size


@pytest.mark.parametrize("trunk", range(16, 257, 16))
def test_int8_launch_plan_fits_every_accepted_width(trunk):
    """The int8 kernel's shared memory (weight stages + int8 encodings +
    raw inputs + barriers) fits a block on sm_90 with at least two stages,
    for every width the kernel accepts."""
    for w, h in (wh for wh in _WIDTHS if wh[0] == trunk):
        for lx, ld in _BANDS:
            cfg = NerfMLPConfig(xyz_freqs=lx, dir_freqs=ld, trunk_width=w,
                                head_width=h)
            plan = fq.int8_launch_plan(cfg, 1000, 132)
            assert 2 <= plan["stages"] <= 8, (cfg, plan)
            assert plan["smem_bytes"] <= fm.SMEM_LIMIT, (cfg, plan)
            assert plan["threads"] == 384


def test_int8_launch_plan_full_width_and_grid():
    cfg = NerfMLPConfig()
    plan = fq.int8_launch_plan(cfg, 8192 * 192, 132)
    # 5 stages of 256 rows x 128 B, int8 encodings of 128 points (64 + 32
    # wide, each row padded by 16) and their raw inputs (fp32, 6 a point),
    # each consumer warpgroup's copy of the head weights (256 + 3 x 128 B),
    # the encodings' inverses and the requant scales and biases (64 + 32 +
    # 18 x 256 + 2 x 128 fp32), 10 barriers, 1024 B of alignment slack.
    rest = 2 * (256 + 3 * 128) + (64 + 32 + 18 * 256 + 2 * 128) * 4
    assert plan == {"blocks": 132, "threads": 384, "stages": 5, "fixed": 1,
                    "smem_bytes": 1024 + 5 * 32768 + 2 * 64 * (80 + 48)
                    + 128 * 6 * 4 + rest + 10 * 8}
    # Other bands or widths read their widths at run time.
    for kw in (dict(xyz_freqs=12), dict(head_width=256), TINY):
        assert fq.int8_launch_plan(NerfMLPConfig(**kw), 1, 132)["fixed"] == 0
    # A fan-in 16 past a k32 step (L = 11: 69 -> KX 80) rows of 96 + 16.
    assert fq.int8_launch_plan(NerfMLPConfig(xyz_freqs=11), 1, 132)[
        "smem_bytes"] == 1024 + 5 * 32768 + 2 * 64 * (112 + 48) \
        + 128 * 6 * 4 + rest + 16 * 4 + 10 * 8
    # One block per 128-point tile, at most one per SM (persistent grid).
    for n, blocks in ((1, 1), (127, 1), (128, 1), (129, 2),
                      (132 * 128, 132), (132 * 128 + 1, 132), (65_573, 132),
                      (1000 * 128, 132)):
        assert fq.int8_launch_plan(cfg, n, 132)["blocks"] == blocks, n
    assert fq.int8_launch_plan(cfg, 10_000, 114)["blocks"] == 79


@pytest.mark.parametrize("kw", [dict(trunk_width=24, head_width=16),
                                dict(trunk_width=512, head_width=128),
                                dict(trunk_width=64, head_width=128)])
def test_int8_kernel_refuses_architectures_it_does_not_take(kw):
    cfg = NerfMLPConfig(**kw)
    with pytest.raises(ValueError, match="kernels='off'"):
        fq.check_int8_kernel_config(cfg)
    fq.check_int8_kernel_config(NerfMLPConfig(**TINY))


# ---------------------------------------------------------------- renderer
def _rays(n):
    o = np.stack([np.zeros(n), np.zeros(n), np.full(n, -4.0)], -1)
    v = np.stack([np.linspace(-0.2, 0.2, n), np.zeros(n), np.ones(n)], -1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return o.astype(np.float32), v.astype(np.float32)


def test_render_rays_int8_matches_jax(full):
    """24 rays, 8 + 8 samples, the evenly spaced resample that serving uses:
    the port's int8 render (as params and as packed weights through the
    wrapper, and with ``kernels="off"``) against JAX ``pallas="off"`` on the
    same quantized params; rgb/acc 1e-5, depth 1e-3. Every route runs the
    counted plain version on the CPU, so the three renders are bitwise
    equal; chunk invariance bitwise. (The stochastic
    resample's sorted uniforms differ from JAX's by ~1e-7, which can move a
    fine sample enough to flip an int8 encoding of its high bands.)"""
    from cvnerf_tpu.render.renderer import RenderConfig as JR
    from cvnerf_tpu.render.renderer import render_rays as jax_render
    from cvnerf_torch.render.renderer import (RenderConfig, render_rays,
                                              render_rays_chunked)
    o, v = _rays(24)
    jqp = full["jqp"]
    want = jax_render(jax.random.PRNGKey(0), {"coarse": jqp, "fine": jqp},
                      jnp.asarray(o), jnp.asarray(v), jnp.asarray(v),
                      jnp.full((24,), 2.5), jnp.full((24,), 5.5),
                      JR(n_coarse=8, n_fine=8, perturb=False, mlp=full["cfg"],
                         pallas="off", deterministic_resample=True))
    cfg = RenderConfig(n_coarse=8, n_fine=8, perturb=False, mlp=full["tcfg"],
                       deterministic_resample=True)
    packed = fq.QuantizedNerfWeights(full["tqp"], full["tcfg"])
    key = rng.PRNGKey(0)
    to = (torch.from_numpy(o), torch.from_numpy(v), torch.from_numpy(v))
    near, far = torch.full((24,), 2.5), torch.full((24,), 5.5)
    calls = fq.fused_nerf_int8_plain.calls
    outs = [render_rays(nets, *to, near, far, c, key=key)
            for nets, c in (({"coarse": full["tqp"], "fine": full["tqp"]}, cfg),
                            ({"coarse": packed, "fine": packed}, cfg),
                            ({"coarse": packed, "fine": packed},
                             dataclasses.replace(cfg, kernels="off")))]
    assert fq.fused_nerf_int8_plain.calls == calls + 6   # 2 passes each
    for got in outs:
        for k in ("rgb", "rgb_coarse", "acc", "depth"):
            tol = 1e-3 if k == "depth" else 1e-5
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=tol, err_msg=k)
    for got in outs[1:]:
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), outs[0][k].numpy())
    nets = {"coarse": packed, "fine": packed}
    whole = render_rays_chunked(nets, *to, 2.5, 5.5, cfg, chunk=24, key=key)
    split = render_rays_chunked(nets, *to, 2.5, 5.5, cfg, chunk=8, key=key)
    for k in whole:
        np.testing.assert_array_equal(whole[k].numpy(), split[k].numpy())


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One tiny checkpoint saved for both packages' renderers."""
    from cvnerf_tpu.train.checkpoint import save_checkpoint
    from cvnerf_tpu.train.state import TrainState, create_train_state
    from cvnerf_tpu.utils.convert import torch_state_dict_from_params
    root = tmp_path_factory.mktemp("int8_serve")
    cfg = JaxCfg(**TINY)
    state = create_train_state(jax.random.PRNGKey(0), mlp=cfg)
    params = state.params
    for net in ("coarse", "fine"):
        params[net]["alpha"]["b"] = params[net]["alpha"]["b"] + 1.0
    save_checkpoint(str(root / "ckpt"), TrainState(
        params=params, opt_state=state.opt_state, step=7))
    pt = str(root / "net.pt")
    host = _np(params)
    torch.save({n: torch_state_dict_from_params(host[n])
                for n in ("coarse", "fine")} | {"step": 7}, pt)
    return str(root / "ckpt"), pt, host


POSES = np.stack([np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4],
                            [0, 0.6, 0.8, 3.2]], np.float32),
                  np.array([[0.8, 0, 0.6, 2.4], [0, 1, 0, 0.1],
                            [-0.6, 0, 0.8, 3.2]], np.float32)])
GEO = dict(height=10, width=12, focal=10.0, near=2.0, far=6.0)


@pytest.mark.parametrize("path", ["poses", "cube"])
def test_enable_int8_matches_jax_serving(served, path):
    """``enable_int8`` on both packages' renderers from one checkpoint. The
    calibration points agree to a few ulps (the normals' erfinv), so a
    scale may round one step apart and a weight on a rounding tie flip:
    the share of ``qw`` entries that differ is held at 1e-3 and each may
    differ by 1 (on both paths here none of the 23,104 differs), the
    scales at 1e-4 relative. Frames: rgb/acc 1e-5, as the int8 render
    test. A second render is bitwise equal; the float master copy is
    untouched."""
    from cvnerf_tpu.render.renderer import RenderConfig as JR
    from cvnerf_tpu.serve import NerfRenderer as JaxRenderer
    from cvnerf_torch.render.renderer import RenderConfig
    from cvnerf_torch.serve import NerfRenderer
    ckpt, pt, host = served
    poses = POSES if path == "poses" else None
    jr = JaxRenderer(ckpt, **GEO, cfg=JR(n_coarse=4, n_fine=4,
                                         mlp=JaxCfg(**TINY)),
                     chunk=120, use_mesh=False)
    tr = NerfRenderer(pt, **GEO, cfg=RenderConfig(n_coarse=4, n_fine=4,
                                                  mlp=NerfMLPConfig(**TINY)),
                      chunk=120, device="cpu")
    float_before = {n: {k: {p: t.clone() for p, t in lay.items()}
                        for k, lay in net.items()}
                    for n, net in tr._float_params.items()}
    assert jr.enable_int8(poses=poses, n_calib=4096, bound=3.0) is jr
    assert tr.enable_int8(poses=poses, n_calib=4096, bound=3.0) is tr
    assert all(isinstance(n, fq.QuantizedNerfWeights)
               for n in tr._nets.values())
    differ = total = 0
    for net in ("coarse", "fine"):
        jl, tl = jr.params[net], tr._nets[net].qp
        for name, lay in jl.layers.items():
            got = tl.layers[name]["qw"].numpy().astype(np.int32)
            want = np.asarray(lay["qw"], np.int32)
            assert np.abs(got - want).max() <= 1, name
            differ += int((got != want).sum())
            total += want.size
            np.testing.assert_allclose(tl.layers[name]["s"].numpy(),
                                       np.asarray(lay["s"]), rtol=1e-4)
        for k in ("enc_x", "enc_d"):
            np.testing.assert_allclose(tl.inv_act[k].numpy(),
                                       np.asarray(jl.inv_act[k]), rtol=1e-4)
    assert differ / total <= 1e-3, differ / total
    pose = POSES[0]
    want = jr.render_pose_extras(pose, keys=("rgb", "acc", "depth"))
    got = tr.render_pose_extras(pose, keys=("rgb", "acc", "depth"))
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tr.render_pose(pose), got["rgb"])
    for n, net in tr._float_params.items():
        for k, lay in net.items():
            for p, t in lay.items():
                assert torch.equal(t, float_before[n][k][p])
        np.testing.assert_array_equal(net["l1"]["w"].numpy(), host[n]["l1"]["w"])


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [FULL, TINY,
                                dict(xyz_freqs=3, dir_freqs=1, trunk_width=48,
                                     head_width=16)])
def test_int8_kernel_matches_plain_version_on_card(cuda_device, kw):
    """Bitwise: the kernel repeats the plain version's every rounding, at
    ragged n around its 128-point tiles and one persistent wave (132 SMs on
    an H100), and two launches agree bitwise; its launch plan is the
    host's."""
    cfg = NerfMLPConfig(**kw)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    params = init_nerf_params(rng.PRNGKey(0), cfg,
                              cuda_device)
    cpts, cdirs = tq.calibration_samples(rng.PRNGKey(1), 4096, *BBOX,
                                         device=cuda_device)
    qp = tq.quantize_nerf(params, cfg, cpts, cdirs)
    w = fq.QuantizedNerfWeights(qp, cfg)
    for n in (1, 127, 129, 300, 2 ** 12 + 37, sms * 128 + 1, 65_573):
        pts, dirs = tq.calibration_samples(rng.PRNGKey(2), n, (-3.0,) * 3,
                                           (3.0,) * 3, device=cuda_device)
        before = fq.fused_nerf_apply_int8.launches
        got = fq.fused_nerf_apply_int8(w, pts, dirs)
        again = fq.fused_nerf_apply_int8(w, pts, dirs)
        torch.cuda.synchronize()
        assert fq.fused_nerf_apply_int8.launches == before + 2
        want = fq.fused_nerf_int8_plain(qp, pts, dirs, cfg)
        assert torch.equal(got, want), (kw, n,
                                        (got - want).abs().max().item())
        assert torch.equal(got, again), (kw, n)
        assert fq.kernel_int8_plan(cfg, n) == fq.int8_launch_plan(cfg, n, sms)

