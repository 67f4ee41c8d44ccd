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


@pytest.mark.parametrize("kw,dtype,n", [
    (TINY, "float32", 200), (TINY, "bfloat16", 200), ({}, "float32", 200)])
def test_plain_backward_matches_jax_bwd_kernel(kw, dtype, n):
    p = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), JaxCfg(**kw)))
    pts, dirs, g = _inputs(n)
    _, vjp = jax.vjp(lambda q: jax_train_apply(
        q, jnp.asarray(pts), jnp.asarray(dirs), JaxCfg(**kw),
        getattr(jnp, dtype), 128, True), p)
    want = vjp(jnp.asarray(g))[0]
    got = fb.fused_nerf_bwd_plain(params_from_jax(p), torch.from_numpy(pts),
                                  torch.from_numpy(dirs), torch.from_numpy(g),
                                  NerfMLPConfig(**kw), getattr(torch, dtype))
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        for q in ("w", "b"):
            assert tuple(got[k][q].shape) == np.asarray(want[k][q]).shape
    errs = _leaf_errors(got, want)
    tol = 1e-4 if dtype == "float32" else 2e-3
    assert max(errs.values()) <= tol, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_grads_inverts_the_packing(dtype):
    """``unpack_grads`` maps the packed layout of either dtype back to the
    params layout (values representable in bf16, so the packing's cast is
    exact; the encoding pad rows are dropped)."""
    cfg = NerfMLPConfig(**TINY)
    gen = torch.Generator().manual_seed(3)
    params = {k: {p: torch.round(t * 64) / 64 for p, t in v.items()}
              for k, v in init_nerf_params(gen, cfg).items()}
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
    (values representable in bf16, so both packings hold the same values).
    The bf16 packing is passed through unchanged."""
    cfg = NerfMLPConfig(**TINY)
    gen = torch.Generator().manual_seed(8)
    params = {k: {p: torch.round(t * 64) / 64 for p, t in v.items()}
              for k, v in init_nerf_params(gen, cfg).items()}
    wmat32, _ = fm.pack_params(params, cfg, torch.float32)
    wmat16, _ = fm.pack_params(params, cfg, torch.bfloat16)
    as32 = SimpleNamespace(wmat=wmat32, cfg=cfg, compute_dtype=torch.float32)
    as16 = SimpleNamespace(wmat=wmat16, cfg=cfg, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(fb.out_in_matrices(as32), wmat16.float(),
                               rtol=0, atol=0)
    assert fb.out_in_matrices(as16) is wmat16


def test_autograd_function_on_cpu_is_the_plain_backward():
    """Through ``FusedNerfTrainApply`` on CPU tensors: the forward is the
    forward kernel's plain version, the backward ``fused_nerf_bwd_plain``
    (exactly), and points/viewdirs get no gradient (zero by contract)."""
    cfg = NerfMLPConfig(**TINY)
    params = init_nerf_params(torch.Generator().manual_seed(4), cfg)
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
    params = init_nerf_params(torch.Generator().manual_seed(5), cfg)
    pts, dirs, g = map(torch.from_numpy, _inputs(301, seed=2))
    whole = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg)
    a = fb.fused_nerf_bwd_plain(params, pts[:150], dirs[:150], g[:150], cfg)
    b = fb.fused_nerf_bwd_plain(params, pts[150:], dirs[150:], g[150:], cfg)
    summed = {k: {p: a[k][p] + b[k][p] for p in v} for k, v in a.items()}
    assert max(_leaf_errors(summed, whole).values()) <= 1e-5


def test_kernel_wrapper_refuses_cpu_tensors():
    cfg = NerfMLPConfig(**TINY)
    params = init_nerf_params(torch.Generator().manual_seed(6), cfg)
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
    """The CUDA kernel against its plain version (per leaf 1e-2 fp32, 8e-2
    bf16 at n = 5,000; see ``chip_smoke.py`` for why) and bitwise against a
    second launch. Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run chip_smoke.py there")
    cfg = NerfMLPConfig()
    params = init_nerf_params(torch.Generator().manual_seed(7), cfg, "cuda")
    pts, dirs, g = (torch.from_numpy(x).cuda() for x in _inputs(5000))
    for dtype, tol in ((torch.float32, 1e-2), (torch.bfloat16, 8e-2)):
        w = fm.FusedNerfWeights(params, cfg, dtype)
        first = fb.fused_nerf_bwd(w, pts, dirs, g)
        assert torch.equal(first, fb.fused_nerf_bwd(w, pts, dirs, g))
        want = fb.fused_nerf_bwd_plain(params, pts, dirs, g, cfg, dtype)
        errs = _leaf_errors({k: {p: t.cpu() for p, t in v.items()} for k, v in
                             fb.unpack_grads(first, cfg, dtype).items()},
                            {k: {p: t.cpu() for p, t in v.items()}
                             for k, v in want.items()})
        assert max(errs.values()) <= tol, errs
