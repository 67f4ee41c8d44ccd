"""The Instant-NGP field's kernels on the card (``ops/hash_encode.py``,
``csrc/hash_encode.cu``; the skip-zero and L2 rules of ``csrc/adam.cu``;
the MLPs' ``ops/ngp_mlp.py``, ``csrc/ngp_mlp.cu``) at the published widths
(16 levels, 2^19 entries a level, 12,196,240 table values, 64-wide MLPs)
and a train step's 2^18 samples: the encoding's forward bitwise its plain
version on the same card, its backward within float32 rounding of it (its
atomic adds sum in no fixed order), Adam over the field's 21 leaves bitwise
``adam_plain``, the MLPs' kernels within bf16 rounding of their plain
version and their weight gradients bitwise over two runs, and a graphed
block of train steps launching the kernels.
Needs an NVIDIA card; skipped without one (CUDA kernels have no CPU mode).
Run on the card with ``python3 -m pytest --noconftest
tests/test_torch_port_ngp_cuda.py`` (``tests/conftest.py`` imports JAX,
which the card's machine lacks)."""

import numpy as np
import pytest
import torch

from cvnerf_torch.models.ngp_field import NgpFieldConfig, init_ngp_params
from cvnerf_torch.ops import adam as fa
from cvnerf_torch.ops import hash_encode as he
from cvnerf_torch.ops import ngp_mlp as nm
from cvnerf_torch.ops.encoding import sh_encode
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train.loop import TrainConfig, Trainer
from cvnerf_torch.train.state import (Adam, TrainState, create_train_state,
                                      make_optimizer)
from cvnerf_torch.utils.tree import tree_leaves

N = 1 << 18
CFG = NgpFieldConfig()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(device, n=N, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    # A tenth of the positions outside the unit cube: the kernel clamps.
    unit = torch.rand(n, 3, generator=g, device=device) * 1.2 - 0.1
    params = init_ngp_params(PRNGKey(seed), CFG, device)
    tables = [params["field"]["table"][str(k)] for k in range(CFG.n_levels)]
    return unit, tables


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 255, 65_537, N])
def test_forward_is_bitwise_the_plain_version_on_card(cuda_device, dtype, n):
    unit, tables = _inputs(cuda_device, n)
    launches = he.stats["fwd_launches"]
    got = he.hash_encode_fwd(unit, tables, CFG.levels, dtype)
    want = he.hash_encode_fwd(unit, tables, CFG.levels, dtype, plain=True)
    torch.cuda.synchronize()
    assert he.stats["fwd_launches"] == launches + 1
    assert got.shape == (n, 32) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_backward_matches_the_plain_version_on_card(cuda_device):
    """Per level, within 1e-4 of the level's largest plain gradient: the
    atomics' order against ``index_add_``'s, over up to ~500 adds an
    entry on the coarsest level."""
    unit, _ = _inputs(cuda_device)
    g = torch.randn(N, 32, generator=torch.Generator(cuda_device)
                    .manual_seed(1), device=cuda_device)
    launches = he.stats["bwd_launches"]
    got = he.hash_encode_bwd(unit, g, CFG.levels)
    want = he.hash_encode_bwd(unit, g, CFG.levels, plain=True)
    torch.cuda.synchronize()
    assert he.stats["bwd_launches"] == launches + 1
    assert got.shape == (6_098_120, 2)
    for lv in CFG.levels:
        a, b = (x[lv.offset:lv.offset + lv.entries] for x in (got, want))
        assert torch.equal(a == 0, b == 0)
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_skip_zero_and_l2_adam_is_bitwise_the_plain_version_on_card(
        cuda_device):
    """The field's 21 leaves in one launch: table entries with a zero
    gradient left as they were, L2 on the MLP weights, bitwise
    ``adam_plain`` on the same card."""
    params = init_ngp_params(PRNGKey(3), CFG, cuda_device)
    rng = torch.Generator(cuda_device).manual_seed(4)
    leaves = tree_leaves(params)
    grads = [torch.randn(t.shape, generator=rng, device=cuda_device) * 1e-3
             * (torch.rand(t.shape, generator=rng, device=cuda_device) < 0.3)
             for t in leaves]
    mu = [torch.randn(t.shape, generator=rng, device=cuda_device) * 1e-4
          for t in leaves]
    nu = [torch.rand(t.shape, generator=rng, device=cuda_device) * 1e-7
          for t in leaves]
    opt = make_optimizer(1e-2, 0, CFG)
    skip, l2 = opt.rules(params)
    assert sum(skip) == 16 and sum(f > 0 for f in l2) == 5
    scalars = torch.tensor(opt.scalars(7), device=cuda_device)
    launches = fa.fused_adam.launches
    got = fa.fused_adam(leaves, grads, mu, nu, scalars, opt.b1, opt.b2,
                        opt.eps, skip_zero=skip, l2=l2)
    assert fa.fused_adam.launches == launches + 1
    want = fa.adam_plain(leaves, grads, mu, nu, scalars, opt.b1, opt.b2,
                         opt.eps, skip, l2)
    torch.cuda.synchronize()
    for g3, w3 in zip(got, want):
        for a, b in zip(g3, w3):
            assert torch.equal(_bits(a), _bits(b))
    for k in range(16):
        zero = grads[k] == 0
        assert torch.equal(got[0][k][zero], leaves[k][zero])
        assert torch.equal(got[1][k][zero], mu[k][zero])


@pytest.mark.cuda
def test_a_graphed_block_launches_the_kernels_on_card(cuda_device):
    """A tiny scene, the published field: blocks of 4 graphed steps run
    the hash kernels (2 forward + 2 backward launches a captured step) and
    one Adam launch a step, the loss finite."""
    cfg = TrainConfig(height=24, width=32, focal=26.0, near=0.0, far=1.0,
                      n_rays=256, lr=1e-2, lr_decay=0, ndc=True,
                      render=RenderConfig(n_coarse=16, n_fine=16, mlp=CFG,
                                          compute_dtype=torch.bfloat16))
    state = create_train_state(PRNGKey(0), lr=1e-2, lr_decay=0, mlp=CFG,
                               device=cuda_device)
    rng = np.random.default_rng(0)
    images = rng.random((3, 24, 32, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1))
    tr = Trainer(cfg, state, images, poses, [0, 1, 2], steps_per_call=4)
    before = dict(he.stats)
    m = tr.run(0, 12)
    assert np.isfinite(m["loss"])
    assert tr.scan_fn.runner.stats["replayed_steps"] == 12
    assert he.stats["fwd_launches"] - before["fwd_launches"] >= 2
    assert he.stats["bwd_launches"] - before["bwd_launches"] >= 2
    assert he.stats["plain_calls"] == before["plain_calls"]
    assert tr.counters()["skip_zero_leaves"] > 0
    assert isinstance(tr.opt, Adam) and isinstance(tr.state, TrainState)


def _mlp_inputs(device, n, spr, seed=0):
    """Features ``[n, 32]`` bf16 (normal, σ 0.5: a trained table's range),
    one SH row a ray of ``spr`` samples, the published MLPs' leaves and a
    gradient ``[n, 4]``."""
    assert n % spr == 0
    g = torch.Generator(device).manual_seed(seed)
    feats = (torch.randn(n, 32, generator=g, device=device) * 0.5) \
        .to(torch.bfloat16)
    dirs = torch.randn(n // spr, 3, generator=g, device=device)
    sh = sh_encode(dirs / dirs.norm(dim=-1, keepdim=True))
    field = init_ngp_params(PRNGKey(seed), CFG, device)["field"]
    grad = torch.randn(n, 4, generator=g, device=device)
    return feats, sh, field, grad


def _plain(feats, sh, spr, field, grad, dtype):
    """The plain version's output and gradients (features, then the five
    leaves), through autograd, in ``dtype``."""
    x = feats.to(dtype).detach().requires_grad_()
    leaves = {net: {k: v.detach().clone().requires_grad_()
                    for k, v in field[net].items()}
              for net in ("density", "color")}
    out = nm.ngp_mlp_plain(x, sh, spr, leaves, dtype)
    out.backward(grad)
    return out.detach(), [x.grad.float()] + [
        leaves[net][name].grad for net, name, _, _ in nm.LAYERS]


def _weights(field):
    return [field[net][name] for net, name, _, _ in nm.LAYERS]


def _worst(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,spr", [(65_536, 64), (196_608, 192),
                                   (65_573, 1), (65_571, 3), (1, 1)])
def test_fused_mlp_forward_matches_the_plain_version_on_card(cuda_device, n,
                                                             spr):
    """``ngp_mlp_fwd`` against the bf16 plain version on the same card, the
    train step's two shapes, ragged n (not multiples of 16; SH a sample, or
    a ray of 3) and one sample. Both round at the same points and sum in float32
    in another order, so they part where a hidden sum lies within its
    float32 rounding of a bf16 rounding boundary: their distance stays
    within twice the plain version's own distance from the float32 field of
    the same features (the bf16 roundings' size), never near an output's
    scale."""
    feats, sh, field, _ = _mlp_inputs(cuda_device, n, spr)
    launches = nm.stats["fwd_launches"]
    got = nm.ngp_mlp_fwd(feats, sh, spr, _weights(field))
    want = nm.ngp_mlp_plain(feats, sh, spr, field, torch.bfloat16)
    exact = nm.ngp_mlp_plain(feats.float(), sh, spr, field, torch.float32)
    torch.cuda.synchronize()
    assert nm.stats["fwd_launches"] == launches + 1
    assert got.shape == (n, 4) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and (got[:, 3] > 0).all()
    own = _worst(want, exact)
    assert _worst(got, want) <= 2 * own + 1e-6 * float(exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,spr", [(196_608, 192), (65_571, 3)])
def test_fused_mlp_backward_matches_the_plain_version_on_card(cuda_device, n,
                                                              spr):
    """``ngp_mlp_bwd`` and its reduction against autograd through the bf16
    plain version: the features' gradient and each of the five weight
    gradients no farther from the plain version's than the plain version is
    from the float32 chain's (their difference is the bf16 roundings the
    plain chain adds: it rounds the hidden input gradients, the features'
    and the weight gradients to bf16, 2^-9 relative each, where the kernels
    keep float32), and no farther from the float32 chain's than twice the
    plain version is (the kernels round no more)."""
    feats, sh, field, grad = _mlp_inputs(cuda_device, n, spr, seed=1)
    weights = _weights(field)
    launches = nm.stats["bwd_launches"]
    fgrad, wgrads = nm.ngp_mlp_bwd(feats, sh, spr, weights, grad)
    assert nm.stats["bwd_launches"] == launches + 1
    _, want = _plain(feats, sh, spr, field, grad, torch.bfloat16)
    _, exact = _plain(feats, sh, spr, field, grad, torch.float32)
    torch.cuda.synchronize()
    assert fgrad.dtype == torch.float32 and fgrad.shape == (n, 32)
    for got, w, e in zip([fgrad] + wgrads, want, exact):
        assert got.shape == w.shape and got.dtype == torch.float32
        scale = float(w.abs().max())
        assert _worst(got, w) <= _worst(w, e) + 1e-6 * scale
        assert _worst(got, e) <= 2 * _worst(w, e) + 1e-6 * scale


@pytest.mark.cuda
def test_fused_mlp_weight_gradients_are_bitwise_over_two_runs(cuda_device):
    """The weight gradients are the slabs' fixed-order sums: two runs of
    the backward give the same bits (so do the features' gradients, which
    no two blocks share)."""
    feats, sh, field, grad = _mlp_inputs(cuda_device, 196_608, 192, seed=2)
    weights = _weights(field)
    a = nm.ngp_mlp_bwd(feats, sh, 192, weights, grad)
    b = nm.ngp_mlp_bwd(feats, sh, 192, weights, grad)
    torch.cuda.synchronize()
    for x, y in zip([a[0], *a[1]], [b[0], *b[1]]):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
def test_a_graphed_block_launches_the_fused_mlps_on_card(cuda_device):
    """The tiny scene of the test above through ``Trainer``: the field's
    MLPs run as the fused pair and never as the plain version, 2 forward and
    2 backward launches (coarse and fine) a step that runs on the host (the
    block's eager warm-up and its capture; replays are not counted), and
    ``Trainer.counters`` reports them under ``mlp_``."""
    cfg = TrainConfig(height=24, width=32, focal=26.0, near=0.0, far=1.0,
                      n_rays=256, lr=1e-2, lr_decay=0, ndc=True,
                      render=RenderConfig(n_coarse=16, n_fine=16, mlp=CFG,
                                          compute_dtype=torch.bfloat16))
    state = create_train_state(PRNGKey(1), lr=1e-2, lr_decay=0, mlp=CFG,
                               device=cuda_device)
    rng = np.random.default_rng(1)
    images = rng.random((3, 24, 32, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1))
    tr = Trainer(cfg, state, images, poses, [0, 1, 2], steps_per_call=4)
    before = dict(nm.stats)
    m = tr.run(0, 12)
    assert np.isfinite(m["loss"])
    runner = tr.scan_fn.runner.stats
    assert runner["replayed_steps"] == 12 and runner["captures"] == 1
    # One eager warm-up step and one captured step.
    hosted = 2 * runner["captures"]
    assert nm.stats["fwd_launches"] - before["fwd_launches"] == 2 * hosted
    assert nm.stats["bwd_launches"] - before["bwd_launches"] == 2 * hosted
    assert nm.stats["plain_calls"] == before["plain_calls"]
    counters = tr.counters()
    assert counters["mlp_fwd_launches"] == nm.stats["fwd_launches"]
    assert counters["mlp_plain_calls"] == nm.stats["plain_calls"]
