"""The Instant-NGP field's kernels on the card (``ops/hash_encode.py``,
``csrc/hash_encode.cu``; the skip-zero and L2 rules of ``csrc/adam.cu``) at
the published widths (16 levels, 2^19 entries a level, 12,196,240 table
values) and a train step's 2^18 samples: the forward bitwise its plain
version on the same card, the backward within float32 rounding of it (its
atomic adds sum in no fixed order), Adam over the field's 21 leaves bitwise
``adam_plain``, and a graphed block of train steps launching the kernels.
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
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.train.loop import TrainConfig, Trainer
from cvnerf_torch.train.state import (Adam, TrainState, create_train_state,
                                      make_optimizer, tree_leaves)

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
