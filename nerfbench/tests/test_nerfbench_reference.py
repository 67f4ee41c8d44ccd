"""The plain reference held to the port at a tiny size on the CPU: its
draws bitwise, a frame, and three steps of a block (float32, where the two
differ only in the order of float operations)."""

import copy

import numpy as np
import pytest
import torch
from conftest import tiny

from nerfbench import harness, scene
from nerfbench.families import nerf
from nerfbench.reference import common
from nerfbench.reference import nerf as ref
from nerfbench.reference import rng as rrng

CONFIGS = ["nerf-blender-lego", "nerf-llff-fern"]


def cfg_of(name, **extra):
    return tiny(harness.load("configs", name), dtype="float32", **extra)


def test_draws_are_the_ports():
    from cvnerf_torch.ops import rng as prng
    key = prng.fold_in(prng.PRNGKey(2 ** 31 - 5), 777)
    mine = rrng.fold_in(rrng.prng_key(2 ** 31 - 5), 777)
    assert key.tolist() == mine.tolist()
    pk, mk = prng.split(key, 3), rrng.split(mine, 3)
    assert pk.tolist() == mk.tolist()
    assert (prng.randint(pk[0], (5,), 0, 97).numpy()
            == rrng.randint(mk[0], 5, 0, 97)).all()
    for m in (400 * 400, 378 * 504, 100):
        assert (prng.sample_without_replacement(pk[1], 64, m).numpy()
                == rrng.without_replacement(mk[1], 64, m)).all()
    ids = torch.arange(300, 364)
    assert (prng.ray_uniform(pk[2], 1, ids, 64).numpy()
            == rrng.uniforms(mk[2], 1, ids.numpy(), 64)).all()
    assert torch.equal(prng.ray_sorted_uniform(pk[2], 2, ids, 127),
                       rrng.sorted_uniforms(mk[2], 2, ids.numpy(), 127))
    assert torch.equal(prng.ray_normal(pk[2], 4, ids, 191),
                       rrng.normals(mk[2], 4, ids.numpy(), 191))


@pytest.mark.parametrize("name", CONFIGS)
def test_frame_matches_the_port(name, tmp_path):
    cfg = cfg_of(name)
    gen = torch.Generator().manual_seed(3)
    params = nerf.init_params(cfg, gen, "cpu")
    ckpt = nerf.write_checkpoint(params, str(tmp_path / "nets.pt"))
    renderer = nerf.load_renderer(cfg, ckpt, torch.device("cpu"))
    pose = scene.request_poses(cfg, gen, 1, "cpu")[0]
    got = renderer.render_pose(pose.numpy())
    want = ref.render_frame(params, cfg, pose, chunk=100)
    assert got.shape == (cfg["H"], cfg["W"], 3)
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_three_block_steps_match_the_port(name):
    from cvnerf_torch.train.loop import Trainer
    from cvnerf_torch.train.state import TrainState, make_optimizer
    cfg = cfg_of(name)
    gen = torch.Generator().manual_seed(5)
    sc = scene.make_scene(cfg, gen, "cpu")
    params0 = nerf.init_params(cfg, gen, "cpu")
    tcfg = nerf.port_train_config(cfg)
    state = TrainState(params=copy.deepcopy(params0),
                       opt_state=make_optimizer(tcfg.lr, tcfg.lr_decay)
                       .init(params0), step=500)
    trainer = Trainer(tcfg, state, sc["images"], sc["poses"],
                      sc["train_idx"], seed=99, steps_per_call=3)
    loss = trainer.run(500, 503)["loss"]
    assert trainer.scan_fn.runner.stats["eager_steps"] == 3
    st = ref.fresh_state(copy.deepcopy(params0))
    data = {"images": sc["images"], "poses": sc["poses"],
            "train_idx": sc["train_idx"]}
    for step in range(500, 503):
        st, out = ref.train_step(st, cfg, data, 99, step)
    assert abs(float(out["loss"]) - loss) <= 1e-6 * loss
    for got, want in zip(ref.leaves(trainer.state.params),
                         ref.leaves(st["params"])):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    for got, want in zip(ref.leaves(trainer.state.opt_state.mu),
                         ref.leaves(st["mu"])):
        torch.testing.assert_close(got, want, atol=1e-7, rtol=1e-4)


def test_the_control_rounds_every_product_to_float8():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 5, 6, generator=gen, requires_grad=True)
    w = torch.randn(6, 3, generator=gen, requires_grad=True)
    g = torch.randn(4, 5, 3, generator=gen)
    y = common.fp8(x, w)
    y.backward(g)
    xq, wq, gq = (common.round8(t.detach()) for t in (x, w, g))
    assert torch.equal(y, xq @ wq)
    assert torch.equal(x.grad, gq @ wq.T)
    torch.testing.assert_close(w.grad, torch.einsum("rsi,rso->io", xq, gq))
    assert len(torch.unique(xq)) < len(torch.unique(x.detach()))

