"""The frame program on the card (``render/frames.py``): a replayed frame
is bitwise the frame the program's body renders eagerly, for the pose it
was captured with and for another, and a new focal, near, far, key,
nets or grid of the same shapes replays the one capture and moves the
frame (a value frozen at capture would not). Needs an NVIDIA card; skipped without
one (a CUDA graph and the kernels have no CPU mode). Run on the card with
``python3 -m pytest --noconftest tests/test_torch_port_frame_program_cuda.py``
(``tests/conftest.py`` imports JAX, which the card's machine lacks)."""

import numpy as np
import pytest
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
from cvnerf_torch.ops.fused_mlp import FusedNerfWeights
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.frames import FramePrograms
from cvnerf_torch.render.occupancy import OccupancyGrid
from cvnerf_torch.render.renderer import RenderConfig

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=32)
POSES = [np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4], [0, 0.6, 0.8, 3.2]],
                  np.float32),
         np.array([[0.8, 0, 0.6, 2.4], [0, 1, 0, 0.1], [-0.6, 0, 0.8, 3.2]],
                  np.float32)]


def _nets(mlp, dtype, device, seed=0):
    nets = {}
    for i, net in enumerate(("coarse", "fine")):
        p = init_nerf_params(PRNGKey(seed + i), mlp, device)
        p["alpha"]["b"] += 1.0
        nets[net] = FusedNerfWeights(p, mlp, dtype)
    return nets


def _ball(device, res=12):
    """A dense ball (sigma 40) in empty space."""
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.where(x * x + y * y + z * z < 0.36, 40.0, 0.0)
    return OccupancyGrid(
        values=torch.tensor(vals, dtype=torch.float32, device=device),
        bbox_min=torch.full((3,), -1.0, device=device),
        inv_spacing=torch.full((3,), (res - 1) / 2.0, device=device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_replay_is_bitwise_its_eager_frame(cuda_device, dtype):
    mlp = NerfMLPConfig(**TINY)
    nets = _nets(mlp, dtype, cuda_device)
    cfg = RenderConfig(n_coarse=16, n_fine=32, white_bkg=True, mlp=mlp,
                       compute_dtype=dtype, deterministic_resample=False
                       ).eval_mode()
    programs = FramePrograms()

    def frame(pose, key):
        return programs(nets, 24, 32, 30.0, torch.from_numpy(pose), 2.0,
                        6.0, cfg, device=cuda_device,
                        take=lambda out: {k: v.clone()
                                          for k, v in out.items()},
                        chunk=256, key=key)
    first = frame(POSES[0], PRNGKey(5))          # eager, then captured
    again = frame(POSES[0], PRNGKey(5))          # a replay
    other = frame(POSES[1], PRNGKey(6))          # a replay, new inputs
    (prog,) = programs.programs
    prog.load(nets, 30.0, torch.from_numpy(POSES[1]), 2.0, 6.0,
              PRNGKey(6), None)
    prog._body()
    torch.cuda.synchronize()
    assert prog.stats["captures"] == 1 and prog.stats["replays"] == 2
    for k in first:
        assert torch.equal(first[k], again[k]), k
        assert torch.equal(other[k], prog.out[k]), k
    assert not torch.equal(first["rgb"], other["rgb"])


@pytest.mark.cuda
def test_traced_inputs_replay_one_capture_and_the_output_follows(
        cuda_device):
    """A new pose, key, focal, near, far, new nets and a grid of the same
    shape (its values scaled) each replay the one captured program: the
    replay is bitwise the program's body run eagerly on the same buffers,
    and the frame moves off the first one."""
    mlp = NerfMLPConfig(**TINY)
    nets = _nets(mlp, torch.bfloat16, cuda_device)
    grid = _ball(cuda_device)
    cfg = RenderConfig(n_coarse=16, n_fine=32, white_bkg=True, mlp=mlp,
                       compute_dtype=torch.bfloat16, occupancy_mode="full",
                       occupancy_interp="trilinear",
                       deterministic_resample=False).eval_mode()
    programs = FramePrograms()
    base = dict(nets=nets, focal=30.0, pose=POSES[0], near=2.0, far=6.0,
                key=PRNGKey(5), grid=grid)

    def inputs(change):
        x = {**base, **change}
        return (x["nets"], x["focal"], torch.from_numpy(x["pose"]),
                x["near"], x["far"], x["key"], x["grid"])

    def frame(change):
        n, focal, c2w, near, far, key, g = inputs(change)
        return programs(n, 24, 32, focal, c2w, near, far, cfg,
                        device=cuda_device,
                        take=lambda out: {k: v.clone()
                                          for k, v in out.items()},
                        chunk=256, key=key, occupancy=g)
    first = frame({})                            # eager, then captured
    (prog,) = programs.programs
    changes = [dict(pose=POSES[1]), dict(key=PRNGKey(6)), dict(focal=26.0),
               dict(near=2.4), dict(far=4.5),
               dict(nets=_nets(mlp, torch.bfloat16, cuda_device, seed=7)),
               dict(grid=OccupancyGrid(grid.values * 0.5, grid.bbox_min,
                                       grid.inv_spacing))]
    for change in changes:
        got = frame(change)                      # a replay
        prog.load(*inputs(change))
        prog._body()
        torch.cuda.synchronize()
        for k in got:
            assert torch.equal(got[k], prog.out[k]), (change, k)
        assert not torch.equal(got["rgb"], first["rgb"]), change
    assert programs.programs == [prog]
    assert prog.stats["captures"] == 1
    assert prog.stats["replays"] == len(changes)


@pytest.mark.cuda
def test_the_plain_mlp_renders_eagerly_through_its_program(cuda_device):
    """A ``kernels="off"`` program is not captured (no graph pool keeps the
    plain MLP's intermediates): its frames run the body eagerly, each the
    oracle of its own pose."""
    mlp = NerfMLPConfig(**TINY)
    nets = {net: init_nerf_params(PRNGKey(i), mlp, cuda_device)
            for i, net in enumerate(("coarse", "fine"))}
    cfg = RenderConfig(n_coarse=16, n_fine=32, white_bkg=True, mlp=mlp,
                       kernels="off", deterministic_resample=True
                       ).eval_mode()
    programs = FramePrograms()
    outs = [programs(nets, 24, 32, 30.0, torch.from_numpy(p), 2.0, 6.0, cfg,
                     device=cuda_device,
                     take=lambda out: {k: v.clone() for k, v in out.items()},
                     chunk=256)
            for p in POSES]
    (prog,) = programs.programs
    assert prog.eager_reason is not None and prog.graph is None
    assert prog.stats["captures"] == 0 and prog.stats["eager_frames"] == 2
    prog.load(nets, 30.0, torch.from_numpy(POSES[0]), 2.0, 6.0, None, None)
    prog._body()
    for k in outs[0]:
        assert torch.equal(outs[0][k], prog.out[k]), k
