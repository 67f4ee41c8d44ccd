"""The frame program (``cvnerf_torch/render/frames.py``): a frame as one
program, the port's counterpart of the JAX package's jitted
``render_image`` and its ``lax.map`` over chunks.

On the CPU a program runs its body eagerly through the same static
buffers the card's CUDA graph reads, so these tests see what the card
sees: the inputs copied in, the outputs overwritten by the next frame.

* Every frame variant (fp32 and bf16 nets, int8 nets, occupancy ``merge``
  and ``full`` with both probes, ``occ_floor`` and the ``occ_term`` march,
  the stochastic resample, a two-shard mesh, NDC) renders bitwise what a
  chunk-by-chunk ``render_rays`` written here renders from the same
  inputs, and within the existing tolerances of JAX ``render_image``
  (``pallas="off"``): rgb/acc 1e-4, depth 1e-3 (``test_torch_port_render``);
  through a grid 1e-5 / 1e-3 (``test_torch_port_occupancy``); int8 1e-5 /
  1e-3 (``test_torch_port_quantize``); bf16 2e-2 / 0.1 (``chip_smoke.py``
  phase 4's bf16 tolerances: the frameworks round the same bf16 operands
  but sum in another order).
* A frame of every variant reads no tensor's value on the host.
* The signature: what JAX traces replays one program, what it holds
  static makes another; the cache is bounded.
* No frame is lost: a pose sequence equals single frames bitwise, also
  under the server's micro-batching.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvnerf_tpu.models.nerf_mlp import NerfMLPConfig as JaxCfg
from cvnerf_tpu.models.nerf_mlp import init_nerf_params as jax_init
from cvnerf_tpu.ops import quantize as jq
from cvnerf_tpu.render import occupancy as jocc
from cvnerf_tpu.render.frames import render_image as jax_render_image
from cvnerf_tpu.render.renderer import RenderConfig as JaxRender
from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.fused_mlp import FusedNerfWeights
from cvnerf_torch.ops.fused_mlp_int8 import QuantizedNerfWeights
from cvnerf_torch.ops.rays import ndc_rays, ray_grid
from cvnerf_torch.ops.rng import PRNGKey, split
from cvnerf_torch.parallel.mesh import make_mesh, ray_sharding
from cvnerf_torch.render import frames
from cvnerf_torch.render.frames import (MAX_PROGRAMS, FramePrograms,
                                        render_image, render_poses_to_frames)
from cvnerf_torch.render.occupancy import OccupancyGrid
from cvnerf_torch.render.renderer import RenderConfig, render_rays
from cvnerf_torch.utils.convert import (params_from_jax,
                                        quantized_params_from_jax)

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=32)
KEYS = ("rgb", "rgb_coarse", "acc", "depth")
H, W, FOCAL, CHUNK = 5, 7, 7.0, 16          # 35 rays: 3 chunks, 13 padded
POSE = np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4], [0, 0.6, 0.8, 3.2]],
                np.float32)
POSE2 = np.array([[0.8, 0, 0.6, 2.4], [0, 1, 0, 0.1], [-0.6, 0, 0.8, 3.2]],
                 np.float32)
NDC_POSE = np.array([[1, 0, 0, 0.05], [0, 1, 0, 0.02], [0, 0, 1, 0.1]],
                    np.float32)

# name -> (RenderConfig changes, kind of nets, grid?, mesh?, ndc?)
VARIANTS = {
    "fp32": (dict(), "float", False, False, False),
    "bf16": (dict(compute_dtype=torch.bfloat16), "float", False, False,
             False),
    "int8": (dict(), "int8", False, False, False),
    "merge_nearest": (dict(), "float", True, False, False),
    "merge_trilinear": (dict(occupancy_interp="trilinear"), "float", True,
                        False, False),
    "full_nearest": (dict(occupancy_mode="full"), "float", True, False,
                     False),
    "full_trilinear": (dict(occupancy_mode="full",
                            occupancy_interp="trilinear"), "float", True,
                       False, False),
    "full_floor": (dict(occupancy_mode="full", occ_floor=4), "float", True,
                   False, False),
    "full_term": (dict(occupancy_mode="full", occupancy_termination=1e-3,
                       termination_probes=32, n_coarse=6, n_fine=10),
                  "float", True, False, False),
    "int8_merge": (dict(), "int8", True, False, False),
    "stochastic": (dict(deterministic_resample=False), "float", False,
                   False, False),
    "two_shards": (dict(), "float", False, True, False),
    "ndc": (dict(), "float", False, False, True),
}


def _jax_params(seed=0, bias=1.0):
    cfg = JaxCfg(**TINY)
    p = {"coarse": jax_init(jax.random.PRNGKey(seed), cfg),
         "fine": jax_init(jax.random.PRNGKey(seed + 1), cfg)}
    for net in p.values():   # some opacity, so the resample has structure
        net["alpha"]["b"] = net["alpha"]["b"] + bias
    return jax.tree.map(np.asarray, p)


def _jax_grid(res=12):
    """A dense ball (sigma 40) in empty space, as in
    ``test_torch_port_occupancy``."""
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.where(x * x + y * y + z * z < 0.36, 40.0, 0.0)
    return jocc.OccupancyGrid(
        values=jnp.asarray(vals, jnp.float32),
        bbox_min=jnp.full((3,), -1.0, jnp.float32),
        inv_spacing=jnp.full((3,), (res - 1) / 2.0, jnp.float32))


def _grid(g) -> OccupancyGrid:
    return OccupancyGrid(*(torch.from_numpy(np.array(x)) for x in g))


def _quantized(jp):
    cfg = JaxCfg(**TINY)
    pts, dirs = jq.calibration_samples(jax.random.PRNGKey(1), 2048,
                                       (-1.5,) * 3, (1.5,) * 3)
    return {k: jax.tree.map(np.asarray, jq.quantize_nerf(v, cfg, pts, dirs))
            for k, v in jp.items()}


def _case(name, seed=0):
    """The variant's (JAX params, JAX config, port nets, port config, JAX
    grid, port grid, mesh, ndc, pose, near, far, key)."""
    change, kind, with_grid, sharded, ndc = VARIANTS[name]
    jchange = {k: v for k, v in change.items() if k != "compute_dtype"}
    if "compute_dtype" in change:
        jchange["compute_dtype"] = jnp.bfloat16
    base = dict(n_coarse=8, n_fine=12, white_bkg=True,
                deterministic_resample=True)
    jcfg = dataclasses.replace(JaxRender(**base, mlp=JaxCfg(**TINY),
                                         pallas="off"), **jchange).eval_mode()
    tcfg = dataclasses.replace(RenderConfig(**base, mlp=NerfMLPConfig(**TINY)),
                               **change).eval_mode()
    jp = _jax_params(seed, bias=2.0 if with_grid else 1.0)
    if kind == "int8":
        jp = _quantized(jp)
        nets = {k: QuantizedNerfWeights(quantized_params_from_jax(v),
                                        tcfg.mlp) for k, v in jp.items()}
    else:
        nets = {k: FusedNerfWeights(v, tcfg.mlp, tcfg.compute_dtype)
                for k, v in params_from_jax(jp).items()}
    jg = _jax_grid() if with_grid else None
    mesh = make_mesh(devices=["cpu", "cpu"]) if sharded else None
    pose, near, far = (NDC_POSE, 0.0, 1.0) if ndc else (POSE, 2.0, 6.0)
    if with_grid:
        near, far = 1.5, 4.5
    return dict(jp=jp, jcfg=jcfg, nets=nets, cfg=tcfg, jg=jg,
                grid=_grid(jg) if with_grid else None, mesh=mesh, ndc=ndc,
                pose=pose, near=near, far=far, key=PRNGKey(3 + seed))


def _frame(c, programs, pose=None, **over):
    """One frame of case ``c`` through ``programs``, copied out."""
    kw = dict(nets=c["nets"], focal=FOCAL, near=c["near"], far=c["far"],
              key=c["key"], grid=c["grid"])
    kw.update(over)
    pose = c["pose"] if pose is None else pose
    return programs(kw["nets"], H, W, kw["focal"], torch.from_numpy(pose),
                    kw["near"], kw["far"], c["cfg"], device="cpu",
                    take=lambda out: {k: v.clone() for k, v in out.items()},
                    ndc=c["ndc"], chunk=CHUNK, key=kw["key"],
                    occupancy=kw["grid"], mesh=c["mesh"])


def _oracle(c, pose=None, focal=FOCAL, near=None, far=None, key=None,
            nets=None, grid=None):
    """The frame chunk by chunk (and shard by shard) through
    ``render_rays``, the scalars as 0-d float32 tensors as the program
    reads them."""
    pose = torch.from_numpy(c["pose"] if pose is None else pose)
    nets = c["nets"] if nets is None else nets
    grid = c["grid"] if grid is None else grid
    key = c["key"] if key is None else key
    f, n, fa = (torch.tensor(v, dtype=torch.float32) for v in (
        focal, c["near"] if near is None else near,
        c["far"] if far is None else far))
    rays_o, rays_d = ray_grid(H, W, f, pose)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if c["ndc"]:
        rays_o, rays_d = ndc_rays(H, W, f, 1.0, rays_o, rays_d)
    n_rays = H * W
    pad = -n_rays % CHUNK
    rays = [torch.cat([x, x.new_zeros(pad, 3)])
            for x in (rays_o, rays_d, viewdirs)]
    shards = ([ray_sharding(c["mesh"]).rows(CHUNK, s)
               for s in range(c["mesh"].size)] if c["mesh"] is not None
              else [slice(0, CHUNK)])
    parts = []
    for start in range(0, n_rays + pad, CHUNK):
        for rows in shards:
            sl = slice(start + rows.start, start + rows.stop)
            ids = torch.arange(sl.start, sl.stop, dtype=torch.int64)
            parts.append(render_rays(nets, *(x[sl] for x in rays), n, fa,
                                     c["cfg"], key=key, ray_ids=ids,
                                     occupancy=grid))
    return {k: torch.cat([p[k] for p in parts])[:n_rays]
            .reshape(H, W, *parts[0][k].shape[1:]) for k in parts[0]}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _tolerances(name):
    change, kind, with_grid, _, _ = VARIANTS[name]
    if "compute_dtype" in change:
        return 2e-2, 1e-1
    if kind == "int8" or with_grid:
        return 1e-5, 1e-3
    return 1e-4, 1e-3


@pytest.mark.parametrize("name", list(VARIANTS))
def test_every_frame_variant_is_its_chunk_loop_and_jax(name):
    """The program's frame is bitwise the chunk-by-chunk oracle, a second
    frame from the same inputs bitwise the first (the replay's inputs are
    the copied-in buffers), and the frame within the tolerances above of
    JAX ``render_image``."""
    c = _case(name)
    programs = FramePrograms()
    got = _frame(c, programs)
    _assert_equal(got, _oracle(c))
    _assert_equal(_frame(c, programs), got)
    assert len(programs.programs) == 1
    want = jax_render_image(jax.random.PRNGKey(3), c["jp"], H, W, FOCAL,
                            jnp.asarray(c["pose"]), c["near"], c["far"],
                            c["jcfg"], ndc=c["ndc"], chunk=CHUNK,
                            occupancy=c["jg"])
    tol, tol_depth = _tolerances(name)
    keys = ("rgb", "acc", "depth") if c["grid"] is not None else KEYS
    for k in keys:
        t = tol_depth if k == "depth" else tol
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=t, atol=t, err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_a_frame_reads_no_device_value_on_the_host(name, monkeypatch):
    """A frame of every variant with ``item``, ``tolist``, ``__bool__``,
    ``__int__`` and ``__float__`` raising (every way the frame could read
    a tensor's value on the host, each a sync a capture refuses) renders,
    and equals the same frame rendered normally."""
    c = _case(name)
    want = _frame(c, FramePrograms())

    def refuse(*_a, **_k):
        raise AssertionError("a frame read a tensor's value on the host")
    for attr in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    programs = FramePrograms()
    got = [_frame(c, programs), _frame(c, programs, pose=POSE2)]
    monkeypatch.undo()
    _assert_equal(got[0], want)
    _assert_equal(got[1], _oracle(c, pose=POSE2))


def test_traced_inputs_replay_one_program_and_the_output_follows():
    """A new pose, key, focal, near, far, new weights and a new grid of the
    same shapes render through the one program, each frame bitwise the
    oracle of its own inputs; the old output buffer is the program's and
    is overwritten by the next frame."""
    c = _case("full_trilinear")
    c["cfg"] = dataclasses.replace(c["cfg"], perturb=True)
    programs = FramePrograms()
    first = _frame(c, programs)
    prog = programs.programs[0]
    static = prog.out["rgb"]
    other = _case("full_trilinear", seed=5)
    grid2 = dataclasses.replace(c["grid"], values=c["grid"].values * 0.5)
    changes = [dict(pose=POSE2), dict(key=PRNGKey(9)), dict(focal=8.5),
               dict(near=1.7), dict(far=4.0), dict(nets=other["nets"]),
               dict(grid=grid2)]
    for change in changes:
        pose = change.pop("pose", None)
        got = _frame(c, programs, pose=pose, **change)
        _assert_equal(got, _oracle(c, pose=pose, **change))
        assert not torch.equal(got["rgb"], first["rgb"]), change
        torch.testing.assert_close(static, got["rgb"], rtol=0, atol=0)
    assert programs.programs == [prog]
    assert prog.stats["eager_frames"] == 1 + len(changes)


def test_static_arguments_make_new_programs_and_the_bound_evicts():
    """Another height and width (``factor``), int8 nets, a grid of another
    resolution, a key or none each make a program of their own; past
    ``MAX_PROGRAMS`` the least recently used program is dropped with its
    buffers."""
    c = _case("merge_nearest")
    programs = FramePrograms()
    _frame(c, programs)
    render_poses_to_frames(c["nets"], [POSE], H, W, FOCAL, c["near"],
                           c["far"], c["cfg"], chunk=CHUNK, factor=2,
                           device="cpu", key=c["key"], occupancy=c["grid"],
                           programs=programs)
    assert len(programs.programs) == 2
    q = _case("int8_merge")
    _frame(q, programs)
    _frame(c, programs, grid=_grid(_jax_grid(res=9)))
    _frame(c, programs, key=None)
    assert len(programs.programs) == 5
    first = programs.programs[0]
    for i in range(MAX_PROGRAMS):
        programs(c["nets"], 1 + i, W, FOCAL, torch.from_numpy(POSE), 2.0,
                 6.0, c["cfg"], device="cpu", take=lambda out: None,
                 chunk=CHUNK, occupancy=c["grid"])
    assert len(programs.programs) == MAX_PROGRAMS
    assert first not in programs.programs and first.out is None


def test_a_pose_sequence_loses_no_frame():
    """``render_poses_to_frames`` on 3 poses with one frame in flight is
    bitwise 3 single ``render_image`` calls (a stochastic configuration:
    pose ``i`` keyed ``split(key, 3)[i]``), every output key."""
    c = _case("stochastic")
    poses = [POSE, POSE2, NDC_POSE * [1, 1, 1, 40]]
    seq = render_poses_to_frames(c["nets"], poses, H, W, FOCAL, 2.0, 6.0,
                                 c["cfg"], chunk=CHUNK, frame_keys=KEYS,
                                 device="cpu", key=c["key"])
    keys = split(c["key"], 3)
    for i, pose in enumerate(poses):
        one = render_image(c["nets"], H, W, FOCAL, torch.from_numpy(pose),
                           2.0, 6.0, c["cfg"], chunk=CHUNK, key=keys[i])
        for k in KEYS:
            np.testing.assert_array_equal(seq[k][i], one[k].numpy())
    assert not np.array_equal(seq["rgb"][0], seq["rgb"][1])


def _renderer(tmp_path):
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.train.checkpoint import save_checkpoint
    from cvnerf_torch.train.state import create_train_state
    state = create_train_state(PRNGKey(3), mlp=NerfMLPConfig(**TINY),
                               device="cpu")
    for net in state.params.values():
        net["alpha"]["b"] += 1.0
    save_checkpoint(str(tmp_path), state)
    return NerfRenderer(str(tmp_path / "000000.pt"), height=H, width=W,
                        focal=FOCAL, near=2.0, far=6.0,
                        cfg=RenderConfig(n_coarse=8, n_fine=12,
                                         mlp=NerfMLPConfig(**TINY)),
                        chunk=CHUNK, device="cpu")


def test_served_frames_are_not_the_programs_buffers(tmp_path):
    """A frame ``render_pose`` returned is the caller's: the next frame,
    which overwrites the program's outputs, leaves it as it was."""
    r = _renderer(tmp_path)
    a = r.render_pose_extras(POSE, keys=KEYS)
    keep = {k: v.copy() for k, v in a.items()}
    b = r.render_pose_extras(POSE2, keys=KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(a[k], keep[k])
    assert not np.array_equal(a["rgb"], b["rgb"])


def test_micro_batched_server_frames_equal_single_frames(tmp_path):
    """Three ``/render`` jobs queued together: the server's worker renders
    them as one ``render_poses_extras`` sequence, bitwise three
    ``render_pose_extras`` calls."""
    from cvnerf_torch.server import DeviceQueue
    r = _renderer(tmp_path)
    poses = [POSE, POSE2, POSE * [1, 1, 1, 1.1]]
    batches = []
    batched = r.render_poses_extras

    def spy(p, **kw):
        batches.append(len(p))
        return batched(p, **kw)
    r.render_poses_extras = spy
    q = DeviceQueue(r, batch_max=8)
    try:
        with q._cv:              # the worker takes all three at once
            jobs = [q.submit_async(p, 0, KEYS) for p in poses]
        outs = [q.wait(j, timeout=120) for j in jobs]
    finally:
        q.close()
    assert batches == [3]
    for pose, got in zip(poses, outs):
        want = r.render_pose_extras(pose, keys=KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k])
    assert len(r.programs.programs) == 1


def test_render_image_returns_copies_and_the_default_cache_is_bounded():
    """``render_image`` hands out copies (a later frame does not change an
    earlier result) through this module's cache."""
    c = _case("fp32")
    a = render_image(c["nets"], H, W, FOCAL, torch.from_numpy(POSE), 2.0,
                     6.0, c["cfg"], chunk=CHUNK)
    keep = {k: v.clone() for k, v in a.items()}
    render_image(c["nets"], H, W, FOCAL, torch.from_numpy(POSE2), 2.0, 6.0,
                 c["cfg"], chunk=CHUNK)
    _assert_equal(a, keep)
    assert 1 <= len(frames._PROGRAMS.programs) <= MAX_PROGRAMS


def test_concurrent_callers_get_their_own_frames():
    """Frames from several threads through one cache are serialized by its
    lock: each thread's frame is the oracle of its own pose."""
    c = _case("fp32")
    programs = FramePrograms()
    poses = [POSE, POSE2, POSE * [1, 1, 1, 1.1], POSE2 * [1, 1, 1, 0.9]]
    got: dict = {}

    def work(i):
        for _ in range(3):
            got[i] = _frame(c, programs, pose=poses[i])
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, pose in enumerate(poses):
        _assert_equal(got[i], _oracle(c, pose=pose))
