"""Full-image and pose-sequence rendering (port of
the JAX package's ``render/frames.py``).

A frame is one program, as the JAX package's jitted ``render_image`` is.
:class:`FramePrograms` keys a :class:`FrameProgram` by what JAX holds
static (height, width, ``RenderConfig``, ndc, ndc_variant, chunk, mesh),
the kinds and shapes of the nets and of the grid, and whether a key is
passed; everything JAX traces (the pose, the key, focal, near, far, the
nets' and the grid's values) is copied into the program's static buffers
before each frame. The program builds the ray grid from the pose buffer,
normalizes the pre-NDC view directions, optionally warps to NDC and
renders the rays in chunks (``render_rays_chunked``, the JAX ``lax.map``)
into static outputs. On a card the first frame of a program runs eagerly
on a side stream (it builds the kernels, and its outputs are that frame),
then the same body is captured in one CUDA graph, and every later frame is
one replay that reads nothing back to the host; on the CPU the same body
runs eagerly through the same buffers. The plain MLP (``kernels="off"``)
is not captured: its frames run the same body eagerly on the card too,
so no graph pool holds its intermediates. A new pose, key, focal, near, far,
or new weights or a new grid of the same shapes replay; another height or
width (a ``factor``), another config, int8 nets or a grid of another
resolution make another program.

``render_image`` returns copies of the outputs. ``render_poses_to_frames``
keeps one frame in flight: frame ``i``'s outputs are copied
asynchronously to pinned host memory before frame ``i+1`` is queued (which
overwrites the static outputs), and frame ``i`` is handed over while the
card renders ``i+1``. Both take a ``mesh`` (``parallel/mesh.py``): each
chunk's rays are then split over its shards, and across processes every
rank renders its shards and receives the whole frame. ``render`` is the
reference-shaped entry point: a frame from ``c2w=``, or an arbitrary ray
batch from ``rays=``, which renders eagerly (its shapes are the
caller's).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from cvnerf_torch import staged
from cvnerf_torch.ops.fused_mlp import FusedNerfWeights
from cvnerf_torch.ops.fused_mlp_int8 import QuantizedNerfWeights
from cvnerf_torch.ops.rays import ndc_rays, ray_grid
from cvnerf_torch.ops.rng import key_on, split
from cvnerf_torch.parallel.mesh import Mesh, Replicated, to_device
from cvnerf_torch.parallel.mesh import _norm as _device
from cvnerf_torch.render.renderer import RenderConfig, render_rays_chunked
from cvnerf_torch.utils import tracing
from cvnerf_torch.utils.graphs import GraphProgram

# Programs a cache holds; the least recently used beyond it is dropped
# with its graph's memory pool. A program holds a copy of its nets and
# grid, its outputs and, on a card, its graph's pool: the intermediates of
# one chunk's render, a few hundred MB at chunk 8192 (PERF.md, section 5).
MAX_PROGRAMS = 8


def _map_tensors(x: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``x`` rebuilt with ``fn`` applied to each of its tensors, in a fixed
    order: dicts, dataclasses (a grid, int8 params), packed kernel weights
    and :class:`Replicated` values."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Replicated):
        y = object.__new__(Replicated)
        y.copies = {d: _map_tensors(v, fn) for d, v in x.copies.items()}
        return y
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_tensors(getattr(x, f.name), fn)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (FusedNerfWeights, QuantizedNerfWeights)):
        y = copy.copy(x)
        for name, v in vars(x).items():
            setattr(y, name, _map_tensors(v, fn))
        return y
    return x


def _leaves(x: Any) -> list[torch.Tensor]:
    """The tensors of ``x``, in :func:`_map_tensors`' order."""
    out: list[torch.Tensor] = []
    _map_tensors(x, lambda t: out.append(t) or t)
    return out


def _kind(x: Any) -> tuple | None:
    """What a program's shapes depend on in nets or a grid: the types and
    each tensor's shape, dtype and device."""
    if x is None:
        return None
    types = (tuple((k, type(v).__name__) for k, v in x.items())
             if isinstance(x, dict) else type(x).__name__)
    return types, tuple((tuple(t.shape), t.dtype, t.device)
                        for t in _leaves(x))


class FrameProgram(GraphProgram):
    """One frame variant: static buffers for the dynamic inputs (a float32
    row of focal, near, far and the ``[3, 4]`` pose; the key words; a copy
    of the nets and of the grid), the static outputs ``[H, W, ...]``, and on
    a card the frame's CUDA graph. ``stats``: captures, replayed frames,
    eager frames (the first frame of a graphed program is one), capture
    seconds and the bytes the capture reserved (its pool)."""

    def __init__(self, device: torch.device, height: int, width: int,
                 cfg: RenderConfig, ndc: bool, ndc_variant: str, chunk: int,
                 mesh: Mesh | None, nets, occupancy, with_key: bool):
        super().__init__(f"frame program {height}x{width}",
                         "its frames render eagerly", replays=0,
                         eager_frames=0)
        self.device, self.height, self.width = device, height, width
        self.cfg, self.ndc, self.ndc_variant = cfg, ndc, ndc_variant
        self.chunk, self.mesh = chunk, mesh
        self.row = torch.zeros(15, dtype=torch.float32, device=device)
        self.key = (torch.zeros(2, dtype=torch.int64, device=device)
                    if with_key else None)
        self.nets = _map_tensors(nets, torch.clone)
        self.grid = _map_tensors(occupancy, torch.clone)
        self._dst = _leaves(self.nets) + _leaves(self.grid)
        self.out: dict[str, torch.Tensor] | None = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self._check_cards(device, mesh)
        if device.type == "cuda" and cfg.kernels == "off":
            self._eager("the plain MLP (kernels='off') is not captured")

    def load(self, nets, focal: float, c2w: torch.Tensor, near: float,
             far: float, key: torch.Tensor | None, occupancy) -> None:
        """Copy a frame's dynamic inputs (``c2w`` ``[3+, 4]``) into the
        static buffers: the scalars and a host pose through pinned memory
        (the host does not wait for the card's queue), a device pose, the
        key, the nets and the grid on the device. The nets and the grid
        are copied every frame (a few MB, a 192³ grid 28 MB): a caller's
        tensors may have changed in place since the last frame."""
        head = np.array([focal, near, far], np.float32)
        pose = c2w.detach()[:3, :4].float().reshape(12)
        if pose.device.type == "cpu":
            self.row.copy_(staged(np.concatenate([head, pose.numpy()]),
                                  self.device))
        else:
            self.row[:3].copy_(staged(head, self.device))
            self.row[3:].copy_(pose)
        if self.key is not None:
            self.key.copy_(key_on(key, self.device))
        if self._dst:
            torch._foreach_copy_(self._dst,
                                 _leaves(nets) + _leaves(occupancy))

    def _body(self) -> None:
        """The frame from the static buffers into the static outputs."""
        h, w = self.height, self.width
        focal, near, far = self.row[0], self.row[1], self.row[2]
        rays_o, rays_d = ray_grid(h, w, focal, self.row[3:].view(3, 4))
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if self.ndc:
            rays_o, rays_d = ndc_rays(h, w, focal, 1.0, rays_o, rays_d,
                                      variant=self.ndc_variant)
        res = render_rays_chunked(self.nets, rays_o, rays_d, viewdirs, near,
                                  far, self.cfg, chunk=self.chunk,
                                  key=self.key, occupancy=self.grid,
                                  mesh=self.mesh)
        if self.out is None:
            self.out = {k: v.new_empty(h, w, *v.shape[1:])
                        for k, v in res.items()}
        for k, v in res.items():
            self.out[k].copy_(v.reshape(self.out[k].shape))

    def run(self) -> dict[str, torch.Tensor]:
        """Render the loaded frame into the static outputs and return them
        (the next frame overwrites them); spans ``frame.eager``,
        ``frame.capture`` or ``frame.replay``."""
        if self.device.type != "cuda" or self.eager_reason is not None:
            with tracing.span("frame.eager"):
                self._body()
            self.stats["eager_frames"] += 1
        elif self.graph is None:
            # The warm-up renders this frame; its capture, the next ones.
            with tracing.span("frame.capture"):
                captured = self._capture(self.device, self.mesh,
                                         "all_gather", self._body)
            self.stats["eager_frames"] += 1
            if captured is not None:
                self.graph = captured[0]
        else:
            with tracing.span("frame.replay"):
                self._replay(self.graph)
            self.stats["replays"] += 1
        return self.out

    def close(self) -> None:
        """Drop the graph and the static buffers (the graph's pool is freed
        with the last tensor allocated from it)."""
        self.graph = self.out = self.nets = self.grid = None
        self._dst = []


class FramePrograms:
    """A bounded cache of frame programs (at most ``MAX_PROGRAMS``, the
    least recently used dropped first, its graph's pool with it), the port's
    counterpart of ``jax.jit``'s cache of ``render_image``. One lock
    serializes frames: a program's static buffers hold one frame at a
    time. ``NerfRenderer`` and the CLI each hold one; ``render_image``
    renders through one of this module's. ``stats`` counts ``evictions``
    (a program dropped; its shape captures again when it comes back).
    With ``utils.tracing`` on, each frame is a ``frame`` span holding
    ``frame.lock`` (the wait for the lock), ``frame.load``, the program's
    run and ``frame.take``."""

    def __init__(self):
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"evictions": 0}

    @property
    def programs(self) -> list[FrameProgram]:
        """The cached programs, least recently used first."""
        return list(self._programs.values())

    @torch.no_grad()
    def __call__(self, nets, height: int, width: int, focal: float,
                 c2w: torch.Tensor, near: float, far: float,
                 cfg: RenderConfig, *, device: str | torch.device,
                 take: Callable[[dict], Any], ndc: bool = False,
                 ndc_variant: str = "canonical", chunk: int = 4096,
                 key: torch.Tensor | None = None, occupancy=None,
                 mesh: Mesh | None = None) -> Any:
        """Render one ``[H, W]`` frame from a ``[3+, 4]`` pose ``c2w`` (on
        the host or on ``device``) on ``device`` (with ``mesh``, on its
        shards), and return ``take(outputs)``: ``take`` runs under the
        lock and must copy what it keeps, since the next frame overwrites
        the outputs. The nets and the grid lie on ``device`` or are
        ``replicate_to_mesh`` values of ``mesh``."""
        cfg.check_supported()
        dev = _device(device)
        if mesh is None:
            nets, occupancy = to_device(nets, dev), to_device(occupancy, dev)
        sig = (dev, height, width, cfg, ndc, ndc_variant, chunk, mesh,
               _kind(nets), _kind(occupancy), key is not None)
        with tracing.span("frame"):
            with tracing.span("frame.lock"):
                self._lock.acquire()
            try:
                prog = self._programs.pop(sig, None)
                if prog is None:
                    while len(self._programs) >= MAX_PROGRAMS:
                        self._programs.popitem(last=False)[1].close()
                        self.stats["evictions"] += 1
                    prog = FrameProgram(dev, height, width, cfg, ndc,
                                        ndc_variant, chunk, mesh, nets,
                                        occupancy, key is not None)
                self._programs[sig] = prog
                with tracing.span("frame.load"):
                    prog.load(nets, focal, c2w, near, far, key, occupancy)
                out = prog.run()
                with tracing.span("frame.take"):
                    return take(out)
            finally:
                self._lock.release()


_PROGRAMS = FramePrograms()


def _copies(out: dict) -> dict:
    return {k: v.clone() for k, v in out.items()}


def render_image(params: dict, height: int, width: int, focal: float,
                 c2w: torch.Tensor, near: float, far: float,
                 cfg: RenderConfig, ndc: bool = False,
                 ndc_variant: str = "canonical",
                 chunk: int = 4096, key: torch.Tensor | None = None,
                 occupancy=None, mesh: Mesh | None = None) -> dict:
    """Render one ``[H, W]`` frame from a ``[3, 4]`` pose through a frame
    program of this module's cache (at most ``MAX_PROGRAMS``); the frame is
    rendered on ``c2w``'s device (with ``mesh``, on its shards' devices,
    and returned on ``c2w``'s). ``key`` (``ops.rng``) keys the draws of a
    stochastic configuration; ``occupancy`` is a baked grid the frame
    renders through. Returns ``rgb``, ``rgb_coarse``, ``acc`` and
    ``depth`` as new tensors of shape ``[H, W, ...]``."""
    return _PROGRAMS(params, height, width, focal, c2w, near, far, cfg,
                    device=c2w.device, take=_copies, ndc=ndc,
                    ndc_variant=ndc_variant, chunk=chunk, key=key,
                    occupancy=occupancy, mesh=mesh)


@torch.no_grad()
def render(params: dict, height: int, width: int, focal: float,
           chunk: int = 4096, rays=None, c2w=None, ndc: bool = True,
           near: float = 0.0, far: float = 1.0,
           cfg: RenderConfig = RenderConfig(),
           ndc_variant: str = "canonical",
           key: torch.Tensor | None = None):
    """The reference-shaped entry point (the JAX package's ``render``):
    a full image from ``c2w`` (``[3+, 4]``, through ``render_image``), or
    an ``(origins, directions)`` ray batch of any leading shape from
    ``rays``, exactly one of the two; a ray batch renders eagerly through
    ``render_rays_chunked``. ``ndc`` defaults to True, as in the
    reference: pass ``ndc=False`` for anything that is not a
    forward-facing LLFF scene. Returns ``(rgb, extras)``, ``extras``
    holding ``rgb_coarse``, ``acc`` and ``depth``."""
    if (rays is None) == (c2w is None):
        raise ValueError("provide exactly one of rays= or c2w=")
    if c2w is not None:
        out = render_image(params, height, width, focal,
                           torch.as_tensor(c2w, dtype=torch.float32)[:3, :4],
                           near, far, cfg, ndc=ndc, ndc_variant=ndc_variant,
                           chunk=chunk, key=key)
    else:
        rays_o, rays_d = (torch.as_tensor(x, dtype=torch.float32)
                          for x in rays)
        sh = rays_d.shape
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if ndc:
            rays_o, rays_d = ndc_rays(height, width, focal, 1.0, rays_o,
                                      rays_d, variant=ndc_variant)
        out = render_rays_chunked(params, rays_o, rays_d, viewdirs, near,
                                  far, cfg, chunk=chunk, key=key)
        out = {k: v.reshape(*sh[:-1], *v.shape[1:]) for k, v in out.items()}
    rgb = out.pop("rgb")
    return rgb, out


def render_poses_to_frames(params: dict, poses, height: int, width: int,
                           focal: float, near: float, far: float,
                           cfg: RenderConfig, ndc: bool = False,
                           ndc_variant: str = "canonical",
                           chunk: int = 4096, factor: int = 0,
                           on_frame: Callable[[int, np.ndarray], None]
                           | None = None,
                           frame_keys: tuple[str, ...] = ("rgb",),
                           collect: bool = True,
                           device: str | torch.device = "cuda",
                           key: torch.Tensor | None = None,
                           occupancy=None, mesh: Mesh | None = None,
                           programs: FramePrograms | None = None):
    """Render a pose sequence to ``[N, H, W, 3]`` float frames on
    ``device``, each through one frame program of ``programs`` (by default
    this module's cache).

    ``factor`` downscales H/W/focal. ``frame_keys`` selects the outputs
    (``rgb``, ``depth``, ``acc``, ``rgb_coarse``): with the default the
    result is the stacked rgb array, otherwise a dict of stacked arrays.
    ``on_frame(i, rgb)`` receives each rgb frame as it lands;
    ``collect=False`` (which needs ``on_frame``) keeps no frames and
    returns None. A stochastic configuration renders pose ``i`` with key
    ``split(key, len(poses))[i]``, as the JAX package does; a deterministic
    one needs no key and renders every pose alike wherever it sits.
    ``occupancy`` is a baked grid every frame renders through; ``mesh``
    splits every frame's chunks over its shards.
    """
    if not collect and on_frame is None:
        raise ValueError("collect=False requires on_frame (nothing would "
                         "observe the frames)")
    if on_frame is not None and "rgb" not in frame_keys:
        raise ValueError(
            "on_frame receives rgb frames; include 'rgb' in frame_keys "
            f"(got {frame_keys!r}) or drop the callback")
    if factor:
        height, width = height // factor, width // factor
        focal = focal / factor

    if len(poses) == 0:
        def empty_for(k):
            ch = (3,) if k in ("rgb", "rgb_coarse") else ()
            return np.zeros((0, height, width, *ch), np.float32)
        if frame_keys == ("rgb",):
            return empty_for("rgb")
        return {k: empty_for(k) for k in frame_keys}

    programs = _PROGRAMS if programs is None else programs
    dev = _device(device)
    keys = (split(key_on(key, dev), len(poses)) if key is not None
            else [None] * len(poses))
    pending: list[tuple[int, tuple]] = []
    frames: list[dict | None] = [None] * len(poses)

    def take(out):
        """The frame out of the static outputs before the next frame is
        queued: on a card an asynchronous copy to pinned host memory and
        an event at its end, on the CPU a copy."""
        if dev.type != "cuda":
            return {k: out[k].clone() for k in frame_keys}, None
        host = {k: torch.empty(out[k].shape, dtype=out[k].dtype,
                               pin_memory=True) for k in frame_keys}
        for k in frame_keys:
            host[k].copy_(out[k], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return host, done

    def drain(entry):
        """Frame ``i`` handed over once on the host (``frame.land``)."""
        i, (host, done) = entry
        with tracing.span("frame.land", index=i):
            if done is not None:
                done.synchronize()
            vals = {k: v.numpy() for k, v in host.items()}
        if collect:
            frames[i] = vals
        if on_frame is not None:
            on_frame(i, vals["rgb"])

    for i, pose in enumerate(poses):
        c2w = torch.from_numpy(np.asarray(pose, np.float32)[:3, :4])
        got = programs(params, height, width, float(focal), c2w, float(near),
                       float(far), cfg, device=dev, take=take, ndc=ndc,
                       ndc_variant=ndc_variant, chunk=chunk, key=keys[i],
                       occupancy=occupancy, mesh=mesh)
        pending.append((i, got))
        if len(pending) > 1:   # one frame in flight
            drain(pending.pop(0))
    while pending:
        drain(pending.pop(0))
    if not collect:
        return None
    if frame_keys == ("rgb",):
        return np.stack([f["rgb"] for f in frames], 0)
    return {k: np.stack([f[k] for f in frames], 0) for k in frame_keys}
