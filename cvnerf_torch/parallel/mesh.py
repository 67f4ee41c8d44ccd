"""Device mesh and sharding layout for ray-data parallelism (port of the
JAX package's ``parallel/mesh.py``).

The layout is the JAX package's:

  * one mesh axis, ``'rays'`` (``RAY_AXIS``);
  * ray batches split along axis 0 into contiguous, equal shards;
  * params and optimizer state replicated;
  * per-shard loss and gradients, averaged over the shards (the JAX
    step's ``pmean``: a sum over the shards, then a division by their
    count).

Per-ray draws are keyed by *global* ray ids, so a step or a frame does not
depend on the shard count, up to the order of the reductions.

In PyTorch's idiom a :class:`Mesh` is one of two kinds:

  * **a process group is initialised** (``initialize_distributed``): one
    shard per rank, on the rank's own device — the multi-host layout.
    Averages are ``all_reduce`` sums (NCCL on the card, gloo on the CPU)
    and frames are put together with ``all_gather``, so every rank holds
    the whole frame;
  * **no process group**: shards over a list of devices inside one
    process, by default every local card (as the JAX ``make_mesh()`` spans
    ``jax.devices()``). A list may repeat a device (``["cpu"] * 4``,
    ``["cuda:0"] * 2``): the counterpart of the JAX package's virtual
    8-device CPU mesh. The shards then run one after another.

The JAX shardings map so:

  * ``ray_sharding(mesh)`` (``NamedSharding(mesh, P('rays'))``) is a
    :class:`RaySharding`: which contiguous rows of a batch each shard owns;
  * ``replicated_sharding(mesh)`` (``NamedSharding(mesh, P())``) is a
    :class:`ReplicatedSharding`: a value held whole on the device of every
    shard;
  * ``replicate_to_mesh(x, mesh)`` gives a :class:`Replicated` value: one
    copy per distinct device of this process's shards, none made where the
    value already lies. Every process already holds the same host value
    (deterministic loaders, shared seeds), so nothing is broadcast from
    rank 0: a broadcast would hide a rank that diverged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from cvnerf_torch import resolve_device

RAY_AXIS = "rays"


def _norm(device: str | torch.device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def group_live() -> bool:
    """Whether a default process group is live in this process."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | torch.device = "cuda") -> bool:
    """Opt-in multi-process initialisation: one process per card (or per
    CPU worker), joined through ``tcp://<coordinator>``.

    The arguments fall back to the JAX package's environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). Without a coordinator address this is a no-op
    returning False, so single-process runs are untouched. Otherwise it
    starts the default process group and returns True: ``nccl`` when
    ``device`` is CUDA, with this rank pinned to ``cuda:{process_id %
    device_count}``, ``gloo`` on the CPU. Raises while a process group is
    still live (it never joins a stale world) and when the world size or
    the rank is missing.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator!r} given without the world size and "
            "this process's rank: pass num_processes and process_id (or "
            "set JAX_NUM_PROCESSES and JAX_PROCESS_ID)")
    if group_live():
        raise RuntimeError(
            "a process group is already live in this process: destroy it "
            "(torch.distributed.destroy_process_group) before joining "
            "another")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ``'rays'`` axis: ``size`` shards in all, of
    which this process holds ``first .. first + len(devices) - 1``, the
    ``i``-th on ``devices[i]``. A ``distributed`` mesh spans the ranks of
    the default process group, one shard each."""
    devices: tuple[torch.device, ...]
    size: int
    first: int = 0
    distributed: bool = False

    @property
    def axis_names(self) -> tuple[str]:
        return (RAY_AXIS,)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where a replicated
        train state lives and where shard averages land."""
        return self.devices[0]

    @property
    def local_shards(self) -> list[tuple[int, torch.device]]:
        """``(global shard index, device)`` of each of this process's
        shards."""
        return [(self.first + i, d) for i, d in enumerate(self.devices)]

    def barrier(self) -> None:
        """Wait for every rank (a no-op inside one process)."""
        if self.distributed:
            dist.all_reduce(torch.zeros(1, device=self.home))


def make_mesh(devices=None, device: str | torch.device = "cuda") -> Mesh:
    """A 1-D ``'rays'`` mesh.

    Under a live process group: one shard per rank, on ``devices[0]`` if
    given, else on this rank's device (its current card for CUDA, else
    ``device``). Otherwise: one shard per entry of ``devices`` (repeats
    allowed), by default every local card when ``device`` names CUDA
    without an index, else ``device`` alone.
    """
    if group_live():
        if devices is None:
            devices = [resolve_device(device)]
        devs = tuple(_norm(d) for d in devices)
        if len(devs) != 1:
            raise ValueError(
                f"under a process group each rank holds one shard: got "
                f"{len(devs)} devices")
        return Mesh(devs, dist.get_world_size(), dist.get_rank(), True)
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and dev.index is None else [dev])
    devs = tuple(_norm(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, len(devs))


@dataclasses.dataclass(frozen=True)
class RaySharding:
    """Axis 0 of a batch split over the mesh: shard ``s`` of ``n`` rows
    owns the contiguous rows ``s·n/size .. (s+1)·n/size - 1``."""
    mesh: Mesh

    def rows(self, n: int, shard: int) -> slice:
        size = self.mesh.size
        if n % size:
            raise ValueError(f"{n} rows do not split into {size} equal "
                             "shards")
        m = n // size
        return slice(shard * m, (shard + 1) * m)


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """A value held whole by every shard: one copy on each distinct device
    of this process's shards."""
    mesh: Mesh

    @property
    def devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.mesh.devices))


def ray_sharding(mesh: Mesh) -> RaySharding:
    """Shard axis 0 (the ray axis) over the mesh."""
    return RaySharding(mesh)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


class Replicated:
    """A value replicated over a mesh (``replicate_to_mesh``): ``on(d)`` is
    the copy on device ``d``; other attributes read the copy on the
    mesh's first device (a grid's ``values``, say)."""

    def __init__(self, value: Any, mesh: Mesh):
        self.copies = {d: to_device(value, d)
                       for d in replicated_sharding(mesh).devices}

    def __getattr__(self, name: str) -> Any:
        if name == "copies" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(next(iter(self.copies.values())), name)

    def on(self, device: str | torch.device) -> Any:
        dev = _norm(device)
        if dev in self.copies:
            return self.copies[dev]
        return to_device(next(iter(self.copies.values())), dev)


def to_device(x: Any, device: str | torch.device) -> Any:
    """``x`` on ``device``: tensors, dicts, lists and tuples of them,
    objects with a ``to(device)`` method (the packed kernel weights, int8
    params), dataclasses of them (a train state, an occupancy grid) and
    :class:`Replicated` values (their copy there). A tensor already there
    is returned as it is, not copied."""
    dev = _norm(device)
    if isinstance(x, Replicated):
        return x.on(dev)
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, dev) for v in x)
    if hasattr(x, "to"):
        return x.to(dev)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x) if f.init})
    return x


def replicate_to_mesh(x: Any, mesh: Mesh) -> Replicated:
    """Replicate ``x`` onto every shard of ``mesh``: a copy on each
    distinct device of this process's shards, none where ``x`` already
    lies. No collective: every process holds the same host value."""
    if isinstance(x, Replicated):
        return x
    return Replicated(x, mesh)


def shard_mean(mesh: Mesh, per_shard: list[list[torch.Tensor]]
               ) -> list[torch.Tensor]:
    """The mean over every shard of the mesh (``pmean`` over ``'rays'``):
    ``per_shard[i]`` is this process's ``i``-th shard's list of tensors;
    returns one list of their means, on ``mesh.home``. The sum runs over
    the local shards in order, then over the ranks (``all_reduce``, one
    collective per tensor), and is divided by ``mesh.size`` (exact, and
    skipped, for one shard)."""
    total = [t.to(mesh.home) for t in per_shard[0]]
    for more in per_shard[1:]:
        total = [a + b.to(mesh.home) for a, b in zip(total, more)]
    if mesh.distributed:
        for t in total:
            dist.all_reduce(t)
    return total if mesh.size == 1 else [t / mesh.size for t in total]


def shard_gather(mesh: Mesh, pieces: list[torch.Tensor],
                 device: str | torch.device) -> list[torch.Tensor]:
    """Every shard's piece, in shard order, on ``device``: ``pieces[i]`` is
    this process's ``i``-th shard's (all of one shape). Across ranks an
    ``all_gather``, so every rank receives every piece."""
    if mesh.distributed:
        (piece,) = pieces
        piece = piece.contiguous()
        got = [torch.empty_like(piece) for _ in range(mesh.size)]
        dist.all_gather(got, piece)
        pieces = got
    return [to_device(p, device) for p in pieces]
