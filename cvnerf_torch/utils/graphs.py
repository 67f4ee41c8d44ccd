"""Programs replayed from CUDA graphs: what a block of train steps
(``train/loop.py::_Block``) and a frame program
(``render/frames.py::FrameProgram``) share. A capture follows one eager
warm-up on a side stream (it builds the kernels, cuBLAS's handles and a
NCCL communicator, as ``torch.cuda.graphs`` asks) and records its seconds
and the bytes its memory pool reserved. A program runs eagerly, and says so
once, only where a capture cannot hold its work: several cards in one
process, or a collective that NCCL refused to capture."""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


class GraphProgram:
    """A program replayed from CUDA graphs. ``stats`` counts captures,
    their seconds (``capture_s``, the warm-up included) and the bytes they
    reserved (``pool_bytes``), beside the subclass's own ``counts``;
    ``eager_reason`` says why the program runs eagerly (None while it is
    graphed). ``what`` names the program and ``eager_as`` says how its
    work runs eagerly, in the line printed then."""

    def __init__(self, what: str, eager_as: str, **counts: int):
        self.stats = {"captures": 0, **counts, "capture_s": 0.0,
                      "pool_bytes": 0}
        self.eager_reason: str | None = None
        self._what, self._eager_as = what, eager_as

    def _eager(self, reason: str) -> None:
        """Run this program eagerly from now on, and say so once."""
        if self.eager_reason is None:
            self.eager_reason = reason
            print(f"{self._what}: {reason}: {self._eager_as}", flush=True)

    def _check_cards(self, device: torch.device, mesh) -> None:
        """Several cards in one process (a mesh of them) run eagerly: one
        graph is recorded on one card's stream."""
        if (device.type == "cuda" and mesh is not None
                and len(set(mesh.devices)) > 1):
            self._eager("several cards in one process")

    def _capture(self, device: torch.device, mesh, collective: str,
                 body: Callable[[], Any],
                 warm_up: Callable[[], Any] | None = None
                 ) -> tuple[torch.cuda.CUDAGraph, Any] | None:
        """``warm_up`` (by default ``body``) run eagerly on a side stream,
        then ``body`` captured in a CUDA graph. Returns the graph and what
        the captured ``body`` returned, or None where NCCL refused to
        capture the ``collective`` of a distributed ``mesh``: the program
        then runs eagerly, said once. Any other failure raises."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (warm_up or body)()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                out = body()
        except RuntimeError as err:
            if mesh is None or not mesh.distributed:
                raise
            self._eager(f"the {collective} was not captured "
                        f"({str(err).splitlines()[0]})")
            return None
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["pool_bytes"] += (torch.cuda.memory_reserved(device)
                                     - reserved)
        return graph, out

    def _replay(self, graph: torch.cuda.CUDAGraph, times: int = 1) -> None:
        """``graph`` replayed ``times`` times, queued without a host
        read."""
        for _ in range(times):
            graph.replay()
