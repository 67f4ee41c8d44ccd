"""Time the port's 400x400 serving frame (bf16, 64 + 128 samples, full
width, seeded random nets) on one NVIDIA card three ways, in interleaved
rounds:

- ``eager``: the frame program's body run without a graph;
- ``frame``: one replay of a CUDA graph of the whole frame, the port's
  ``render/frames.py`` (design (a));
- ``chunk``: a graph of the ray grid, then ``n_chunks`` replays of a graph
  of one chunk that reads its rays and writes its outputs through a device
  chunk counter, JAX's ``lax.map`` literally (design (b), which the frame
  program did not take; a subclass of ``FrameProgram`` captures it here).

    python3 scripts/time_frame_graphs.py [--rounds N]

Each at chunk 8192 without a grid, through a 192^3 ``merge`` trilinear
grid (the most small launches a chunk) and at ``factor`` 4 (100x100, two
chunks). The three render the same frame, so their outputs must be
bitwise equal (the script fails otherwise). Prints the card's name and
power limit, then one JSON line: for each shape the median ms a frame of
each by CUDA events and by wall clock, each round's ms, the device's idle
share by ``torch.profiler``, and each graph's capture seconds and pool
bytes. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def chunk_program(frames):
    """``FrameProgram`` with design (b): the ray grid in one graph, then
    one graph of one chunk replayed ``n_chunks`` times."""
    import torch
    from cvnerf_torch.render.renderer import render_rays

    class ChunkProgram(frames.FrameProgram):
        def _setup(self):
            n = self.height * self.width
            self.n_chunks = -(-n // self.chunk)
            dev = self.device
            rows = self.n_chunks * self.chunk
            self.rays = [torch.zeros(rows, 3, device=dev) for _ in range(3)]
            self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
            self.lane = torch.arange(self.chunk, dtype=torch.int64,
                                     device=dev)
            self.padded = None

        def _rays_body(self):
            h, w = self.height, self.width
            focal = self.row[0]
            rays_o, rays_d = frames.ray_grid(h, w, focal,
                                             self.row[3:].view(3, 4))
            rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1,
                                                  keepdim=True)
            for buf, x in zip(self.rays, (rays_o, rays_d, viewdirs)):
                buf[:h * w].copy_(x)
            self.counter.zero_()

        def _chunk_body(self):
            ids = self.counter * self.chunk + self.lane
            ro, rd, vd = (x.index_select(0, ids) for x in self.rays)
            res = render_rays(self.nets, ro, rd, vd, self.row[1],
                              self.row[2], self.cfg, key=self.key,
                              ray_ids=ids, occupancy=self.grid)
            if self.padded is None:
                rows = self.n_chunks * self.chunk
                self.padded = {k: v.new_zeros(rows, *v.shape[1:])
                               for k, v in res.items()}
                n = self.height * self.width
                self.out = {k: v[:n].view(self.height, self.width,
                                          *v.shape[1:])
                            for k, v in self.padded.items()}
            for k, v in res.items():
                self.padded[k].index_copy_(0, ids, v)
            self.counter.add_(1)

        def _body(self):
            if not hasattr(self, "n_chunks"):
                self._setup()
            self._rays_body()
            for _ in range(self.n_chunks):
                self._chunk_body()

        def _capture(self):
            dev = self.device
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            self.graphs = []
            for body in (self._rays_body, self._chunk_body):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.device(dev), torch.cuda.graph(g):
                    body()
                self.graphs.append(g)
            self.graph = self.graphs[0]
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
            self.stats["pool_bytes"] += (torch.cuda.memory_reserved(dev)
                                         - reserved)
            self.stats["eager_frames"] += 1

        def run(self):
            if self.graph is None:
                self._capture()
                return self.out
            self.graphs[0].replay()
            for _ in range(self.n_chunks):
                self.graphs[1].replay()
            self.stats["replays"] += 1
            return self.out

    return ChunkProgram


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_frame_graphs: needs an NVIDIA card")
    import chip_smoke as cs
    from cvnerf_torch.models.nerf_mlp import NerfMLPConfig, init_nerf_params
    from cvnerf_torch.ops import fused_mlp as fm
    from cvnerf_torch.ops.rng import PRNGKey, split
    from cvnerf_torch.render import frames
    from cvnerf_torch.render.occupancy import bake_occupancy
    from cvnerf_torch.render.renderer import RenderConfig

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor() as pool:
        list(pool.map(fm.build_library, fm.SOURCES))
    mlp = NerfMLPConfig()
    params = {net: init_nerf_params(key, mlp, "cuda")
              for net, key in zip(("coarse", "fine"),
                                  split(PRNGKey(cs.SEED + 2)))}
    nets = {k: fm.FusedNerfWeights(v, mlp, torch.bfloat16)
            for k, v in params.items()}
    base = RenderConfig(n_coarse=64, n_fine=128, white_bkg=True, mlp=mlp,
                        compute_dtype=torch.bfloat16,
                        deterministic_resample=True).eval_mode()
    grid = bake_occupancy(params["fine"], mlp, (-1.5,) * 3, (1.5,) * 3,
                          cs.OCC_RES, compute_dtype=torch.bfloat16)
    hw = cs.SERVE_HW
    shapes = {
        "400_chunk8192": (hw, base, None),
        "400_merge_trilinear": (hw, dataclasses.replace(
            base, occupancy_interp="trilinear"), grid),
        "100_factor4": (hw // 4, base, None),
    }
    kinds = ("eager", "frame", "chunk")
    report = {"card": card}
    for name, (size, cfg, occ) in shapes.items():
        focal = 555.0 * size / hw
        progs = {}
        for kind in kinds:
            cls = (chunk_program(frames) if kind == "chunk"
                   else frames.FrameProgram)
            progs[kind] = cls(torch.device("cuda", 0), size, size, cfg,
                              False, "canonical", cs.CHUNK, None, nets, occ,
                              False)

        def load(prog, theta):
            prog.load(nets, focal, torch.from_numpy(
                cs.pose(theta)[:3].astype(np.float32)), 2.0, 6.0, None, occ)

        def frame(kind):
            load(progs[kind], 0.7)
            if kind == "eager":
                progs[kind]._body()
            else:
                progs[kind].run()
        for kind in kinds:                    # capture (eager first), warm
            load(progs[kind], 1.3)
            progs[kind].run() if kind != "eager" else progs[kind]._body()
            frame(kind)
        torch.cuda.synchronize()
        outs = {k: {key: v.clone() for key, v in progs[k].out.items()}
                for k in kinds}
        bitwise = all(torch.equal(outs["eager"][key], outs[k][key])
                      for k in kinds[1:] for key in outs["eager"])
        times = {k: [] for k in kinds}
        walls = {k: [] for k in kinds}
        for r in range(args.rounds):
            for kind in kinds[r % 3:] + kinds[:r % 3]:
                torch.cuda.synchronize()
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                ev0.record()
                frame(kind)
                ev1.record()
                torch.cuda.synchronize()
                walls[kind].append((time.perf_counter() - t0) * 1e3)
                times[kind].append(ev0.elapsed_time(ev1))
        med = {k: float(np.median(v)) for k, v in times.items()}
        split_ms = {k: cs.frame_split(lambda k=k: frame(k), 3, med[k])
                    for k in kinds}
        report[name] = {
            "median_ms": med,
            "median_wall_ms": {k: float(np.median(v))
                               for k, v in walls.items()},
            "rounds_ms": times, "split": split_ms,
            "graphs": {k: {s: progs[k].stats[s]
                           for s in ("capture_s", "pool_bytes")}
                       for k in kinds[1:]},
            "bitwise": bitwise}
        print(f"{name}: {json.dumps(report[name])}", flush=True)
        if not bitwise:
            sys.exit(f"time_frame_graphs: {name}: the three frames differ")
        del progs
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
