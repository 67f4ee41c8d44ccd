"""Time the port's lego train step (bf16, 1024 rays of 400x400, full width)
on one NVIDIA card three ways, in interleaved rounds of 10 steps:

- ``eager``: single steps (``Trainer(steps_per_call=1)``);
- ``graph_1``: blocks of 10 replays of a one-step CUDA graph, the port's
  ``make_train_scan`` (``Trainer(steps_per_call=10)``);
- ``graph_10``: blocks of one replay of a graph that holds all 10 steps,
  the design ``make_train_scan`` did not take; a subclass of its
  ``_Block`` captures it here.

    python3 scripts/time_block_graphs.py [--rounds N]

All three start from one seeded state and run the same steps, so their
states must end bitwise equal (the script fails otherwise). Prints the
card's name and power limit, then one JSON line: the median ms a step of
each by CUDA events, each round's ms, the device's idle share of each by
``torch.profiler`` over 20 more steps, and each graph's capture seconds
and pool bytes. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BLOCK = 10


class _Once:
    """A graph of a whole block behind the one-step graph's interface: the
    scan replays it ``block`` times a block, so it runs on the first."""

    def __init__(self, graph, block: int):
        self.graph, self.block, self.calls = graph, block, 0

    def replay(self) -> None:
        if self.calls % self.block == 0:
            self.graph.replay()
        self.calls += 1


def ten_step_scan(cfg, block: int):
    """``make_train_scan(cfg, block)`` with the block's ``block`` steps
    captured in one graph."""
    import torch
    from cvnerf_torch.train import loop

    class Whole(loop._Block):
        def _graph(self, occupancy, images, poses, train_idx, precrop):
            got = self._graphs.get(precrop)
            if got is not None:
                return got[1], got[2]
            home = self._bufs["counter"].device
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device=home)
            side.wait_stream(torch.cuda.current_stream(home))
            with torch.cuda.stream(side):
                self._body(occupancy, images, poses, train_idx, precrop,
                           write=False)
            torch.cuda.current_stream(home).wait_stream(side)
            torch.cuda.synchronize(home)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(home)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(home), torch.cuda.graph(graph):
                for _ in range(self.block):
                    metrics = self._body(occupancy, images, poses,
                                         train_idx, precrop)
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
            self.stats["pool_bytes"] += (torch.cuda.memory_reserved(home)
                                         - reserved)
            self._graphs[precrop] = (None, _Once(graph, self.block), metrics)
            return self._graphs[precrop][1], metrics

    runner = Whole(cfg, block, None, False)

    def scan_fn(state, base_key, images, poses, train_idx, start, precrop):
        return runner(state, None, base_key, images, poses, train_idx,
                      start, precrop)
    scan_fn.runner = runner
    return scan_fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_block_graphs: needs an NVIDIA card")
    import chip_smoke as cs
    from cvnerf_torch.data.synthetic import bench_scene
    from cvnerf_torch.ops import fused_mlp as fm
    from cvnerf_torch.ops.rng import PRNGKey
    from cvnerf_torch.train.loop import Trainer, state_leaves
    from cvnerf_torch.train.state import create_train_state

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor() as pool:
        list(pool.map(fm.build_library, fm.SOURCES))
    images, poses = bench_scene(cs.TRAIN_HW, cs.TRAIN_HW)
    tcfg = cs.lego_train_config(torch.bfloat16)
    trs = {}
    for kind in ("eager", "graph_1", "graph_10"):
        state = create_train_state(PRNGKey(cs.SEED), lr=tcfg.lr,
                                   lr_decay=tcfg.lr_decay,
                                   mlp=tcfg.render.mlp, device="cuda")
        tr = Trainer(tcfg, state, images, poses, [0, 1], seed=cs.SEED,
                     steps_per_call=1 if kind == "eager" else BLOCK)
        if kind == "graph_10":
            tr.scan_fn = ten_step_scan(tcfg, BLOCK)
        tr.run(1, 1 + BLOCK)                         # capture, warm
        trs[kind] = tr
    kinds = list(trs)
    times = {k: [] for k in kinds}
    nxt = 1 + BLOCK
    for r in range(args.rounds):
        for kind in kinds[r % 3:] + kinds[:r % 3]:
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            trs[kind].run(nxt, nxt + BLOCK)
            ev1.record()
            torch.cuda.synchronize()
            times[kind].append(ev0.elapsed_time(ev1) / BLOCK)
        nxt += BLOCK
    med = {k: float(np.median(v)) for k, v in times.items()}
    split = {k: cs.profile_steps(trs[k], nxt, 2 * BLOCK, med[k])
             for k in kinds}
    leaves = {k: state_leaves(trs[k].state) for k in kinds}
    bitwise = all(torch.equal(a, b) for k in kinds[1:]
                  for a, b in zip(leaves["eager"], leaves[k]))
    print(json.dumps({
        "card": card, "median_ms": med, "rounds_ms": times,
        "idle_share": {k: v["idle_share"] for k, v in split.items()},
        "graphs": {k: {key: trs[k].scan_fn.runner.stats[key]
                       for key in ("captures", "capture_s", "pool_bytes")}
                   for k in kinds[1:]},
        "bitwise": bitwise}), flush=True)
    if not bitwise:
        sys.exit("time_block_graphs: the three runs' states differ")


if __name__ == "__main__":
    main()
