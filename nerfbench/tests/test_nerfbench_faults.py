"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have is planted in the program, and the harness runs
on the CPU (its look for a card skipped) at a tiny size in float32, with
the cells' own limits. One card holds no exchange between chips, so that
fault has no case here."""

import dataclasses
import time

import pytest
import torch
from conftest import tiny

from nerfbench import harness


def run(workload: str) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, workload)
    cfg = harness.load("configs", cell["config"])
    return harness.run_cell(bench, cell, 2 ** 31 + 101, 1.0, False,
                            torch.device("cpu"), time.perf_counter(),
                            overrides=tiny(cfg, dtype="float32"))


def unchanged_state(monkeypatch):
    """Every step returns the state it was given."""
    from cvnerf_torch.train import loop
    build = loop._build_step_core

    def broken(*args):
        core = build(*args)

        def step(state, *rest):
            new, metrics = core(state, *rest)
            return dataclasses.replace(new, params=state.params,
                                       opt_state=state.opt_state), metrics
        return step
    monkeypatch.setattr(loop, "_build_step_core", broken)


def half_batch(monkeypatch):
    """Half of each step's pixels are left out: the other half is drawn
    twice, so the mean runs over the half that is left."""
    from cvnerf_torch.train import loop
    draw = loop._sample_pixels

    def broken(*args, **kwargs):
        py, px = draw(*args, **kwargs)
        h = py.shape[0] // 2
        return torch.cat([py[:h], py[:h]]), torch.cat([px[:h], px[:h]])
    monkeypatch.setattr(loop, "_sample_pixels", broken)


def doubled_leaf(monkeypatch):
    """One leaf's update is applied twice where the optimizer makes it."""
    from cvnerf_torch.train.state import Adam
    update = Adam.update

    def broken(self, grads, state, params, scalars):
        new, st = update(self, grads, state, params, scalars)
        w = params["fine"]["l2"]["w"].detach()
        new["fine"]["l2"]["w"] = w + 2.0 * (new["fine"]["l2"]["w"] - w)
        return new, st
    monkeypatch.setattr(Adam, "update", broken)


def stale_frame(monkeypatch):
    """Every frame after a program's first returns the first's image."""
    from cvnerf_torch.render.frames import FrameProgram
    run_ = FrameProgram.run

    def broken(self):
        if self.out is None:
            return run_(self)
        return self.out
    monkeypatch.setattr(FrameProgram, "run", broken)


def half_frame(monkeypatch):
    """Half of each frame's rays are left out (rendered as zeros)."""
    from cvnerf_torch.render import frames
    render = frames.render_rays_chunked

    def broken(params, rays_o, rays_d, viewdirs, *args, **kwargs):
        h = rays_o.shape[0] // 2
        out = render(params, rays_o[:h], rays_d[:h], viewdirs[:h], *args,
                     **kwargs)
        return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in
                out.items()}
    monkeypatch.setattr(frames, "render_rays_chunked", broken)


def altered_chunk(monkeypatch):
    """One chunk of each frame comes out with its colours inverted."""
    from cvnerf_torch.render import frames
    render = frames.render_rays_chunked

    def broken(*args, **kwargs):
        out = render(*args, **kwargs)
        n = kwargs.get("chunk", 256)
        out["rgb"] = torch.cat([1.0 - out["rgb"][:n], out["rgb"][n:]])
        return out
    monkeypatch.setattr(frames, "render_rays_chunked", broken)


@pytest.mark.parametrize("workload,fault", [
    ("fern-train", None), ("fern-train", unchanged_state),
    ("fern-train", half_batch), ("fern-train", doubled_leaf),
    ("lego-serve", None), ("lego-serve", stale_frame),
    ("lego-serve", half_frame), ("lego-serve", altered_chunk),
    ("fern-serve", altered_chunk)],
    ids=lambda x: getattr(x, "__name__", x or "sound"))
def test_a_planted_fault_reads_not_correct(monkeypatch, workload, fault):
    if fault is not None:
        fault(monkeypatch)
    res = run(workload)
    assert list(res)[-1] == "checks"
    assert res["correct"] is (fault is None), res["checks"]
    if fault is None:
        assert res["failed"] == 0 and res["attempted"] > 0
