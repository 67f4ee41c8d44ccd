"""The model-family seam: a configuration's ``"family"`` picks the module
``nerfbench.families.<family>``, and the cells reach the model through it
alone. A family that no file under ``nerfbench/`` holds, registered in
``sys.modules`` as a spy around ``nerf``, runs a train cell and a serve
cell through ``harness.run_cell`` with every interface function called and
the same compared numbers as ``nerf``, bitwise; an unknown family stops a
run before the scene is made; a configuration without ``"family"`` is
``nerf``."""

import collections
import sys
import time
import types

import pytest
import torch
from conftest import tiny

from nerfbench import families, flops, harness, scene
from nerfbench.families import nerf
from nerfbench.trace import Trace

INTERFACE = ("init_params", "fit", "leaves", "port_train_config",
             "reference_run", "write_checkpoint", "load_renderer",
             "reference_frame", "step_ops", "frame_ops")
SEED = 2 ** 31 + 211


def spy_family() -> types.ModuleType:
    """A family module whose functions count their calls and call
    ``nerf``'s."""
    mod = types.ModuleType("nerfbench.families.spy")
    mod.calls = collections.Counter()

    def wrap(name):
        fn = getattr(nerf, name)

        def call(*args, **kwargs):
            mod.calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for name in INTERFACE:
        setattr(mod, name, wrap(name))
    return mod


def run(workload: str, **extra) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, workload)
    cfg = harness.load("configs", cell["config"])
    return harness.run_cell(bench, cell, SEED, 1.0, False,
                            torch.device("cpu"), time.perf_counter(),
                            overrides=tiny(cfg, dtype="float32", **extra))


def compared(result: dict) -> tuple[dict, dict]:
    return result["checks"], result["not_compared"]


def test_a_family_no_file_holds_runs_both_kinds_of_cell(monkeypatch):
    spy = spy_family()
    monkeypatch.setitem(sys.modules, spy.__name__, spy)
    assert "spy" not in families.present()
    for workload in ("fern-train", "lego-serve"):
        got = run(workload, family="spy")
        assert got["correct"], got["checks"]
        assert compared(got) == compared(run(workload, family="nerf"))
    # The whole step's and frame's shares read their work from the family.
    cfg = {**harness.load("configs", "nerf-llff-fern"), "family": "spy"}
    ctx = {"cfg": cfg, "peak": 1e15, "steps": 3,
           "frame_spans": [(0, 10 ** 8, 1)]}
    window = Trace([], [], (0, 10 ** 9))
    assert harness.read_metric("step_mfu.train", window, ctx) == \
        pytest.approx(100 * 3 * nerf.step_ops(cfg) / 1e15)
    assert harness.read_metric("frame_mfu.serve", window, ctx) == \
        pytest.approx(100 * nerf.frame_ops(cfg) / 1e15 / 0.1)
    assert flops.step_ops(cfg) == nerf.step_ops(cfg)
    assert set(spy.calls) == set(INTERFACE), spy.calls


@pytest.mark.parametrize("name", ["nosuch", "nerf.sub", ""])
def test_an_unknown_family_stops_the_run_before_the_scene(monkeypatch,
                                                          name):
    def made(*args, **kwargs):
        raise AssertionError("the scene was made")
    monkeypatch.setattr(scene, "make_scene", made)
    for workload in ("fern-train", "lego-serve"):
        with pytest.raises(SystemExit) as err:
            run(workload, family=name)
        assert repr(name) in str(err.value)
        assert "holds nerf" in str(err.value)


def test_a_configuration_without_a_family_is_nerf():
    assert "family" not in harness.load("configs", "nerf-blender-lego")
    assert compared(run("lego-serve")) == \
        compared(run("lego-serve", family="nerf"))
