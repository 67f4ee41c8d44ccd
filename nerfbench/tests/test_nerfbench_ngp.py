"""The Instant-NGP family (``families/ngp.py``) and its cell
``ngp-fern-train``: the cell runs through the family at the tests' tiny
widths and reads ``correct`` against the reference; the work and bytes the
readers divide by are the hand-counted ones at the published widths; a
parent whose ``families/`` lacks ``ngp``, or whose port lacks the field,
stops at once with a ``SystemExit``."""

import sys
import time

import pytest
import torch
from conftest import tiny

from nerfbench import families, flops, harness, scene
from nerfbench.families import ngp
from nerfbench.trace import Trace

SEED = 2 ** 31 + 311
# The field at the tests' size: 4 levels of 2^8 entries, MLPs 16 wide.
SMALL = dict(n_levels=4, log2_hashmap_size=8, max_resolution=32,
             n_neurons=16)


def run(**extra) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "ngp-fern-train")
    cfg = harness.load("configs", cell["config"])
    return harness.run_cell(bench, cell, SEED, 1.0, False,
                            torch.device("cpu"), time.perf_counter(),
                            overrides=tiny(cfg, dtype="float32", **SMALL,
                                           **extra))


def test_the_cell_runs_through_the_family(monkeypatch):
    calls = []
    for name in ("init_params", "fit", "port_train_config", "reference_run",
                 "leaves"):
        fn = getattr(ngp, name)
        monkeypatch.setattr(ngp, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    got = run()
    assert got["correct"], got["checks"]
    assert {"init_params", "fit", "port_train_config", "reference_run",
            "leaves"} <= set(calls)
    # float32 on the CPU: the program is the reference to rounding.
    assert set(got["checks"]) == {"grad_gap_median", "change_gap"}
    assert got["not_compared"]["loss_gap"] < 1e-5
    assert set(got["metrics"]) == {"train_rays_per_s", "setup_s"}


def test_work_and_bytes_at_the_published_widths():
    cfg = harness.load("configs", "ngp-llff-fern")
    assert cfg["family"] == "ngp" and cfg["reduced"] == []
    lvs = ngp.ref.levels(cfg)
    entries = sum(lv["entries"] for lv in lvs)
    assert entries == 6_098_120 and 2 * entries == 12_196_240
    assert ngp.forward_macs(cfg) == 32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 \
        + 64 * 3 == 9_408
    # Weight gradients plus every input gradient but the SH rows.
    assert ngp.backward_macs(cfg) == 2 * 9_408 - 16 * 64 == 17_792
    samples = 1024 * (64 + 192)
    assert samples == 2 ** 18
    assert flops.step_ops(cfg) == 2 * samples * (9_408 + 17_792)
    assert flops.frame_ops(cfg) == 2 * 378 * 504 * 256 * 9_408

    def touched(n):
        return sum(min(8 * n, lv["entries"]) for lv in lvs)
    def moved(feature_bytes):
        return sum(n * (12 + 32 * feature_bytes) + 8 * touched(n)
                   for n in (65_536, 196_608))
    # bf16 features out (the first layer reads bf16); fp32 gradients in.
    assert ngp.hash_fwd_bytes(cfg) == moved(2) == 117_492_864
    assert ngp.hash_bwd_bytes(cfg) == moved(4) == 134_270_080
    assert ngp.hash_fwd_bytes({**cfg, "dtype": "float32"}) == moved(4)


def test_the_readers_on_a_hand_made_trace():
    cfg = harness.load("configs", "ngp-llff-fern")
    ms = 10 ** 6
    device = [("void (anonymous namespace)::hash_encode_fwd(float const*)",
               0, 2 * ms),
              ("void (anonymous namespace)::hash_encode_bwd(float const*)",
               3 * ms, 7 * ms),
              ("(anonymous namespace)::fused_adam_kernel(Table)", 8 * ms,
               9 * ms),
              ("void at::native::vectorized_elementwise_kernel<4>", 9 * ms,
               10 * ms)]
    tr = Trace(device, [], (0, 10 * ms))
    ctx = {"cfg": cfg, "peak": 989e12, "steps": 2}
    hbm = flops.PEAKS["hbm_bytes_per_s"]
    assert harness.read_metric("hash_fwd_roofline.train", tr, ctx) == \
        pytest.approx(100 * 2 * ngp.hash_fwd_bytes(cfg) / hbm / 2e-3)
    assert harness.read_metric("hash_bwd_roofline.train", tr, ctx) == \
        pytest.approx(100 * 2 * ngp.hash_bwd_bytes(cfg) / hbm / 4e-3)
    assert harness.read_metric("adam_ms.train", tr, ctx) == \
        pytest.approx(0.5)
    # The rest of the step: the elementwise kernel's 1 ms over 2 steps.
    assert harness.read_metric("ngp_other_device_ms.train", tr, ctx) == \
        pytest.approx(0.5)
    # A NeRF trace has none of these kernels: nothing to read.
    none = Trace([("fused_nerf_wgmma", 0, ms)], [], (0, 10 * ms))
    for name in ("hash_fwd_roofline.train", "hash_bwd_roofline.train",
                 "adam_ms.train", "ngp_other_device_ms.train"):
        assert harness.read_metric(name, none, ctx) is None


@pytest.mark.parametrize("lacks", ["family", "field"])
def test_a_parent_stops_at_once(monkeypatch, lacks):
    """A parent whose ``families/`` has no ``ngp`` (``families.get``
    names the families it holds), or whose port has no Instant-NGP field
    under this family module (the module says so on import), raises
    ``SystemExit`` before the scene is made."""
    def made(*args, **kwargs):
        raise AssertionError("the scene was made")
    monkeypatch.setattr(scene, "make_scene", made)
    monkeypatch.delitem(sys.modules, "nerfbench.families.ngp")
    if lacks == "family":
        monkeypatch.setattr(families, "present", lambda: ["nerf"])
        monkeypatch.setitem(sys.modules, "nerfbench.families.ngp", None)
    else:
        # The port's own modules load (a parent's have no field to
        # import); only the family module meets the missing field.
        import cvnerf_torch.train.loop  # noqa: F401
        monkeypatch.setitem(sys.modules, "cvnerf_torch.models.ngp_field",
                            None)
    with pytest.raises(SystemExit) as err:
        run()
    assert "'ngp'" in str(err.value)
    assert ("holds nerf" if lacks == "family" else "Instant-NGP") \
        in str(err.value)
