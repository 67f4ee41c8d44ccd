"""The harness's arithmetic on the CPU: the open-loop schedule, latency
from the due time, missing requests in the tail, rays/s over the whole
window, per-layer metrics from a recorded trace, and the refusal to run
without a card."""

import http.server
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import tiny

from nerfbench import flops, harness, serve_cell, train_cell, trace

ROOT = Path(__file__).resolve().parents[2]


def test_schedule_is_the_seeds_order_of_one_set_of_gaps():
    a = serve_cell.schedule(2 ** 31 + 7, 8.0, 40.0)
    b = serve_cell.schedule(2 ** 31 + 7, 8.0, 40.0)
    c = serve_cell.schedule(11, 8.0, 40.0)
    assert len(a) == len(c) == 320
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    gaps = np.diff(a, prepend=0.0)
    np.testing.assert_allclose(np.sort(gaps),
                               np.sort(np.diff(c, prepend=0.0)))
    assert abs(gaps.mean() - 1 / 8.0) < 0.01 and (gaps > 0).all()
    assert abs(a[-1] - 40.0) < 1.0


def test_percentile_counts_missing_requests():
    lat = [float(x) for x in range(1, 101)]
    assert serve_cell.percentile(lat, 0.5) == 50.0
    assert serve_cell.percentile(lat, 0.95) == 95.0
    lat[:5] = [math.inf] * 5        # five missing: the tail is theirs
    assert serve_cell.percentile(lat, 0.95) == 100.0
    lat[:6] = [math.inf] * 6
    assert serve_cell.percentile(lat, 0.95) == math.inf


class _Slow(http.server.BaseHTTPRequestHandler):
    """Answers after 80 ms; every third request is refused (503)."""
    count = 0

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.08)
        _Slow.count += 1
        code = 503 if _Slow.count % 3 == 0 else 200
        body = b"P6\n2 1\n255\n" + bytes(6)
        self.send_response(code)
        self.send_header("Content-Type", "image/x-portable-pixmap")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_open_loop_latency_runs_from_the_due_time():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        due = np.array([0.0, 0.0, 0.0, 0.3, 0.3, 0.6])
        t0 = time.perf_counter()
        recs = serve_cell.offer(srv.server_address[1], np.zeros((6, 3, 4)),
                                due, {"format": None,
                                      "request_timeout_s": 10.0,
                                      "senders": 2}, t0)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(5)
    for r, d in zip(recs, due):
        assert r["due"] == t0 + d
        assert r["done"] - r["due"] >= 0.08
    # Two senders for three requests due at once: the third is sent late,
    # and its latency holds the wait.
    assert recs[2]["sent"] - recs[2]["due"] >= 0.07
    assert recs[2]["done"] - recs[2]["due"] >= 0.16
    assert sorted(r["status"] for r in recs).count(503) == 2
    assert serve_cell.decode(recs[0]["body"], recs[0]["ctype"]).shape == \
        (1, 2, 3)


def test_rays_per_second_is_the_whole_windows_work():
    cfg = tiny(harness.load("configs", "nerf-llff-fern"), dtype="float32")
    traffic = {**harness.load("traffic", "train-blocks"), "steps_per_run": 4,
               "steps_per_call": 2}
    out = train_cell.run(cfg, traffic, 21, 0.5, False, torch.device("cpu"),
                         time.perf_counter())
    steps, window = out["context"]["steps"], out["context"]["window_s"]
    assert out["attempted"] == steps and steps % 4 == 0
    assert window >= 0.5
    assert out["metrics"]["train_rays_per_s"] == steps * 64 / window


class _Event:
    """A kineto event as ``trace.from_events`` reads it."""

    def __init__(self, name, device, kind, start, dur):
        self._v = (name, device, kind, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def activity_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


FWD = "void (anonymous namespace)::fused_nerf_wgmma<256, 128>(Params)"
BWD = ["void fused_nerf_bwd_wgmma<256>(BwdParams)",
       "void (anonymous namespace)::wgrad_wgmma<128, 256>(W)",
       "void reduce_slabs(float const*, float*, int)"]
OTHER = "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)"


def recorded(with_mlp=True):
    """A recorded window of 10 ms: per ms a forward (0.1 ms), a backward
    (0.3 ms in three kernels) and an elementwise kernel (0.2 ms), the
    last ms idle; a host span over the first half."""
    ev = [_Event(trace.WINDOW, "CPU", "user_annotation", 0, 10_000_000),
          _Event("nerfbench.trainer_run", "CPU", "user_annotation", 0,
                 5_000_000),
          _Event("aten::add", "CPU", "cpu_op", 10, 100)]
    for k in range(9):
        t = k * 1_000_000
        if with_mlp:
            ev.append(_Event(FWD, "CUDA", "kernel", t, 100_000))
            for j, name in enumerate(BWD):
                ev.append(_Event(name, "CUDA", "kernel",
                                 t + 100_000 + j * 100_000, 100_000))
        ev.append(_Event(OTHER, "CUDA", "kernel", t + 400_000, 200_000))
        ev.append(_Event("gpu annotation", "CUDA", "gpu_user_annotation",
                         t, 900_000))
    return trace.from_events(ev)


def ctx_of(name, **extra):
    cfg = harness.load("configs", name)
    return {"cfg": cfg, "peak": flops.PEAKS["bf16"], **extra}


def test_per_layer_metrics_from_a_recorded_trace():
    tr = recorded()
    assert tr.window_s == 0.01 and len(tr.device) == 45
    assert abs(tr.busy_s() - 9 * 0.6e-3) < 1e-12
    ctx = ctx_of("nerf-blender-lego", steps=9)
    read = lambda m, c=ctx: harness.read_metric(m, tr, c)  # noqa: E731
    pts = 9 * 1024 * 256
    assert read("mlp_fwd_roofline.train") == pytest.approx(
        100 * pts * 1_186_816 / 989e12 / 0.9e-3)
    assert read("mlp_bwd_roofline.train") == pytest.approx(
        100 * pts * 2_302_208 / 989e12 / 2.7e-3)
    assert read("other_device_ms.train") == pytest.approx(0.2)
    assert read("device_idle.train") == pytest.approx(100 * (1 - 0.54))
    assert read("step_mfu.train") == pytest.approx(
        100 * 9 * flops.step_ops(ctx["cfg"]) / 989e12 / 0.01)
    spans = [(0, 2_000_000, 1), (2_000_000, 6_000_000, 2)]
    sctx = ctx_of("nerf-llff-fern", frame_spans=spans)
    assert read("mlp_fwd_roofline.serve", sctx) == pytest.approx(
        100 * 3 * 378 * 504 * 256 * 1_186_816 / 989e12 / 0.9e-3)
    assert read("frame_mfu.serve", sctx) == pytest.approx(
        100 * flops.frame_ops(sctx["cfg"]) / 989e12 / 0.002)
    assert read("frame_idle.serve", sctx) == pytest.approx(40.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["vectorized_elementwise_kernel",
                                  pytest.approx(9 * 2e-4)]
    assert dict(b["idle_gaps"]) == {
        "nerfbench.trainer_run": pytest.approx(5 * 0.4e-3),
        "host outside any span": pytest.approx(4 * 0.4e-3 + 1e-3)}


def test_metrics_whose_names_are_absent_read_nothing():
    tr = recorded(with_mlp=False)
    ctx = ctx_of("nerf-blender-lego", steps=9, frame_spans=[(0, 10**6, 1)])
    for name in ("mlp_fwd_roofline.train", "mlp_bwd_roofline.train",
                 "other_device_ms.train", "mlp_fwd_roofline.serve"):
        assert harness.read_metric(name, tr, ctx) is None
    assert harness.read_metric("device_idle.train", tr, ctx) == \
        pytest.approx(100 * (1 - 0.18))


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "nerfbench/run.py", "--workload",
                          "fern-train", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_file_is_within_its_limits():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["per_layer"]:
        assert (Path(harness.HERE) / "metrics" / m["name"] / "read.py") \
            .exists()
        e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e["workloads"])
    for cell in bench["workloads"]:
        own = harness.load("cells", cell["name"])
        assert own["limits"]
        harness.load("configs", cell["config"])
        harness.load("traffic", cell["traffic"])
