"""Traffic of the ``serve`` kind: the port's HTTP server in this process,
offered an open loop of ``POST /render`` requests.

Set-up makes the scene and the starting weights from the seed, fits them
to the scene with the plain reference (so frames are not uniform), writes
them as a checkpoint and loads it into the port's renderer, each as the
configuration's family (``families/``) does, behind a proxy that times
each render call, starts ``make_server`` on a free local port and warms
the frame program through the server: one frame that captures it, one
replay, and a burst that the queue micro-batches.

The window sends one request a distinct seeded pose at its due time,
whether or not earlier ones have finished. The due times are the
exponential gaps' quantiles at the cell's rate in one order drawn from the
traffic mix's ``arrival_seed``: every seed offers the same arrivals and
changes what they ask for (the poses, the scene and its nets), since the
tails of a queue at four fifths of its capacity turn on the order of its
gaps far more than on the frames it renders. A request's
latency runs from its due time to the end of its response; one that fails,
is refused or times out counts as missing. After the window every request
is waited for (up to ``request_timeout_s``), and a sample of the served
frames, drawn from the seed, is compared with the reference's frames of the
same poses and weights.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import math
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import check, families, scene, trace
from nerfbench.reference.common import fp32, no_tf32


class RendererProxy:
    """The renderer the server is given: every attribute is the renderer's,
    and each render call the device queue makes is timed on the host clock
    (``spans``: start and end in ``time.time_ns``, frames in the call; the
    calls end in a copy of the frames to the host, so a span holds their
    device work). The queue's worker thread makes the calls, which the
    profiler of the main thread does not annotate."""

    def __init__(self, renderer):
        self._renderer = renderer
        self.spans: list[tuple[int, int, int]] = []

    def __getattr__(self, name):
        return getattr(self._renderer, name)

    def _timed(self, n: int, fn, *args, **kwargs):
        t = time.time_ns()
        out = fn(*args, **kwargs)
        self.spans.append((t, time.time_ns(), n))
        return out

    def render_pose_extras(self, c2w, factor=0, keys=("rgb", "depth", "acc")):
        return self._timed(1, self._renderer.render_pose_extras, c2w,
                           factor, keys=keys)

    def render_poses_extras(self, poses, factor=0, keys=("rgb",)):
        return self._timed(len(poses), self._renderer.render_poses_extras,
                           poses, factor, keys=keys)


def schedule(order_seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate seconds)``
    requests: the exponential gaps' quantiles at ``rate``, in an order
    drawn from ``order_seed``, each request one gap after the one
    before."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(np.random.default_rng(order_seed).permutation(gaps))


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (missing requests are ``inf``)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def decode(body: bytes, ctype: str) -> np.ndarray:
    """An 8-bit RGB frame from a binary PPM (P6), or from a PNG, which the
    server writes only where cv2 is installed (this process's cv2)."""
    if ctype == "image/x-portable-pixmap":
        parts = body.split(b"\n", 3)
        w, h = (int(x) for x in parts[1].split())
        return np.frombuffer(parts[3], np.uint8).reshape(h, w, 3)
    if ctype == "image/png":
        import cv2
        img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        return np.ascontiguousarray(img[..., ::-1])
    raise ValueError(f"unexpected media type {ctype!r}")


def _post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/render", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _body(pose: np.ndarray) -> bytes:
    """A ``/render`` request of ``pose`` in the server's default format."""
    return json.dumps({"c2w": pose.tolist()}).encode()


def offer(port: int, poses: np.ndarray, due: np.ndarray, traffic: dict,
          t_start: float) -> list[dict]:
    """Send request ``k`` (pose ``poses[k]``) at ``t_start + due[k]`` from a
    pool of sender threads; returns each request's record once all have
    ended."""
    recs = [{"due": t_start + d} for d in due]
    timeout = traffic["request_timeout_s"]

    def send(k):
        r = recs[k]
        r["sent"] = time.perf_counter()
        try:
            r["status"], r["ctype"], r["body"] = _post(
                port, _body(poses[k]), timeout)
        except (OSError, http.client.HTTPException) as err:
            r["status"], r["error"] = None, repr(err)
        r["done"] = time.perf_counter()

    with concurrent.futures.ThreadPoolExecutor(traffic["senders"]) as pool:
        futures = []
        for k in range(len(due)):
            wait = recs[k]["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(send, k))
        for f in futures:
            f.result()
    return recs


def start_server(renderer, traffic: dict):
    from cvnerf_torch.server import make_server
    srv = make_server(renderer, host="127.0.0.1", port=0,
                      queue_size=traffic["queue_size"],
                      batch_max=traffic["batch_max"],
                      request_timeout=traffic["request_timeout_s"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="nerfbench-server")
    thread.start()
    return srv, thread, srv.server_address[1]


def stop_server(srv, thread) -> None:
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> dict:
    """The inputs of a serving run: the fitted weights, the renderer behind
    its proxy, and a server that has rendered a frame, a replay and a
    micro-batch of each shape the window sends."""
    family = families.get(cfg)
    t = time.perf_counter()
    _, params, gen, fit_s = scene.inputs(cfg, seed, device)
    phases = {"fit_s": fit_s, "inputs_s": time.perf_counter() - t}
    if device.type == "cuda":
        # The peak is the program's: the fit above is the benchmark's.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tmp = tempfile.mkdtemp(prefix="nerfbench-")
    try:
        ckpt = family.write_checkpoint(params, os.path.join(tmp, "nets.pt"))
        proxy = RendererProxy(family.load_renderer(cfg, ckpt, device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phases["load_s"] = time.perf_counter() - t - phases["inputs_s"]
    srv, thread, port = start_server(proxy, traffic)
    warm = scene.request_poses(cfg, gen, 1 + traffic["batch_max"],
                               device).cpu().numpy()
    for pose in warm[:2]:
        status, _, _ = _post(port, _body(pose),
                             traffic["request_timeout_s"])
        if status != 200:
            raise RuntimeError(f"warm-up request answered {status}")
    offer(port, warm[1:], np.zeros(len(warm) - 1), traffic,
          time.perf_counter())
    phases["warm_s"] = time.perf_counter() - t - phases["inputs_s"] \
        - phases["load_s"]
    return {"params": params, "proxy": proxy, "server": (srv, thread),
            "port": port, "gen": gen, "phases": phases}


def run(cfg: dict, traffic: dict, cell: dict, seed: int, seconds: float,
        traced: bool, device: torch.device, t0: float) -> dict:
    s = setup(cfg, traffic, seed, device)
    rate = cell["rate_per_s"]
    due = schedule(traffic["arrival_seed"], rate, seconds)
    poses = scene.request_poses(cfg, s["gen"], len(due), device).cpu().numpy()
    proxy, phases = s["proxy"], s["phases"]
    programs = proxy.programs.programs
    captures = sum(p.stats["captures"] for p in programs)
    scene.sync(device)
    # The fit is the reference's work, not the program's set-up.
    setup_s = time.perf_counter() - t0 - phases["fit_s"]

    proxy.spans.clear()
    with trace.profiled(traced) as got:
        with record_function(trace.WINDOW):
            tw0_ns = time.time_ns()
            recs = offer(s["port"], poses, due, traffic, time.perf_counter())
            scene.sync(device)
    spans = frame_spans(got, proxy.spans, tw0_ns)
    stop_server(*s["server"])
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    programs = proxy.programs.programs
    stats = {"captures_in_window": sum(p.stats["captures"] for p in programs)
             - captures,
             "replays": sum(p.stats["replays"] for p in programs)}
    lat, ctypes = [], set()
    for r in recs:
        ok = r.get("status") == 200
        lat.append((r["done"] - r["due"]) * 1e3 if ok else math.inf)
        if ok:
            ctypes.add(r["ctype"])
    late = [(r["sent"] - r["due"]) * 1e3 for r in recs]
    failed = sum(1 for x in lat if not math.isfinite(x))

    served = [k for k, r in enumerate(recs) if r.get("status") == 200]
    pick = np.random.default_rng(seed).choice(
        served, size=min(traffic["checked_frames"], len(served)),
        replace=False) if served else []
    frames = {int(k): decode(recs[k]["body"], recs[k]["ctype"]) for k in pick}
    for r in recs:
        r.pop("body", None)
    params = s["params"]
    del proxy, programs, s      # the renderer, its programs and pools
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mae = [math.inf] if not frames else []
    with no_tf32():
        for k, got8 in frames.items():
            c2w = torch.from_numpy(poses[k]).to(device)
            want = check.to_byte(families.get(cfg).reference_frame(
                params, cfg, c2w, fp32))
            mae.append(check.frame_mae(got8, want))
    return {
        "setup_s": setup_s, "attempted": len(recs), "failed": failed,
        "metrics": {"render_p50_ms": percentile(lat, 0.5),
                    "render_p95_ms": percentile(lat, 0.95),
                    "setup_s": setup_s},
        "numbers": {"frame_mae": max(mae)},
        "memory_peak_bytes": memory,
        "trace": got[0] if got else None,
        "context": {"frame_spans": spans},
        "notes": {"media_types": sorted(ctypes), "programs": stats,
                  "generator_late_ms_max": max(late),
                  "generator_late_ms_p99": percentile(late, 0.99),
                  "offered_rate_per_s": rate, "requests": len(recs),
                  "checked_frames": sorted(frames),
                  "setup_phases": phases},
    }


def frame_spans(got: list, spans: list, tw0_ns: int) -> list:
    """The proxy's render spans ``(start_ns, end_ns, frames)`` on the
    trace's clock (the window annotation's start is ``tw0_ns`` there), also
    added to the trace as ``nerfbench.frames:<n>`` spans; empty without a
    trace."""
    if not got:
        return []
    tr = got[0]
    off = tr.window[0] - tw0_ns
    out = [(a + off, b + off, n) for a, b, n in spans
           if a + off >= tr.window[0]]
    tr.spans = sorted(tr.spans + [(f"nerfbench.frames:{n}", a, b)
                                  for a, b, n in out], key=lambda e: e[1])
    return out
