"""HTTP serving front end for :class:`cvnerf_torch.serve.NerfRenderer`
(port of the JAX package's ``server.py``; stdlib ``http.server`` only).

Endpoints:
    GET  /health            → JSON {status, step, height, width, ...}
    POST /render            → body JSON {"c2w": [[...3 or 4 rows x 4...]],
                               "factor": int (optional downscale),
                               "format": "png" (default) | "json",
                               "include_depth": bool (json only)}
                              → image/png bytes (PPM when no PNG encoder is
                               installed), or JSON {"rgb": [[[...]]], ...}
    POST /render_video      → body JSON {"poses": [[[...3x4...]], ...],
                               "factor": int, "fps": int (default 30)}
                              → video/mp4 bytes

Device work goes through a bounded FIFO frame-granular queue
(``DeviceQueue``): one worker thread owns the card, consecutive compatible
frames are micro-batched into one pose sequence, a full queue answers 503,
and a waiter that gives up marks its jobs abandoned. ``/health`` never
touches the queue.

Run (geometry from the run's scene.json, weights from its
torch_checkpoints/):
    python -m cvnerf_torch.server --run logs/lego --port 8000

Run int8-quantized (calibrated at startup on the run's stored poses):
    python -m cvnerf_torch.server --run logs/lego --int8

Run (explicit geometry and a .pt file):
    python -m cvnerf_torch.server --ckpt lego.pt \
        --height 400 --width 400 --focal 555 --near 2 --far 6 --port 8000
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cvnerf_torch.ops import hash_encode
from cvnerf_torch.serve import NerfRenderer
from cvnerf_torch.utils import tracing
from cvnerf_torch.utils.image import to_byte


class QueueFullError(Exception):
    """The bounded device queue is at capacity (HTTP 503)."""


class RenderTimeoutError(Exception):
    """A queued job was not served within the deadline (HTTP 504)."""


class DeviceQueue:
    """Bounded FIFO frame-granular work queue in front of the device.

    A single global render lock would let a 240-pose ``/render_video``
    hold the device for minutes while a 1-pose ``/render`` starves.
    Properties:

    * FIFO fairness at FRAME granularity: a video enqueues one job per
      pose, so any concurrent request is served after the in-flight
      frame, not after the whole sequence.
    * Bounded: ``maxsize`` jobs; a full queue raises ``QueueFullError``
      (→ 503 + Retry-After) instead of buffering unboundedly.
    * Micro-batching: consecutive COMPATIBLE jobs (same factor, same
      output keys) are popped together — up to ``batch_max`` — and
      rendered as ONE pipelined device program
      (``NerfRenderer.render_poses_extras``): concurrent single-pose
      clients share dispatch overhead, and a video's own frames flow
      through the same path batched.
    * Abandonment: a waiter that times out marks its job; the worker
      skips abandoned jobs so the device never renders for a client that
      already hung up.

    One worker thread owns the device; HTTP handler threads only queue
    and wait. ``/health`` never touches the queue (lock-free liveness).
    Every frame the worker renders replays one of the renderer's frame
    programs (``render/frames.py``): the worker is the only thread that
    renders, so one set of static buffers a program is safe.

    ``stats`` counts jobs admitted, refused by a full queue
    (``rejected_full``), given up by their waiters (``timed_out``) and
    failed by the renderer, and the worker's render calls (``batches``),
    frames and abandoned jobs it skipped; :meth:`read_stats` copies it
    under the queue's lock. With ``utils.tracing`` on, the worker records
    each job's ``queue.wait`` (appended to popped) and ``queue.hold``
    (its frame on the host to its waiter woken), each render call as
    ``queue.batch`` (its jobs' ``request`` ids in order) and its waits on
    an empty queue as ``queue.idle``.
    """

    def __init__(self, renderer: NerfRenderer, maxsize: int = 64,
                 batch_max: int = 8):
        self.renderer = renderer
        self.maxsize = int(maxsize)
        self.batch_max = max(1, int(batch_max))
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self.stats = {"admitted": 0, "rejected_full": 0, "timed_out": 0,
                      "failed": 0, "batches": 0, "frames": 0,
                      "abandoned_skipped": 0}
        self._worker_thread = threading.Thread(
            target=self._worker, daemon=True, name="cvnerf-torch-device-queue")
        self._worker_thread.start()

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop the worker thread (idempotent). Queued jobs are failed
        with RenderTimeoutError so no waiter hangs. Without this, every
        DeviceQueue pins a live thread plus its renderer (params, grid,
        compiled programs) forever — a real leak in processes that build
        servers repeatedly (test suites, notebook reloads)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            for j in self._dq:
                j["err"] = RenderTimeoutError("device queue closed")
                j["ev"].set()
            self._dq.clear()
            self._cv.notify_all()
        self._worker_thread.join(join_timeout)

    # -- client side ------------------------------------------------------
    def submit_async(self, c2w, factor: int, keys: tuple[str, ...],
                     block: bool = False, timeout: float | None = None,
                     request: int | None = None) -> dict:
        """Queue one frame; ``request`` is the id the job's spans carry."""
        job = {"c2w": np.asarray(c2w, np.float32)[:3, :4],
               "factor": int(factor), "keys": tuple(keys),
               "ev": threading.Event(), "out": None, "err": None,
               "abandoned": False, "request": request}
        # Absolute deadline: cv.wait wakes on EVERY notify_all (each freed
        # slot wakes all blocked senders), so re-waiting with the full
        # timeout would let a loser of the re-check race block unboundedly.
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._cv:
            while len(self._dq) >= self.maxsize or self._closed:
                if self._closed:
                    raise RenderTimeoutError("device queue closed")
                if not block:
                    self.stats["rejected_full"] += 1
                    raise QueueFullError(
                        f"device queue full ({self.maxsize} jobs)")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.stats["timed_out"] += 1
                    raise RenderTimeoutError(
                        "timed out waiting for queue space")
                self._cv.wait(timeout=remaining)
            job["queued_ns"] = tracing.now()
            self._dq.append(job)
            self.stats["admitted"] += 1
            self._cv.notify_all()
        return job

    def wait(self, job: dict, timeout: float | None = None) -> dict:
        if not job["ev"].wait(timeout):
            job["abandoned"] = True
            with self._cv:
                self.stats["timed_out"] += 1
            raise RenderTimeoutError("render not served within deadline")
        if job["err"] is not None:
            raise job["err"]
        return job["out"]

    def render(self, c2w, factor: int = 0,
               keys: tuple[str, ...] = ("rgb",),
               timeout: float | None = None,
               request: int | None = None) -> dict:
        return self.wait(self.submit_async(c2w, factor, keys,
                                           request=request), timeout)

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._dq)

    def read_stats(self) -> dict:
        """A copy of ``stats`` taken under the queue's lock; it never
        waits on device work."""
        with self._cv:
            return dict(self.stats)

    # -- device side ------------------------------------------------------
    @staticmethod
    def _compatible(a: dict, b: dict) -> bool:
        return a["factor"] == b["factor"] and a["keys"] == b["keys"]

    def _worker(self) -> None:
        while True:
            with self._cv:
                idle = tracing.now() if not self._dq else 0
                while not self._dq and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                popped = tracing.now()
                tracing.record("queue.idle", idle, popped)
                batch = [self._dq.popleft()]
                while (self._dq and len(batch) < self.batch_max
                       and self._compatible(self._dq[0], batch[0])):
                    batch.append(self._dq.popleft())
                n = len(batch)
                batch = [j for j in batch if not j["abandoned"]]
                self.stats["abandoned_skipped"] += n - len(batch)
                if batch:
                    self.stats["batches"] += 1
                    self.stats["frames"] += len(batch)
                self._cv.notify_all()   # space freed: wake blocked senders
            for j in batch:
                tracing.record("queue.wait", j["queued_ns"], popped,
                               parent=j["request"], request=j["request"])
            if not batch:
                continue
            with tracing.span("queue.batch", frames=len(batch),
                              requests=[j["request"] for j in batch]) as sp:
                self._render(batch)
            # A frame is on the host when its frame.land ends (a sequence)
            # or its frame ends (one frame, whose take copies it out).
            landed = ([end for name, end, _ in sp.children
                       if name == "frame.land"]
                      or [end for name, end, _ in sp.children
                          if name == "frame"])
            for k, j in enumerate(batch):
                j["ev"].set()
                if k < len(landed):
                    tracing.record("queue.hold", landed[k], tracing.now(),
                                   parent=j["request"], request=j["request"])

    def _render(self, batch: list[dict]) -> None:
        """Render ``batch`` into its jobs' ``out``, or its failure into
        their ``err``."""
        try:
            if len(batch) == 1:
                j = batch[0]
                j["out"] = self.renderer.render_pose_extras(
                    j["c2w"], factor=j["factor"], keys=j["keys"])
            else:
                outs = self.renderer.render_poses_extras(
                    np.stack([j["c2w"] for j in batch]),
                    factor=batch[0]["factor"], keys=batch[0]["keys"])
                for k, j in enumerate(batch):
                    j["out"] = {key: outs[key][k] for key in j["keys"]}
        except Exception as e:  # noqa: BLE001 — deliver to the waiters;
            # the worker must survive any render failure.
            with self._cv:
                self.stats["failed"] += len(batch)
            for j in batch:
                j["err"] = e


def _encode_image(rgb8: np.ndarray) -> tuple[bytes, str]:
    """[H, W, 3] uint8 → (bytes, content_type): PNG via cv2, with a
    pure-python PPM fallback (mirroring utils/image.py's encoder
    availability story). The fallback is labeled with its real media type
    so clients never receive PPM bytes under an image/png header."""
    try:
        import cv2
        ok, buf = cv2.imencode(".png", rgb8[..., ::-1])  # RGB → BGR
        if ok:
            return bytes(buf.tobytes()), "image/png"
        print("[WARN] cv2.imencode returned not-ok; serving PPM fallback")
    except ImportError:
        pass
    except Exception as e:  # cv2.error etc. — degrade, don't drop the request
        print(f"[WARN] PNG encode failed ({e!r}); serving PPM fallback")
    # PPM (P6) fallback — lossless, universally decodable.
    h, w = rgb8.shape[:2]
    body = b"P6\n%d %d\n255\n" % (w, h) + rgb8.tobytes()
    return body, "image/x-portable-pixmap"


# A render request is a c2w matrix plus a couple of scalars — a few hundred
# bytes of JSON (a render_video pose list is a few hundred bytes per pose).
# Anything beyond this bound is not a legitimate request and is rejected up
# front (413) instead of being buffered into host memory.
MAX_REQUEST_BYTES = 1 << 20

# Pose-sequence bound for /render_video: the reference's longest built-in
# path is 120 poses (LLFF spiral, data_helpers.py:302); 240 leaves 2x
# headroom while keeping a single request's device time bounded.
MAX_VIDEO_POSES = 240


class NerfRequestHandler(BaseHTTPRequestHandler):
    """Handler bound to a NerfRenderer via the server instance."""

    server_version = "cvnerf_torch"

    # Quiet per-request stderr logging (metrics go through the app).
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _json(self, code: int, payload: dict,
              headers: dict | None = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path.split("?")[0] != "/health":
            self._json(404, {"error": f"unknown path {self.path!r}"})
            return
        r: NerfRenderer = self.server.renderer
        self._json(200, {
            "status": "ok",
            "step": r.step,
            "height": r.height,
            "width": r.width,
            "focal": r.focal,
            "near": r.near,
            "far": r.far,
            "ndc": r.ndc,
            "deterministic": bool(r.cfg.deterministic_resample),
            # Liveness stays queue-free; depth is a lock-protected len()
            # read, never a wait on device work.
            "queue_depth": self.server.device_queue.depth,
            "queue_size": self.server.device_queue.maxsize,
            # Admitted, refused (503), timed out (504), failed (500) and
            # batching counts; a lock-protected copy, as depth is.
            "queue_stats": self.server.device_queue.read_stats(),
            # Frame programs dropped from the renderer's cache (each comes
            # back as a new capture); a copy taken without the frame lock,
            # which a frame holds through its device work.
            "frame_stats": dict(r.programs.stats),
            # The hash encoding's launches, samples and lookups (an
            # Instant-NGP field's; zeros for NeRF), counted at eager calls
            # and captures.
            "hash_stats": dict(hash_encode.stats),
        })

    def _read_json_body(self) -> dict | None:
        """Read and parse the request body; on failure the error response
        has already been sent and None is returned."""
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._json(400, {"error": "bad Content-Length header"})
            return None
        if n < 0:
            # rfile.read(-1) would read until EOF: an attacker holding the
            # socket open pins the handler thread and defeats the size cap.
            self._json(400, {"error": "negative Content-Length"})
            return None
        if n > MAX_REQUEST_BYTES:
            self._json(413, {"error": f"request body {n} bytes exceeds "
                                      f"the {MAX_REQUEST_BYTES}-byte limit"})
            return None
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": repr(e)})
            return None
        return req

    def do_POST(self):  # noqa: N802
        path = self.path.split("?")[0]
        if path == "/render":
            self._post_render()
        elif path == "/render_video":
            self._post_render_video()
        else:
            self._json(404, {"error": f"unknown path {self.path!r}"})

    def _read_render_request(self) -> tuple | None:
        """The ``/render`` body, validated: ``(c2w, factor, format,
        include_depth)``, or None once a 400 has been sent."""
        req = self._read_json_body()
        if req is None:
            return None
        try:
            c2w = np.asarray(req["c2w"], np.float32)
            if c2w.shape not in ((3, 4), (4, 4)):
                raise ValueError(f"c2w must be [3,4] or [4,4], "
                                 f"got {list(c2w.shape)}")
            factor = int(req.get("factor", 0))
            r: NerfRenderer = self.server.renderer
            if factor < 0 or (factor and factor > min(r.height, r.width)):
                raise ValueError(
                    f"factor must be in [0, min(H, W)={min(r.height, r.width)}], "
                    f"got {factor}")
            fmt = req.get("format", "png")
            if fmt not in ("png", "json"):
                raise ValueError(f"format must be png|json, got {fmt!r}")
            include_depth = req.get("include_depth", False)
            if not isinstance(include_depth, bool):
                raise ValueError("include_depth must be a JSON boolean, "
                                 f"got {include_depth!r}")
            if include_depth and fmt != "json":
                raise ValueError("include_depth requires format=json")
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": repr(e)})
            return None
        return c2w, factor, fmt, include_depth

    def _post_render(self):
        """``POST /render``. With ``utils.tracing`` on, ``server.request``
        spans the handler (its id is the request's, which its queued job
        carries), with ``server.read`` (body and validation),
        ``server.encode`` and ``server.write`` inside."""
        with tracing.span("server.request") as sp:
            sp.set(status=self._render_request(sp.id))

    def _render_request(self, request: int | None) -> int:
        """Answer one ``/render``; returns the response's status."""
        with tracing.span("server.read"):
            parsed = self._read_render_request()
        if parsed is None:
            return 400
        c2w, factor, fmt, include_depth = parsed

        keys = ("rgb", "depth", "acc") if include_depth else ("rgb",)
        try:
            out = self.server.device_queue.render(
                c2w, factor=factor, keys=keys,
                timeout=self.server.request_timeout, request=request)
        except QueueFullError as e:
            self._json(503, {"error": str(e)}, headers={"Retry-After": "1"})
            return 503
        except RenderTimeoutError as e:
            self._json(504, {"error": str(e)})
            return 504
        except Exception as e:  # noqa: BLE001 — the client must get a JSON
            # 500, not a dropped connection from an escaping handler-thread
            # exception.
            self._json(500, {"error": f"render failed: {e!r}"})
            return 500
        rgb = out["rgb"]

        with tracing.span("server.encode"):
            if fmt == "json":
                payload = {"rgb": rgb.tolist(), "shape": list(rgb.shape)}
                if include_depth:
                    payload["depth"] = out["depth"].tolist()
                    payload["acc"] = out["acc"].tolist()
                body, ctype = json.dumps(payload).encode(), "application/json"
            else:
                body, ctype = _encode_image(np.asarray(to_byte(rgb)))
        with tracing.span("server.write"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        return 200

    def _post_render_video(self):
        """Render a pose sequence to an mp4 (the reference's spiral-video
        output as a service; frames render pipelined — frame i+1 executes
        on device while frame i encodes on host)."""
        req = self._read_json_body()
        if req is None:
            return
        try:
            poses = np.asarray(req["poses"], np.float32)
            if poses.ndim != 3 or poses.shape[1:] not in ((3, 4), (4, 4)):
                raise ValueError(
                    "poses must be [N,3,4] or [N,4,4], got "
                    f"{list(poses.shape)}")
            if not 1 <= poses.shape[0] <= MAX_VIDEO_POSES:
                raise ValueError(
                    f"pose count must be 1..{MAX_VIDEO_POSES}, "
                    f"got {poses.shape[0]}")
            factor = int(req.get("factor", 0))
            r: NerfRenderer = self.server.renderer
            if factor < 0 or (factor and factor > min(r.height, r.width)):
                raise ValueError(
                    f"factor must be in [0, min(H, W)="
                    f"{min(r.height, r.width)}], got {factor}")
            fps = int(req.get("fps", 30))
            if not 1 <= fps <= 120:
                raise ValueError(f"fps must be 1..120, got {fps}")
        except (KeyError, ValueError, TypeError) as e:
            self._json(400, {"error": repr(e)})
            return

        import os
        import tempfile

        from cvnerf_torch.utils.image import write_video
        try:
            # Frame-granular queueing: one job per pose, submitted in
            # bounded waves — concurrent /render requests interleave
            # between frames, and the queue's micro-batcher renders
            # consecutive frames as pipelined blocks.
            q: DeviceQueue = self.server.device_queue
            deadline = self.server.video_timeout
            wave = max(q.batch_max, 2)
            frame_list = []
            for start in range(0, poses.shape[0], wave):
                jobs = []
                try:
                    for p in poses[start:start + wave]:
                        jobs.append(q.submit_async(p[:3, :4], factor,
                                                   ("rgb",), block=True,
                                                   timeout=deadline))
                    frame_list.extend(q.wait(j, deadline)["rgb"]
                                      for j in jobs)
                except BaseException:
                    # This client gets its error response; every job of
                    # the wave not yet served must not keep costing
                    # device time (seconds of 400x400 work per frame) or
                    # queue slots — mark them abandoned so the worker
                    # skips them.
                    for j in jobs:
                        j["abandoned"] = True
                    raise
            frames = np.stack(frame_list, 0)
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "out.mp4")
                written = write_video(path, frames, fps=fps)
                if written != path:   # PNG-directory fallback: no encoder
                    self._json(501, {"error": "mp4 encoding unavailable "
                                              "on this host (no cv2 "
                                              "writer); request frames "
                                              "via /render instead"})
                    return
                with open(path, "rb") as fp:
                    body = fp.read()
        except RenderTimeoutError as e:
            self._json(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — JSON 500, not a dropped
            # connection from an escaping handler-thread exception.
            self._json(500, {"error": f"render failed: {e!r}"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "video/mp4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class NerfHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``server_close`` also stops the device
    queue's worker thread — without it every server built in-process
    (test suites, notebook reloads) leaks a live thread pinning the
    renderer."""

    def server_close(self):  # noqa: D102 — see class docstring
        super().server_close()
        q = getattr(self, "device_queue", None)
        if q is not None:
            q.close()


def make_server(renderer: NerfRenderer, host: str = "127.0.0.1",
                port: int = 8000, queue_size: int = 64,
                batch_max: int = 8, request_timeout: float = 300.0,
                video_timeout: float = 1800.0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server around a loaded renderer.

    Call ``srv.server_close()`` when done (after ``shutdown()``) — it
    also stops the device-queue worker thread."""
    srv = NerfHTTPServer((host, port), NerfRequestHandler)
    srv.renderer = renderer
    srv.device_queue = DeviceQueue(renderer, maxsize=queue_size,
                                   batch_max=batch_max)
    srv.request_timeout = float(request_timeout)
    srv.video_timeout = float(video_timeout)
    return srv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve a cvnerf checkpoint over HTTP from PyTorch/CUDA")
    p.add_argument("--run", default=None,
                   help="a run directory: geometry, architecture and dtype "
                        "from its scene.json, weights from the newest .pt "
                        "under torch_checkpoints/ (no geometry flags "
                        "accepted; the snapshot is authoritative)")
    p.add_argument("--ckpt", default=None,
                   help="a two-net .pt file (required without --run, along "
                        "with the geometry flags)")
    p.add_argument("--which", default=None, choices=["auto", "best", "last"],
                   help="with --run: auto (default) serves "
                        "torch_checkpoints_best/ when the run has it")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--focal", type=float, default=None)
    p.add_argument("--near", type=float, default=None)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; raises "
                        "when CUDA is missing — pass cpu explicitly)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--queue_size", type=int, default=64,
                   help="bounded device-queue capacity (frames); a full "
                        "queue answers 503 + Retry-After")
    p.add_argument("--batch_max", type=int, default=8,
                   help="micro-batch cap: consecutive compatible frame "
                        "jobs rendered as one pose sequence")
    p.add_argument("--request_timeout", type=float, default=300.0,
                   help="seconds a /render may wait in queue + on device "
                        "before 504")
    p.add_argument("--video_timeout", type=float, default=1800.0,
                   help="per-wave deadline for /render_video frames")
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--stochastic", action="store_true",
                   help="reference-style stochastic eval resampling")
    p.add_argument("--occupancy", default=None, choices=["merge", "full"],
                   help="bake an occupancy grid at startup (through the "
                        "forward kernel) and serve renders through it: "
                        "'merge' drops the coarse MLP, 'full' also draws "
                        "every fine sample from the grid's CDF; frame "
                        "times in PERF.md")
    p.add_argument("--occupancy_res", type=int, default=192,
                   help="occupancy lattice resolution per axis")
    p.add_argument("--occupancy_bound", type=float, default=1.5,
                   help="half-width of the bake cube for non-NDC scenes")
    p.add_argument("--occ_interp", default="trilinear",
                   choices=["trilinear", "nearest"],
                   help="occupancy probe interpolation (trilinear: "
                        "continuous-in-depth probe CDF; nearest: the "
                        "piecewise-constant probe)")
    p.add_argument("--occ_floor", type=int, default=0,
                   help="full-mode serving: this many of the n_fine "
                        "resamples come from a stratified coverage draw "
                        "instead of the probe CDF (same eval count). "
                        "0 = pure probe-CDF")
    p.add_argument("--occ_term", type=float, default=0.0,
                   help="early ray termination / empty-space skip "
                        "epsilon (needs --occupancy): probe-march each "
                        "ray and tighten [near, far] to the contributing "
                        "region; combine with --serve_coarse/--serve_fine "
                        "to cut sample counts. 0 = off")
    p.add_argument("--serve_coarse", type=int, default=None,
                   help="serving-only n_coarse override (the reduced "
                        "sample budget --occ_term makes safe)")
    p.add_argument("--serve_fine", type=int, default=None,
                   help="serving-only n_fine override")
    p.add_argument("--int8", action="store_true",
                   help="quantize the nets to int8 at startup and serve "
                        "through the fused int8 kernel (ops/quantize.py); "
                        "opt-in per deployment, frame times in PERF.md")
    p.add_argument("--int8_calib", type=int, default=1 << 17,
                   help="calibration sample count for --int8")
    p.add_argument("--int8_bound", type=float, default=None,
                   help="calibration cube half-width for --int8 when the "
                        "run snapshot stores no camera poses (default: "
                        "far). Calibration normally samples real rays "
                        "through the run's stored poses — this flag only "
                        "affects the pose-less fallback; under-sized "
                        "bounds clip the position encoding and cost dB")
    p.add_argument("--ndc", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="NDC ray warp — required for forward-facing LLFF "
                        "checkpoints (serve those with --ndc --near 0 "
                        "--far 1)")
    p.add_argument("--ndc_variant", default=None,
                   choices=["canonical", "reference"])
    return p


def renderer_from_args(args) -> NerfRenderer:
    """Build the renderer from parsed CLI args (--run snapshot or explicit
    geometry flags). Raises SystemExit on bad combos."""
    if not args.occupancy and (args.occ_term > 0
                               or args.serve_coarse is not None
                               or args.serve_fine is not None):
        raise SystemExit("--occ_term/--serve_coarse/--serve_fine need "
                         "--occupancy (termination probe-marches the "
                         "baked grid; without it the flags would "
                         "silently do nothing)")
    if args.int8 and args.int8_calib < 1:
        raise SystemExit(f"--int8_calib must be at least 1, got "
                         f"{args.int8_calib}")
    if args.int8 and args.int8_bound is not None and not args.int8_bound > 0:
        raise SystemExit(f"--int8_bound must be positive, got "
                         f"{args.int8_bound}")
    geo_flags = ("ckpt", "height", "width", "focal", "near", "far",
                 "ndc", "ndc_variant")
    if args.run:
        given = [f"--{k}" for k in geo_flags
                 if getattr(args, k) is not None]
        if given:
            raise SystemExit(
                f"--run reads geometry from the run snapshot; drop "
                f"{' '.join(given)} (edit <run>/scene.json instead)")
        return NerfRenderer.from_run_dir(
            args.run, chunk=args.chunk, which=args.which or "auto",
            deterministic=not args.stochastic, device=args.device)
    required = ("ckpt", "height", "width", "focal", "near", "far")
    missing = [f"--{k}" for k in required if getattr(args, k) is None]
    if missing:
        raise SystemExit(f"without --run, {' '.join(missing)} are required")
    if args.which is not None:
        raise SystemExit("--which requires --run (a bare --ckpt file has no "
                         "best-val checkpoint to select)")
    return NerfRenderer(args.ckpt, height=args.height, width=args.width,
                        focal=args.focal, near=args.near, far=args.far,
                        chunk=args.chunk, ndc=bool(args.ndc),
                        ndc_variant=args.ndc_variant or "canonical",
                        deterministic=not args.stochastic, device=args.device)


def occupancy_from_args(renderer: NerfRenderer, args) -> None:
    """With ``--occupancy``, bake the grid the renderer serves through and
    say so; without it, nothing."""
    if not args.occupancy:
        return
    renderer.enable_occupancy(resolution=args.occupancy_res,
                              bound=args.occupancy_bound,
                              mode=args.occupancy, interp=args.occ_interp,
                              term=args.occ_term, floor=args.occ_floor,
                              n_coarse=args.serve_coarse,
                              n_fine=args.serve_fine)
    print(f"occupancy grid active: mode={args.occupancy} "
          f"res={args.occupancy_res} interp={args.occ_interp}"
          + (f" term={args.occ_term} samples="
             f"{renderer.cfg.n_coarse}+{renderer.cfg.n_fine}"
             if args.occ_term > 0 else ""), flush=True)


def int8_from_args(renderer: NerfRenderer, args) -> None:
    """With ``--int8``, quantize the renderer's nets (calibrated on
    ``--int8_calib`` samples: the run's poses, else the NDC box, else the
    ``±--int8_bound`` cube) and say so; without it, nothing."""
    if not args.int8:
        return
    renderer.enable_int8(n_calib=args.int8_calib, bound=args.int8_bound)
    bound = renderer.far if args.int8_bound is None else args.int8_bound
    src = ("run poses" if renderer.calib_poses is not None
           else "NDC box" if renderer.ndc
           else f"±{bound} cube")
    print(f"int8 quantized serving active "
          f"(calibrated on {args.int8_calib} samples via {src})", flush=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    renderer = renderer_from_args(args)
    occupancy_from_args(renderer, args)
    int8_from_args(renderer, args)
    srv = make_server(renderer, args.host, args.port,
                      queue_size=args.queue_size, batch_max=args.batch_max,
                      request_timeout=args.request_timeout,
                      video_timeout=args.video_timeout)
    print(f"serving checkpoint step {renderer.step} on {renderer.device} "
          f"at http://{args.host}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
