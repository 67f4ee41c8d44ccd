"""The port's span recorder (``cvnerf_torch/utils/tracing.py``) and the
spans and counters of the server, its device queue, the frame programs
and the trainer, on the CPU.

* Off: ``span`` is the shared no-op, the clock is not read, and a queue,
  a frame and a ``Trainer.run`` record nothing.
* On: nested spans carry their parents' ids, ``record`` joins a start
  stamped in one thread to an end in another, a full buffer drops its
  oldest spans and counts them, ``drain`` empties it, and the stamps are
  ``time.time_ns()``.
* The queue: a burst of six requests micro-batched four and two; every
  request's wait and hold, each batch's request ids in order, the last
  frame of a batch held least, and ``DeviceQueue.stats`` with a 503 and a
  waiter that gave up.
* ``Trainer.run`` in blocks of two: the ``train.run`` tree.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cvnerf_torch.models.nerf_mlp import NerfMLPConfig
from cvnerf_torch.ops.rng import PRNGKey
from cvnerf_torch.render.frames import MAX_PROGRAMS, FramePrograms
from cvnerf_torch.render.renderer import RenderConfig
from cvnerf_torch.server import (DeviceQueue, QueueFullError,
                                 RenderTimeoutError, make_server)
from cvnerf_torch.train.loop import TrainConfig, Trainer
from cvnerf_torch.train.state import create_train_state
from cvnerf_torch.utils import tracing

TINY = dict(xyz_freqs=4, dir_freqs=2, trunk_width=32, head_width=32)
H, W, FOCAL, CHUNK = 5, 7, 7.0, 16
POSE = np.array([[1, 0, 0, 0.1], [0, 0.8, -0.6, -2.4], [0, 0.6, 0.8, 3.2]],
                np.float32)


@pytest.fixture
def clean():
    """Recording off and the buffer empty before and after the test."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture
def recording(clean):
    tracing.enable()
    yield


def _renderer(tmp_path):
    from cvnerf_torch.serve import NerfRenderer
    from cvnerf_torch.train.checkpoint import save_checkpoint
    state = create_train_state(PRNGKey(3), mlp=NerfMLPConfig(**TINY),
                               device="cpu")
    for net in state.params.values():
        net["alpha"]["b"] += 1.0
    save_checkpoint(str(tmp_path), state)
    return NerfRenderer(str(tmp_path / "000000.pt"), height=H, width=W,
                        focal=FOCAL, near=2.0, far=6.0,
                        cfg=RenderConfig(n_coarse=8, n_fine=8,
                                         mlp=NerfMLPConfig(**TINY)),
                        chunk=CHUNK, device="cpu")


def _trainer(steps_per_call=2):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    poses = np.stack([POSE, POSE * [1, 1, 1, 1.1]]).astype(np.float32)
    cfg = TrainConfig(height=16, width=16, focal=20.0, near=2.0, far=6.0,
                      n_rays=32, render=RenderConfig(
                          n_coarse=4, n_fine=4, mlp=NerfMLPConfig(**TINY)))
    state = create_train_state(PRNGKey(1), mlp=NerfMLPConfig(**TINY),
                               device="cpu")
    return Trainer(cfg, state, images, poses, [0, 1], seed=7,
                   steps_per_call=steps_per_call)


def _by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_span_is_the_shared_noop(clean, monkeypatch):
    reads = []
    real = time.time_ns
    monkeypatch.setattr(tracing.time, "time_ns",
                        lambda: reads.append(1) or real())
    a = tracing.span("x", k=1)
    assert a is tracing.span("y") is tracing.NOOP
    with a as sp:
        sp.set(v=2)
    assert sp.id is None and tracing.now() == 0
    tracing.record("z", 5, 9)
    assert reads == [] and tracing.drain() == []


def test_off_the_queue_frames_and_trainer_record_nothing(clean, tmp_path,
                                                        monkeypatch):
    reads = []
    real = time.time_ns
    monkeypatch.setattr(tracing.time, "time_ns",
                        lambda: reads.append(1) or real())
    r = _renderer(tmp_path)
    q = DeviceQueue(r, batch_max=4)
    try:
        with q._cv:
            jobs = [q.submit_async(POSE, 0, ("rgb",)) for _ in range(3)]
        for j in jobs:
            q.wait(j, timeout=120)
        q.render(POSE, timeout=120)
    finally:
        q.close()
    _trainer().run(1, 6)
    tracing.enable()
    assert tracing.drain() == [] and reads == []


def test_nested_spans_carry_their_parents_ids(recording):
    t0 = time.time_ns()
    with tracing.span("a", x=1) as a:
        with tracing.span("b") as b:
            with tracing.span("c"):
                pass
        b.set(y=2)
    t1 = time.time_ns()
    got = {s.name: s for s in tracing.drain()}
    assert [got[k].parent for k in "abc"] == [None, a.id, b.id]
    assert got["b"].id == b.id and got["a"].attrs == {"x": 1}
    assert got["b"].attrs == {"y": 2}
    for s in got.values():
        assert t0 <= s.start_ns <= s.end_ns <= t1
    assert got["a"].start_ns <= got["b"].start_ns
    assert got["b"].end_ns <= got["a"].end_ns
    assert [c[0] for c in a.children] == ["b"]
    assert [c[0] for c in b.children] == ["c"]
    assert tracing.drain() == []


def test_record_joins_a_start_and_an_end_of_two_threads(recording):
    with tracing.span("parent") as p:
        start = tracing.now()

    def finish():
        tracing.record("wait", start, tracing.now(), parent=p.id, k=3)
        with tracing.span("in_thread"):
            pass
    th = threading.Thread(target=finish)
    th.start()
    th.join(30)
    assert not th.is_alive()
    got = {s.name: s for s in tracing.drain()}
    assert got["wait"].parent == p.id and got["wait"].attrs == {"k": 3}
    assert got["wait"].start_ns == start <= got["wait"].end_ns
    # Another thread's span has no parent from this one.
    assert got["in_thread"].parent is None


def test_a_full_buffer_drops_the_oldest_spans_and_counts_them(clean,
                                                              monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for k in range(5):
        tracing.record(f"s{k}", k + 1, k + 2)
    assert tracing.dropped() == 2
    assert [s.name for s in tracing.drain()] == ["s2", "s3", "s4"]
    assert tracing.drain() == []
    tracing.enable()
    assert tracing.dropped() == 0


def test_a_burst_of_six_through_the_queue(recording, tmp_path):
    r = _renderer(tmp_path)
    q = DeviceQueue(r, maxsize=7, batch_max=4)
    try:
        with q._cv:              # the worker pops four, then the rest
            jobs = [q.submit_async(POSE * [1, 1, 1, 1 + k / 50], 0,
                                   ("rgb",), request=100 + k)
                    for k in range(7)]
            with pytest.raises(QueueFullError):
                q.submit_async(POSE, 0, ("rgb",))
            with pytest.raises(RenderTimeoutError):
                q.wait(jobs[6], timeout=0)      # its waiter gives up
        for j in jobs[:6]:
            q.wait(j, timeout=120)
    finally:
        q.close()
    assert q.read_stats() == {"admitted": 7, "rejected_full": 1,
                              "timed_out": 1, "failed": 0, "batches": 2,
                              "frames": 6, "abandoned_skipped": 1}
    spans = tracing.drain()
    by = _by_name(spans)
    batches = sorted(by["queue.batch"], key=lambda s: s.start_ns)
    assert [b.attrs["requests"] for b in batches] == [
        [100, 101, 102, 103], [104, 105]]
    assert [b.attrs["frames"] for b in batches] == [4, 2]
    for name in ("queue.wait", "queue.hold"):
        assert sorted(s.attrs["request"] for s in by[name]) == \
            list(range(100, 106))
        assert all(s.parent == s.attrs["request"] for s in by[name])
    hold = {s.attrs["request"]: s.end_ns - s.start_ns
            for s in by["queue.hold"]}
    for b in batches:
        ids = b.attrs["requests"]
        assert min(ids, key=hold.get) == ids[-1]
        assert hold[ids[0]] > hold[ids[-1]]
    wait = {s.attrs["request"]: s for s in by["queue.wait"]}
    assert all(wait[i].end_ns <= batches[0].start_ns for i in range(100, 104))
    # Each batch's frames are its children, one program run each, and the
    # frames of a sequence land in order.
    frames = [s for s in by["frame"]]
    assert sorted(s.parent for s in frames) == \
        [batches[0].id] * 4 + [batches[1].id] * 2
    assert len(by["frame.eager"]) == len(by["frame.load"]) == 6
    assert len(by["frame.take"]) == len(by["frame.lock"]) == 6
    lands = [s for s in by["frame.land"] if s.parent == batches[0].id]
    assert [s.attrs["index"] for s in lands] == [0, 1, 2, 3]
    assert len(by.get("queue.idle", [])) >= 1


def test_the_request_spans_of_the_http_server(recording, tmp_path):
    srv = make_server(_renderer(tmp_path), "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/render"
    try:
        for body in ({"c2w": POSE.tolist()}, {"c2w": [1, 2]}):
            req = urllib.request.Request(url, data=json.dumps(body).encode())
            try:
                urllib.request.urlopen(req, timeout=60).read()
            except urllib.error.HTTPError as err:
                assert err.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
    assert not th.is_alive()
    by = _by_name(tracing.drain())
    ok, bad = sorted(by["server.request"], key=lambda s: s.start_ns)
    assert (ok.attrs["status"], bad.attrs["status"]) == (200, 400)
    assert [s.parent for s in by["server.read"]] == [ok.id, bad.id]
    for name in ("server.encode", "server.write"):
        (s,) = by[name]
        assert s.parent == ok.id and ok.start_ns <= s.start_ns
        assert s.end_ns <= ok.end_ns
    for name in ("queue.wait", "queue.hold"):
        (s,) = by[name]
        assert s.attrs["request"] == ok.id
        assert ok.start_ns <= s.start_ns <= s.end_ns <= ok.end_ns
    (b,) = by["queue.batch"]
    assert b.attrs["requests"] == [ok.id]
    (f,) = by["frame"]
    assert f.parent == b.id
    # One frame is on the host when its frame span ends.
    assert by["queue.hold"][0].start_ns == f.end_ns


def test_frame_programs_count_evictions(clean):
    cfg = RenderConfig(n_coarse=4, n_fine=4, perturb=False,
                       deterministic_resample=True, mlp=NerfMLPConfig(**TINY))
    nets = create_train_state(PRNGKey(2), mlp=cfg.mlp,
                              device="cpu").params
    programs = FramePrograms()
    for h in range(1, MAX_PROGRAMS + 3):
        programs(nets, h, 3, FOCAL, torch.from_numpy(POSE), 2.0, 6.0, cfg,
                 device="cpu", take=lambda out: None, chunk=CHUNK)
    assert programs.stats == {"evictions": 2}
    assert len(programs.programs) == MAX_PROGRAMS


def test_the_trainer_span_tree(recording):
    tr = _trainer(steps_per_call=2)
    fired = []
    tr.add_callback(4, lambda i, t, m: fired.append(i))
    tr.run(1, 8)        # blocks [1, 2], [3, 4], [5, 6]; step 7 alone
    assert fired == [4]
    spans = tracing.drain()
    by = _by_name(spans)
    (run,) = by["train.run"]
    assert run.parent is None and run.attrs == {"steps": 7}
    blocks = by["train.block"]
    assert len(blocks) == 3 and len(by["train.step"]) == 1
    assert all(s.parent == run.id for s in
               blocks + by["train.step"] + by["train.read"]
               + by["train.callbacks"])
    assert len(by["train.read"]) == 2
    assert by["train.callbacks"][0].attrs == {"step": 4}
    for b in blocks:
        assert b.attrs == {"steps": 2, "captured": False}
        kids = sorted((s for s in spans if s.parent == b.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["train.prep", "train.eager"]
    # The read that follows the callback's step, and the run's last.
    read_after = sorted(s.start_ns for s in by["train.read"])
    assert blocks[1].end_ns <= read_after[0] <= by["train.callbacks"][
        0].start_ns
    assert read_after[1] >= by["train.step"][0].end_ns
