"""What ``program_spans.py`` reads from the port's spans beside a recorded
trace: a window of 100 ms with the device busy over 10-30, 50-60 and
70-90 ms, two requests served in it (and one whose wait began before it),
and a trainer's blocks; every reading against its value by hand, and None
without spans."""

import pytest

from cvnerf_torch.utils.tracing import Span
from nerfbench import program_spans as ps
from nerfbench.trace import Trace

MS = 1_000_000


def span(name, sid, parent, a, b, **attrs):
    return Span(name, sid, parent, a * MS, b * MS, attrs)


def window():
    return Trace([("k", 10 * MS, 30 * MS), ("k", 50 * MS, 60 * MS),
                  ("k", 70 * MS, 90 * MS)], [], (0, 100 * MS))


def served():
    return [
        span("server.request", 1, None, 5, 45, status=200),
        span("queue.wait", 2, 1, 6, 12, request=1),
        span("queue.batch", 10, None, 12, 35, frames=1, requests=[1]),
        span("frame", 11, 10, 12, 35),
        span("queue.hold", 3, 1, 35, 40, request=1),
        span("server.encode", 4, 1, 40, 42),
        span("server.write", 5, 1, 42, 44),
        span("server.request", 6, None, 8, 80, status=200),
        span("queue.wait", 7, 6, 9, 48, request=6),
        span("queue.batch", 20, None, 48, 75, frames=1, requests=[6]),
        span("frame", 21, 20, 48, 75),
        span("queue.hold", 8, 6, 75, 78, request=6),
        span("server.encode", 9, 6, 78, 79),
        span("queue.idle", 30, None, 80, 100),
        # A request whose wait began before the window counts in no
        # reading of requests, and its wait still owes the device work.
        span("queue.wait", 40, 41, -5, 2, request=41),
        span("server.encode", 42, 41, 2, 4),
    ]


def test_serving_readings_by_hand():
    tr, spans = window(), served()
    assert ps.window_requests(spans, tr.window) == {1, 6}
    assert ps.queue_wait_ms(tr, spans) == pytest.approx(39.0)
    assert ps.batch_hold_ms(tr, spans) == pytest.approx(5.0)
    assert ps.encode_ms(tr, spans) == pytest.approx(1.5)
    # Owed: 0-2 and 6-75 ms; idle in them 2 + 4 + 20 + 10 ms.
    assert ps.idle_backlog(tr, spans) == pytest.approx(36.0)
    parts = ps.request_parts(spans, tr.window)
    assert parts[1] == pytest.approx({
        "request": 40.0, "queue.wait": 6.0, "ahead": 0.0, "frame": 23.0,
        "queue.hold": 5.0, "server.encode": 2.0, "server.write": 2.0})
    assert parts[6]["frame"] == pytest.approx(27.0)


def test_request_parts_of_a_micro_batch():
    """Request ``k`` of a batch of three owns frame ``k`` and the landing
    of index ``k``; the frames before it are ``ahead``."""
    spans = [span("queue.wait", 1, 11, 0, 10, request=11),
             span("queue.wait", 2, 12, 1, 10, request=12),
             span("queue.wait", 3, 13, 2, 10, request=13),
             span("queue.batch", 20, None, 10, 70, frames=3,
                  requests=[11, 12, 13]),
             span("frame", 21, 20, 10, 12), span("frame", 22, 20, 12, 14),
             span("frame.land", 23, 20, 14, 30, index=0),
             span("frame", 24, 20, 30, 32),
             span("frame.land", 25, 20, 32, 50, index=1),
             span("frame.land", 26, 20, 50, 68, index=2)]
    parts = ps.request_parts(spans, (0, 100 * MS))
    assert [parts[r]["ahead"] for r in (11, 12, 13)] == [0.0, 2.0, 20.0]
    assert [parts[r]["frame.land"] for r in (11, 12, 13)] == [16.0, 18.0,
                                                              18.0]
    assert [parts[r]["frame"] for r in (11, 12, 13)] == [2.0, 2.0, 2.0]


def test_idle_split_by_the_innermost_program_span():
    tr, spans = window(), served()
    split = dict(ps.idle_by_program_span(tr, spans))
    assert split == pytest.approx({
        "queue.wait": 0.009, ps.OUTSIDE: 0.001, "server.request": 0.002,
        "frame": 0.017, "queue.hold": 0.005, "server.encode": 0.004,
        "server.write": 0.002, "queue.idle": 0.010})
    assert sum(split.values()) == pytest.approx(0.050)
    assert ps.idle_by_program_span(tr, []) == [[ps.OUTSIDE,
                                                pytest.approx(0.050)]]
    assert len(ps.idle_by_program_span(tr, spans, top=3)) == 3
    # Gaps of 15 ms or more: 30-50 ms alone.
    assert ps.idle_gaps(tr, 15 * MS) == [(30 * MS, 50 * MS)]
    assert dict(ps.idle_by_program_span(tr, spans, least_ns=15 * MS)) == \
        pytest.approx({"frame": 0.007, "queue.hold": 0.005,
                       "server.encode": 0.002, "server.write": 0.002,
                       "queue.wait": 0.004})


def test_block_prep_time_counts_the_windows_blocks():
    """The median of the window's ``train.prep``: 2 and 3 ms (the block
    past the window's end counts not, nor do the replays)."""
    tr = window()
    spans = [span("train.run", 1, None, 5, 99, steps=30),
             span("train.block", 2, 1, 10, 20, captured=False),
             span("train.prep", 5, 2, 10, 12),
             span("train.replay", 6, 2, 12, 20),
             span("train.block", 3, 1, 30, 36, captured=False),
             span("train.prep", 7, 3, 30, 33),
             span("train.replay", 8, 3, 33, 36),
             span("train.block", 4, 1, 95, 105, captured=False),
             span("train.prep", 9, 4, 95, 101),
             span("train.replay", 10, 4, 101, 105)]
    assert ps.block_prep_ms(tr, spans) == pytest.approx(2.5)


def test_readers_find_nothing_without_spans():
    tr = window()
    for read in (ps.queue_wait_ms, ps.batch_hold_ms, ps.encode_ms,
                 ps.idle_backlog, ps.block_prep_ms):
        assert read(tr, []) is None
    # Serving spans hold no block; training spans no request.
    assert ps.block_prep_ms(tr, served()) is None
    assert ps.queue_wait_ms(tr, [span("train.block", 1, None, 1, 2)]) \
        is None


def test_align_moves_every_stamp():
    (s,) = ps.align([span("frame", 1, None, 1, 2)], 5)
    assert (s.start_ns, s.end_ns) == (MS + 5, 2 * MS + 5)
