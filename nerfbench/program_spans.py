"""The port's own spans (``cvnerf_torch.utils.tracing``) read beside a
window's device trace: moved onto the trace's clock, the window's idle
time split by the innermost program span that covered it, and the
readings of the serving queue, the encode and the trainer's block
dispatch.

A span here is the recorder's ``Span``: ``(name, id, parent, start_ns,
end_ns, attrs)``. The readings count only requests whose ``queue.wait``
began inside the window and blocks that lie inside it, and read None
where they find no such span. ``spans_run.py`` records the spans of a
cell's window and prints what this module reads from them.
"""

from __future__ import annotations

import statistics

from nerfbench.serve_cell import percentile
from nerfbench.trace import _merge

OUTSIDE = "outside any program span"


def align(spans: list, offset_ns: int) -> list:
    """``spans`` with ``offset_ns`` added to every stamp."""
    return [s._replace(start_ns=s.start_ns + offset_ns,
                       end_ns=s.end_ns + offset_ns) for s in spans]


def window_requests(spans: list, window: tuple) -> set:
    """The ids of the requests whose ``queue.wait`` began inside
    ``window``."""
    lo, hi = window
    return {s.attrs["request"] for s in spans
            if s.name == "queue.wait" and lo <= s.start_ns < hi}


def _ms(spans: list, name: str, requests: set, key: str) -> list[float]:
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans
            if s.name == name and (s.parent if key == "parent"
                                   else s.attrs.get(key)) in requests]


def queue_wait_ms(trace, spans: list) -> float | None:
    """p95 (nearest rank) of the window's requests' ``queue.wait``."""
    ms = _ms(spans, "queue.wait", window_requests(spans, trace.window),
             "request")
    return percentile(ms, 0.95) if ms else None


def batch_hold_ms(trace, spans: list) -> float | None:
    """p95 (nearest rank) of the window's requests' ``queue.hold``: a
    frame on the host until its waiter is woken, which in a micro-batch
    waits for the batch's later frames."""
    ms = _ms(spans, "queue.hold", window_requests(spans, trace.window),
             "request")
    return percentile(ms, 0.95) if ms else None


def encode_ms(trace, spans: list) -> float | None:
    """Median ``server.encode`` of the window's answered requests (an
    encode follows a rendered frame only)."""
    ms = _ms(spans, "server.encode", window_requests(spans, trace.window),
             "parent")
    return statistics.median(ms) if ms else None


def idle_backlog(trace, spans: list) -> float | None:
    """The share of the window (%) in which the device was idle while work
    was owed to it: some request's ``queue.wait`` or some
    ``queue.batch`` was open."""
    lo, hi = trace.window
    owed = [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans
            if s.name in ("queue.wait", "queue.batch")
            and s.end_ns > lo and s.start_ns < hi]
    if not owed or trace.window_s <= 0:
        return None
    idle = sum((e - s) / 1e9 - trace.busy_s(s, e)
               for s, e in _merge([(None, s, e) for s, e in sorted(owed)]))
    return 100.0 * idle / trace.window_s


def block_prep_ms(trace, spans: list) -> float | None:
    """Median ``train.prep`` inside the window: a block's host dispatch
    (its step tables, staged copies and graph lookup), without its
    replays, which wait on a full launch queue and so follow the device
    time."""
    lo, hi = trace.window
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans
          if s.name == "train.prep" and lo <= s.start_ns and s.end_ns <= hi]
    return statistics.median(ms) if ms else None


def idle_gaps(trace, least_ns: int = 0) -> list[tuple[int, int]]:
    """The stretches of the window in which nothing ran on the device, of
    at least ``least_ns``."""
    lo, hi = trace.window
    out, cur = [], lo
    for s, e in _merge(trace.device) + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > cur and s - cur >= least_ns:
            out.append((cur, s))
        cur = max(cur, e)
    return out


def idle_by_program_span(trace, spans: list, top: int = 10,
                         least_ns: int = 0) -> list:
    """The window's idle seconds (in gaps of at least ``least_ns``) by the
    innermost program span open across them (the open span that started
    last; ``OUTSIDE`` where none was open), the ``top`` largest, as
    ``[name, seconds]``."""
    lo, hi = trace.window
    edges = []
    for k, s in enumerate(spans):
        a, b = max(s.start_ns, lo), min(s.end_ns, hi)
        if a < b:
            edges += [(a, 1, k), (b, 0, k)]
    edges.sort()
    gaps = idle_gaps(trace, least_ns)
    split: dict[str, float] = {}
    active: set = set()
    g, cur = 0, lo

    def label(a: int, b: int) -> None:
        """Charge the idle time of ``[a, b)`` to the current label."""
        nonlocal g
        name = (spans[max(active, key=lambda k: (spans[k].start_ns, k))].name
                if active else OUTSIDE)
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        j = g
        while j < len(gaps) and gaps[j][0] < b:
            t = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if t > 0:
                split[name] = split.get(name, 0.0) + t / 1e9
            j += 1

    for t, opens, k in edges:
        if t > cur:
            label(cur, t)
            cur = t
        (active.add if opens else active.discard)(k)
    label(cur, hi)
    return [[k, v] for k, v in sorted(split.items(), key=lambda kv: -kv[1])
            [:top]]


def request_parts(spans: list, window: tuple) -> dict:
    """For each of the window's requests, the milliseconds of its
    ``server.request`` and of the parts inside it: ``queue.wait``,
    ``ahead`` (its batch's earlier frames, from the batch's start to its
    own frame's), its own ``frame`` and ``frame.land`` (frame ``k`` of a
    batch is the batch's request ``k``), ``queue.hold``,
    ``server.encode`` and ``server.write``."""
    ids = window_requests(spans, window)
    ms = lambda s: (s.end_ns - s.start_ns) / 1e6  # noqa: E731
    out = {r: {} for r in ids}
    kids: dict = {}
    for s in spans:
        if s.name in ("frame", "frame.land"):
            kids.setdefault((s.parent, s.name), []).append(s)
    for s in spans:
        if s.name == "server.request" and s.id in out:
            out[s.id]["request"] = ms(s)
        elif s.name in ("server.encode", "server.write") and s.parent in out:
            out[s.parent][s.name] = ms(s)
        elif s.name in ("queue.wait", "queue.hold") \
                and s.attrs["request"] in out:
            out[s.attrs["request"]][s.name] = ms(s)
        elif s.name == "queue.batch":
            own = sorted(kids.get((s.id, "frame"), []),
                         key=lambda f: f.start_ns)
            lands = {f.attrs["index"]: f
                     for f in kids.get((s.id, "frame.land"), [])}
            for k, (r, f) in enumerate(zip(s.attrs["requests"], own)):
                if r in out:
                    out[r]["ahead"] = (f.start_ns - s.start_ns) / 1e6
                    out[r]["frame"] = ms(f)
                    if k in lands:
                        out[r]["frame.land"] = ms(lands[k])
    return out
