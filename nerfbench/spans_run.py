"""One run of one cell as ``run.py`` makes it, with the port's span
recorder (``cvnerf_torch.utils.tracing``) on from just before the window to
just after it:

    python3 nerfbench/spans_run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> --record <0|1>

The last line on standard output is ``run.py``'s result object with one
key more, ``program_spans``: the spans recorded (count, bytes held, spans
dropped) and, with ``--trace 1``, what ``program_spans.py`` reads from them
against the window's device trace (the five readings, the idle split, the
clock offset, the request parts). With ``--record 0`` the run is
``run.py``'s; runs with ``--record 0`` and ``1`` on one seed, in turns,
measure what recording costs. The recorder is switched where both cells
open their window's profiler (``trace.profiled``), and the serving cell's
requests and server are kept where it makes them (``serve_cell.offer``,
``serve_cell.start_server``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLOCK = "nerfbench.clock"
# Clock annotations a traced run makes: the least gap between a
# ``time.time_ns()`` read and the annotation's start bounds the offset of
# the two clocks (the first annotation after the profiler starts is slow).
CLOCK_READS = 8
LONG_GAP_NS = 10_000


def span_bytes(spans: list) -> int:
    """The bytes the spans' tuples, attribute dicts and lists hold."""
    return sum(sys.getsizeof(s) + sys.getsizeof(s.attrs)
               + sum(sys.getsizeof(v) for v in s.attrs.values()
                     if isinstance(v, list)) for s in spans)


@contextlib.contextmanager
def kept(record: bool):
    """While open, the cells' window profiler switches the recorder on and
    off around the window, and what the run makes is kept in the yielded
    dict: ``spans``, ``dropped``, ``clock_ns`` (``time.time_ns()`` read
    just before each ``CLOCK`` annotation, traced runs), ``trace``, the
    serving window's request records ``recs`` and its ``server``."""
    from cvnerf_torch.utils import tracing
    from nerfbench import serve_cell, trace
    from torch.profiler import record_function
    got: dict = {"spans": [], "dropped": 0, "recs": []}
    profiled, offer, start = (trace.profiled, serve_cell.offer,
                              serve_cell.start_server)

    @contextlib.contextmanager
    def recording(enabled: bool):
        with profiled(enabled) as holder:
            got["clock_ns"] = []
            for _ in range(CLOCK_READS if enabled else 0):
                got["clock_ns"].append(time.time_ns())
                with record_function(CLOCK):
                    pass
            if record:
                tracing.enable()
            try:
                yield holder
            finally:
                tracing.disable()
                got["spans"] = tracing.drain()
                got["dropped"] = tracing.dropped()
        got["trace"] = holder[0] if holder else None

    def offered(*args, **kwargs):
        recs = offer(*args, **kwargs)
        got["recs"] = recs
        return recs

    def started(*args, **kwargs):
        out = start(*args, **kwargs)
        got["server"] = out[0]
        return out

    trace.profiled, serve_cell.offer = recording, offered
    serve_cell.start_server = started
    try:
        yield got
    finally:
        trace.profiled, serve_cell.offer = profiled, offer
        serve_cell.start_server = start


def readings(got: dict, kind: str) -> dict:
    """What the recorded spans say of the traced window."""
    from nerfbench import program_spans as ps
    from nerfbench.serve_cell import percentile
    tr = got["trace"]
    clocks = sorted(s[1] for s in tr.spans if s[0] == CLOCK)
    offset = min(a - b for a, b in zip(clocks, got["clock_ns"]))
    spans = ps.align(got["spans"], offset)
    lo, hi = tr.window
    out = {"clock_offset_ns": offset,
           "idle_s": tr.window_s - tr.busy_s(),
           "idle_by_program_span": ps.idle_by_program_span(tr, spans)}
    if kind == "serve":
        ids = ps.window_requests(spans, tr.window)
        out["outside_window"] = sum(
            1 for s in spans if (s.attrs.get("request") in ids
                                 or s.id in ids or s.parent in ids)
            and (s.start_ns < lo or s.end_ns > hi))
        for name in ("queue_wait_ms", "batch_hold_ms", "encode_ms",
                     "idle_backlog"):
            out[name + ".serve"] = getattr(ps, name)(tr, spans)
        parts = ps.request_parts(spans, tr.window)
        req = [p["request"] for p in parts.values() if "request" in p]
        sent = [(r["done"] - r["sent"]) * 1e3 for r in got["recs"]
                if r.get("status") == 200]
        out["requests"] = len(parts)
        out["server_request_ms"] = [percentile(req, 0.5),
                                    percentile(req, 0.95)] if req else None
        out["done_minus_sent_ms"] = [percentile(sent, 0.5),
                                     percentile(sent, 0.95)] if sent else None
        names = ("queue.wait", "frame", "queue.hold", "server.encode",
                 "server.write")
        for key, part in (("parts_cover_median", names),
                          ("all_parts_cover_median",
                           names + ("ahead", "frame.land"))):
            cover = [sum(p.get(n, 0.0) for n in part) / p["request"]
                     for p in parts.values() if p.get("request")]
            out[key] = statistics.median(cover) if cover else None
        for q in (0.5, 0.95):
            out[f"parts_ms_p{round(q * 100)}"] = {n: percentile(
                [p.get(n, 0.0) for p in parts.values()], q)
                for n in names + ("ahead", "frame.land")}
        srv = got.get("server")
        if srv is not None:
            out["queue_stats"] = srv.device_queue.read_stats()
            out["frame_programs_stats"] = srv.renderer.programs.stats
    else:
        out["block_prep_ms.train"] = ps.block_prep_ms(tr, spans)
        out["train_runs"] = sum(1 for s in spans if s.name == "train.run"
                                and lo <= s.start_ns and s.end_ns <= hi)
        for name in ("train.prep", "train.replay"):
            ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans
                  if s.name == name and lo <= s.start_ns < hi]
            out[name + "_median_ms"] = statistics.median(ms) if ms else None
    # Idle in gaps of 10 us or more: what is left without the gaps
    # between one kernel and the next.
    out["idle_gaps_10us"] = len(ps.idle_gaps(tr, LONG_GAP_NS))
    out["idle_by_program_span_10us"] = ps.idle_by_program_span(
        tr, spans, least_ns=LONG_GAP_NS)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import torch

    from nerfbench import harness
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        harness.note(f"{args.workload} needs a CUDA device")
        return 2
    kind = harness.load("traffic", cell["traffic"])["kind"]
    with kept(bool(args.record)) as got:
        result = harness.run_cell(bench, cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T0)
    found = harness.forbidden_modules()
    if found:
        harness.note(f"loaded after the window: {', '.join(found)}")
        return 3
    spans = got["spans"]
    result["program_spans"] = {"recorded": len(spans),
                               "bytes": span_bytes(spans),
                               "dropped": got["dropped"]}
    if args.record and args.trace:
        result["program_spans"].update(readings(got, kind))
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
