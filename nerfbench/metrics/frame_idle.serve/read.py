"""The share of the render calls' spans in which nothing ran on the
device; the idle time between arrivals, which the offered load sets, is
left out."""


def read(trace, ctx):
    spans = ctx["frame_spans"]
    total = sum(b - a for a, b, _ in spans) / 1e9
    if not spans or not trace.device or total <= 0:
        return None
    busy = sum(trace.busy_s(a, b) for a, b, _ in spans)
    return 100.0 * (1.0 - busy / total)
