"""The device trace of a run's window, reduced to what the per-layer
readers need: device activity intervals by name, the benchmark's own host
spans (``torch.profiler.record_function`` annotations named
``nerfbench.*``, on the trace's clock) and the traced window.

A reader (``metrics/<name>/read.py``) takes a :class:`Trace` and the
cell's context and returns a number, or None where it finds nothing to
read; the names it matches sit in its own ``kernels/*.txt`` files, one
name a line, matched as whole identifiers inside the profiler's kernel
names.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from pathlib import Path

WINDOW = "nerfbench.window"


class Trace:
    """Device intervals ``(name, start_ns, end_ns)``, host spans ``(name,
    start_ns, end_ns)`` and the window ``(start_ns, end_ns)``."""

    def __init__(self, device: list, spans: list, window: tuple):
        self.device = sorted(device, key=lambda e: e[1])
        self.spans = sorted(spans, key=lambda e: e[1])
        self.window = window
        self._merged: list | None = None
        self._starts: list = []

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def matching(self, names: list[str]) -> list:
        """The device intervals whose name holds one of ``names`` as a
        whole identifier."""
        if not names:
            return []
        pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                         + "|".join(re.escape(n) for n in names)
                         + r")(?![A-Za-z0-9_])")
        return [e for e in self.device if pat.search(e[0])]

    def seconds(self, events: list) -> float:
        """Summed durations of ``events``."""
        return sum(e[2] - e[1] for e in events) / 1e9

    def busy_s(self, lo: int | None = None, hi: int | None = None) -> float:
        """Seconds in which some device activity ran, between ``lo`` and
        ``hi`` (default the window)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        if self._merged is None:
            self._merged = _merge(self.device)
            self._starts = [s for s, _ in self._merged]
        total = 0
        for s, e in self._merged[max(0, bisect.bisect_right(
                self._starts, lo) - 1):]:
            if s >= hi:
                break
            total += max(0, min(e, hi) - max(s, lo))
        return total / 1e9


def _merge(events) -> list[tuple[int, int]]:
    """The intervals of ``events`` (sorted by start) merged where they
    overlap."""
    out: list[list[int]] = []
    for _, s, e in events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def names_in(metric_dir: str | Path) -> list[str]:
    """The kernel names of a metric: every line of its ``kernels/*.txt``
    files, blank lines and ``#`` comments left out."""
    out = []
    for f in sorted(Path(metric_dir, "kernels").glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` record of host and device activity while
    ``enabled``; yields a one-slot list that holds the :class:`Trace` once
    the block has ended."""
    holder: list = []
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.append(from_events(prof.profiler.kineto_results.events()))


def from_events(events) -> Trace:
    """A :class:`Trace` of kineto events: device kernels, copies and fills,
    the ``nerfbench.*`` annotations, and the window annotation."""
    device, spans, window = [], [], None
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            # The device side of a host annotation is no device work.
            if name.startswith("nerfbench.") or "annotation" in str(
                    getattr(e, "activity_type", str)()):
                continue
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("nerfbench."):
            span = (name, e.start_ns(), e.start_ns() + e.duration_ns())
            if name == WINDOW:
                window = span[1:]
            else:
                spans.append(span)
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    return Trace(device, spans, window)


def short_name(kernel: str) -> str:
    """A kernel's identifier without namespaces, template arguments or
    parameters."""
    head = re.split(r"[<(]", kernel.replace("void ", "", 1), 1)[0]
    return head.rsplit("::", 1)[-1].strip()[:80] or kernel[:80]


def breakdown(trace: Trace, label_spans: str = "nerfbench.") -> dict:
    """The device operations that took most time (by short name) and the
    idle time inside the window by the host span that covered it (``host
    outside any span`` where none did), ten each, in seconds."""
    lo, hi = trace.window
    ops: dict[str, float] = {}
    for name, s, e in trace.device:
        if e > lo and s < hi:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
    gaps: dict[str, float] = {}
    spans = [s for s in trace.spans if s[0].startswith(label_spans)]
    starts = [a for _, a, _ in spans]
    trace.busy_s()
    cur = lo
    for s, e in trace._merged + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > cur:
            mid = (cur + s) // 2
            k = bisect.bisect_right(starts, mid) - 1
            label = (spans[k][0].split(":")[0]
                     if k >= 0 and spans[k][2] > mid
                     else "host outside any span")
            gaps[label] = gaps.get(label, 0.0) + (s - cur) / 1e9
        cur = max(cur, e)
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
