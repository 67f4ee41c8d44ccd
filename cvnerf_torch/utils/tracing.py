"""Spans of the port's own work: what the server, its device queue, the
frame programs and the trainer did on the host, and when.

A span is ``(name, id, parent, start_ns, end_ns, attrs)``, kept in a
bounded buffer in this process's memory; once the buffer is full the oldest
spans are dropped and counted (``dropped``). Recording is off until
:func:`enable` and stays on until :func:`disable`; :func:`drain` hands the
spans over and empties the buffer. Nothing else turns it on.

The stamps are ``time.time_ns()``, the Unix-epoch clock on which
``torch.profiler`` puts its host events, so program spans and a device
trace share one timeline.

Off, :func:`span` is one module-level check that returns one shared no-op
object, and :func:`now` returns 0 without reading the clock. On or off, no
span reads a device value, synchronizes or copies.

``span(name)`` times a ``with`` block in one thread; its parent is the
innermost span open in that thread. ``record`` stores a span
whose start was stamped (:func:`now`) in one thread and whose end comes in
another, as a queued job's wait does.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, NamedTuple

# Spans the buffer holds: a 50 s serving window records ~5,000 (~1 MB) and
# a 50 s training window ~3,000 (PERF.md).
CAPACITY = 1 << 17


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    attrs: dict


_on = False
_lock = threading.Lock()
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class _Noop:
    """What :func:`span` returns while recording is off."""

    id = None
    children: tuple = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        """Nothing: the attributes of a span that is not recorded."""


NOOP = _Noop()


class _Open:
    """A span being timed in this thread. ``children`` lists ``(name,
    end_ns, attrs)`` of the direct children that have ended (a batch reads
    when each of its frames landed)."""

    __slots__ = ("name", "id", "parent", "start_ns", "attrs", "children",
                 "_up")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.children: list = []

    def __enter__(self):
        stack = _stack()
        self._up = stack[-1] if stack else None
        self.parent = None if self._up is None else self._up.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _stack().pop()
        if self._up is not None:
            self._up.children.append((self.name, end, self.attrs))
        _append(Span(self.name, self.id, self.parent, self.start_ns, end,
                     self.attrs))

    def set(self, **attrs) -> None:
        """Add attributes to the span."""
        self.attrs.update(attrs)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(s: Span) -> None:
    """Keep ``s`` unless recording was switched off before it ended."""
    global _dropped
    with _lock:
        if not _on:
            return
        if len(_buf) == _buf.maxlen:
            _dropped += 1
        _buf.append(s)


def enable() -> None:
    """Start recording into an empty buffer of ``CAPACITY`` spans."""
    global _on, _buf, _dropped
    with _lock:
        _buf = collections.deque(maxlen=CAPACITY)
        _dropped = 0
        _on = True


def disable() -> None:
    """Stop recording (a span still open is not kept); spans already
    recorded stay until :func:`drain`."""
    global _on
    _on = False


def drain() -> list[Span]:
    """The recorded spans in the order they ended; the buffer is left
    empty."""
    with _lock:
        out = list(_buf)
        _buf.clear()
    return out


def dropped() -> int:
    """Spans dropped from a full buffer since :func:`enable`."""
    return _dropped


def now() -> int:
    """A start stamp for :func:`record`: ``time.time_ns()`` while recording,
    else 0 (the clock is not read)."""
    return time.time_ns() if _on else 0


def span(name: str, **attrs: Any):
    """A context manager that records the span of its block (its parent:
    the innermost span open in this thread); its ``id`` is None while
    recording is off."""
    if not _on:
        return NOOP
    return _Open(name, attrs)


def record(name: str, start_ns: int, end_ns: int, parent: int | None = None,
           **attrs: Any) -> None:
    """Record a span timed elsewhere. Nothing is recorded while recording
    is off, nor where ``start_ns`` is 0 (stamped by :func:`now` while it
    was off)."""
    if _on and start_ns:
        _append(Span(name, next(_ids), parent, start_ns, end_ns, attrs))
