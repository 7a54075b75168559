"""Per-stage timing counters (port of the JAX package's ``utils/timer.py``)
and the program's one span recorder.

A span is a named interval on ``time.perf_counter``'s clock. Every span —
those of :func:`span` and every stage a :class:`StageTimer` times — goes into
one process-wide log of the newest :data:`LOG_SIZE` records, oldest first,
with the span that was open around it on the same thread and its thread.
:func:`recorded` reads the log and says where it has dropped records a reader
would need. Spans come from any thread (decode workers, sidecar writers).

With :func:`profiler_ranges` on, every span and every :func:`layer` range is
also a ``torch.profiler.record_function`` range named ``ctpu.<name>``, so a
profiler trace places it beside the device's work. Layer ranges go to the
profiler only, never to the log, and cost one bool check while the switch is
off (the default).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

# records the log holds: a fixed memory however long the run
LOG_SIZE = 65536
RANGE_PREFIX = "ctpu."


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float  # time.perf_counter()
    end: float
    parent: str | None  # the innermost span open on the same thread
    thread: int
    items: int  # 0 where the body raised


_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_log_lock = threading.Lock()
_dropped_end: float | None = None  # the latest end of a record the log dropped
_open = threading.local()
_ranges_on = False
_NO_RANGE = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def layer(name: str):
    """A profiler range ``ctpu.<name>`` where :func:`profiler_ranges` is on;
    else a no-op context."""
    if not _ranges_on:
        return _NO_RANGE
    from torch.profiler import record_function

    return record_function(RANGE_PREFIX + name)


@contextlib.contextmanager
def profiler_ranges(on: bool = True):
    """Turn the profiler ranges of every span and layer on (or off) for the
    block, then back to what they were."""
    global _ranges_on
    before, _ranges_on = _ranges_on, on
    try:
        yield
    finally:
        _ranges_on = before


@contextlib.contextmanager
def _timed(name: str, items: int, on_end=None):
    global _dropped_end
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(name)
    ok = False
    t0 = time.perf_counter()
    try:
        with layer(name):
            yield
        ok = True
    finally:
        stack.pop()
        done = items if ok else 0
        with _log_lock:
            t1 = time.perf_counter()
            if len(_log) == LOG_SIZE:
                _dropped_end = _log[0].end
            _log.append(Span(name, t0, t1, parent, threading.get_ident(), done))
        if on_end is not None:
            on_end(name, t1 - t0, done, ok)


def span(name: str, items: int = 0):
    """Record a span around the block; ``items`` count only where the block
    returns."""
    return _timed(name, items)


def recorded(since: float = float("-inf")) -> list[Span] | None:
    """The log's records that end at or after ``since``, oldest first; None
    where the log has dropped one of them (so the list would be short)."""
    with _log_lock:
        if _dropped_end is not None and _dropped_end >= since:
            return None
        return [s for s in _log if s.end >= since]


class StageTimer:
    """Seconds and items by stage name; every stage is also a span of the
    log."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def time(self, name: str, items: int = 0):
        return _timed(name, items, self._add)

    def _add(self, name: str, seconds: float, items: int, ok: bool) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            if ok:  # items count only on success: a raised body processed nothing
                self.counts[name] = self.counts.get(name, 0) + items

    def throughput(self, name: str) -> float:
        t = self.totals.get(name, 0.0)
        return self.counts.get(name, 0) / t if t > 0 else 0.0

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            line = f"{name}: {total:.3f}s"
            if self.counts.get(name):
                line += f" ({self.throughput(name):,.1f} items/s)"
            lines.append(line)
        return "\n".join(lines)
