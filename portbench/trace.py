"""Spans around the harness's calls into the port, and the reading of a
``torch.profiler`` trace of the measured window.

A span is named once and summed on the host's clock; in a traced run it is
also a ``record_function`` range named ``pb:<name>``, so the trace places it
on the same clock as the device's operations. The trace gives the device's
busy time (the union of its operations' intervals: kernels, copies and
memsets), its time by operation name, and the idle gaps, each put down to the
span the host was in while the device waited.
"""
from __future__ import annotations

import collections
import contextlib
import time

PREFIX = "pb:"
WINDOW = "window"


class Spans:
    """Host-clock totals of named spans; ``traced`` also marks each in the
    profiler's trace."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.totals: dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.traced:
                from torch.profiler import record_function

                with record_function(PREFIX + name):
                    yield
            else:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return fn() if fn is not None else int(getattr(event, f"{what}_us")() * 1000)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _covered(union: list[tuple[int, int]], lo: int, hi: int) -> int:
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in union)


class TraceSummary:
    """What one traced window holds: ``window`` (its bounds, ns), ``ops``
    ([(name, start, end)] of the device's operations inside it), ``spans``
    ({name: [(start, end)]} of the harness's spans)."""

    def __init__(self, events):
        self.ops: list[tuple[str, int, int]] = []
        self.spans: dict[str, list[tuple[int, int]]] = collections.defaultdict(list)
        for e in events:
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            name = e.name()
            on_device = "CUDA" in str(e.device_type())
            if name.startswith(PREFIX):
                # a span's range appears twice: on the host, and as the device
                # interval of the work launched inside it, which is no operation
                if not on_device:
                    self.spans[name[len(PREFIX):]].append((start, end))
            elif on_device:
                self.ops.append((name, start, end))
        if not self.spans.get(WINDOW):
            raise RuntimeError("the trace holds no window span")
        self.window = self.spans[WINDOW][0]
        lo, hi = self.window
        self.ops = [(n, max(a, lo), min(b, hi)) for n, a, b in self.ops if b > lo and a < hi]
        self.busy = _union([(a, b) for _n, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def op_seconds(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts,
        summed (not their union)."""
        return sum(b - a for n, a, b in self.ops if match(n)) / 1e9

    def busy_within(self, span: str) -> float:
        """Seconds the device was busy while the host was inside ``span``."""
        return sum(_covered(self.busy, a, b) for a, b in _union(self.spans.get(span, []))) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        by_name: dict[str, int] = collections.defaultdict(int)
        for n, a, b in self.ops:
            by_name[n] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], ns / 1e9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The device's idle time in the window, put down to the span the host
        was in (the one that covers most of each gap; 'other' where none)."""
        lo, hi = self.window
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        named = {n: _union(iv) for n, iv in self.spans.items() if n != WINDOW}
        by_name: dict[str, int] = collections.defaultdict(int)
        for a, b in gaps:
            best, best_cover = "other", 0
            for n, iv in named.items():
                cover = _covered(iv, a, b)
                if cover > best_cover:
                    best, best_cover = n, cover
            by_name[best] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """A ``torch.profiler`` over the block where ``enabled`` (CPU activity,
    and CUDA activity on the card); yields a list that holds the
    :class:`TraceSummary` once the block has ended."""
    out: list[TraceSummary] = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    out.append(TraceSummary(prof.profiler.kineto_results.events()))
