"""Per-stage throughput/timing counters (port of the JAX package's
``utils/timer.py``)."""
from __future__ import annotations

import contextlib
import time


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
            # items count only on success: a raised body processed nothing
            self.counts[name] = self.counts.get(name, 0) + items
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt

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
