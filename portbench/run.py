"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's traffic mix names its generator
(``drivers/<driver>.py``), which sets up, runs the measured window and holds
what the window produced against the plain reference. With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (the window under ``torch.profiler``), each read by
``metrics/<metric>.py``. The numbers that decide ``correct`` are printed with
their limits as the last lines of standard error and under ``checks``, the
result's last key. A run exits nonzero and prints no result where no card is
visible, where it needs more cards than it sees, or where JAX, Flax or the
JAX package was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

from portbench import guard, registry, roofline, trace


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    ``/proc/self/stat``; now where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = process_start()


class Run:
    """One run of one cell: what its driver sets up and measures, and what
    the metric readers read."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool, device,
                 t_start: float = T_START):
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.workload = cell["workload"]
        self.config, self.traffic, self.limits = cell["config"], cell["traffic"], cell["limits"]
        self.device = device
        self.t_start = t_start
        self.spans = trace.Spans(traced)
        self.setup_s: float | None = None
        self.window: dict = {}
        self.trace: trace.TraceSummary | None = None
        self.counters: dict[str, int] = {}
        self.checks: dict[str, dict] = {}
        self.faults: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.reference_module = registry.reference(self.config)

    def start_window(self) -> None:
        """Set-up ends: from the process's start to here. The spans restart,
        so they hold the window's alone."""
        self.setup_s = time.perf_counter() - self.t_start
        self.spans.totals.clear()

    @contextlib.contextmanager
    def traced_window(self):
        """The measured window: under the profiler in a traced run, and a
        span of its own that bounds the trace."""
        with trace.profiled(self.traced, self.device.type) as out:
            with self.spans.span(trace.WINDOW):
                yield
        if out:
            self.trace = out[0]

    def read_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free_device(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def add_check(self, name: str, value: float, limit: float | None = None,
                  at_least: bool = False) -> None:
        """One number that decides ``correct``: at most its limit (at least,
        with ``at_least``), the limit from the cell's limits file by default."""
        limit = self.limits[name] if limit is None else limit
        ok = value >= limit if at_least else value <= limit
        self.checks[name] = {"value": value, "limit": limit, "ok": bool(ok)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(c["ok"] for c in self.checks.values())


def execute(bench: dict, name: str, seed: int, seconds: float, traced: bool, device,
            root: str = registry.ROOT, t_start: float = T_START) -> dict:
    """Run cell ``name`` once on ``device``; returns the result line's object."""
    import torch

    cell = registry.cell(bench, name, root)
    run = Run(cell, seed, seconds, traced, torch.device(device), t_start)
    registry.driver(cell["traffic"]).drive(run)
    paths = bench["paths"][0]
    metrics = {}
    for m in registry.metrics_of(bench, name, traced):
        value = registry.metric_reader(m["name"], root, paths)(run)
        if value is None and not traced:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = run.device
    result = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(run.workload["chips"]),
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in run.checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    bench = registry.load_benchmark()
    chips = registry.cell(bench, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {torch.cuda.get_device_name(0)}, {roofline.power_limit()}; peaks "
          f"{roofline.PEAK_OPS} op/s, {roofline.HBM_BYTES_PER_S} B/s (H100 SXM data sheet)",
          flush=True)
    return finish(execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda"))


def finish(result: dict) -> int:
    """Print the result line, after the numbers that decide ``correct`` on
    standard error; or, where the process loaded JAX, Flax or the JAX
    package, say so and print no result (exit code 3)."""
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark may load none of "
              f"{list(guard.FORBIDDEN)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
