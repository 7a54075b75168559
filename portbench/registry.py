"""Find a cell's configuration, traffic mix, driver, limits and metric readers
by the names in ``BENCHMARK.json``. Nothing here knows a name: a cell, a mix or
a metric is added by adding its files and its entries."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` resolved: its entry, its configuration's file, its
    traffic mix's parameters and its limits."""
    work = _named(bench["workloads"], name, "workload")
    conf_entry = _named(bench["configs"], work["config"], "configuration")
    pkg = os.path.join(root, bench["paths"][0])
    return {
        "workload": work,
        "config": _json(os.path.join(root, conf_entry["file"])),
        "traffic": _json(os.path.join(pkg, "traffic", work["traffic"] + ".json")),
        "limits": _json(os.path.join(pkg, "limits", name + ".json")),
    }


def driver(traffic: dict):
    """The generator module that runs a traffic mix: ``drivers/<driver>.py``."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reference(config: dict):
    """A configuration's plain reference: ``reference/<reference>.py``."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def metrics_of(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones. A metric with a ``workloads``
    key is reported in those cells; a per-layer metric without it in every
    cell that reports the end-to-end metric it moves; an end-to-end metric
    without it in every cell."""
    ends = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return ends
    moved = {m["name"] for m in ends}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def metric_reader(name: str, root: str = ROOT, paths: str = "portbench"):
    """``metrics/<name>.py``'s ``read(run) -> float | None``, loaded by path
    (a metric's name may hold dots). A metric split by the end-to-end metric
    it moves (``<quantity>.<part>``) without a file of its own reads
    ``metrics/<quantity>.py``."""
    metrics = os.path.join(root, paths, "metrics")
    path = os.path.join(metrics, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(metrics, name.split(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
