"""The per-layer metrics that read the port's own spans: a tiny traced run of
each cell kind reports them, the program's profiler ranges stay out of the
harness's trace, and a reader of the port's span log reads None where the log
dropped the records it needs."""
from __future__ import annotations

import time
import types

import pytest

from portbench import registry
from portbench import run as pbrun

SEED = 2**32 + 11

NEW = {
    "tiny.embed": ["decode_ms", "sidecar_write_ms", "setup_quantize_s", "setup_calibrate_s"],
    "tiny.dedup": ["dedup_normalize_s", "dedup_quantize_s", "dedup_upload_s", "dedup_topk_s",
                   "dedup_recheck_s"],
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_run_reports_the_ports_spans(tiny_root, name):
    root, bench = tiny_root
    res = pbrun.execute(bench, name, SEED, 2.0, True, "cpu", root=root)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(got[m] > 0 for m in NEW[name]), got
    if name == "tiny.dedup":
        assert (got["dedup_normalize_s"] + got["dedup_quantize_s"] + got["dedup_upload_s"]
                <= got["dedup_prepare_s"])
    # the harness never turns the program's profiler ranges on
    ops = [n for n, _s in res["breakdown"]["device_ops"] + res["breakdown"]["idle_gaps"]]
    assert not any(n.startswith("ctpu.") for n in ops)
    plain = pbrun.execute(bench, name, SEED, 2.0, False, "cpu", root=root)
    assert not set(NEW[name]) & set(plain["metrics"])


def test_a_log_that_dropped_the_window_reads_none(monkeypatch):
    from clip_assisted_data_labeling_tpu_torch.utils import timer

    read = {n: registry.metric_reader(n) for n in ("decode_ms", "setup_quantize_s")}
    t_start = time.perf_counter()
    with timer.span("quantize_weights"):
        time.sleep(0.002)
    window = time.perf_counter()
    run = types.SimpleNamespace(t_start=t_start, setup_s=window - t_start)
    assert read["setup_quantize_s"](run) >= 0.002
    assert read["decode_ms"](run) is None  # no decode span in the window yet
    with timer.span("decode", 1):
        time.sleep(0.002)
    assert read["decode_ms"](run) >= 2.0
    for _ in range(timer.LOG_SIZE):
        with timer.span("filler"):
            pass
    assert read["decode_ms"](run) is None
    assert read["setup_quantize_s"](run) is None
    # a port that keeps no span log (the parent of the change that added it)
    monkeypatch.delattr(timer, "recorded")
    later = types.SimpleNamespace(t_start=window, setup_s=time.perf_counter() - window)
    assert read["decode_ms"](later) is None
