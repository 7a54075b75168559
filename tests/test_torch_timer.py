"""The port's span recorder (``utils/timer.py``) and the spans the port puts
at its layer boundaries: the log's records (parent, thread, items), its bound
and what a reader learns where it dropped records, exact totals under many
threads, the profiler ranges' switch, dedup's nested stages on both wires and
on the ring, and the embed stage's report and spans."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from clip_assisted_data_labeling_tpu_torch.config import DedupConfig
from clip_assisted_data_labeling_tpu_torch.ops.similarity import find_duplicate_pairs
from clip_assisted_data_labeling_tpu_torch.parallel import mesh as tmesh
from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
    find_duplicate_pairs_sharded,
)
from clip_assisted_data_labeling_tpu_torch.pipeline import dedup as tdedup
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.utils import timer


def _named(records, name):
    return [s for s in records if s.name == name]


def test_a_span_records_its_parent_thread_and_items():
    t0 = time.perf_counter()
    stages = timer.StageTimer()
    with stages.time("outer", 5):
        with timer.span("inner", 2):
            pass
    with pytest.raises(ValueError):
        with stages.time("broken", 3):
            raise ValueError
    log = timer.recorded(t0)
    (inner,), (outer,), (broken,) = (_named(log, n) for n in ("inner", "outer", "broken"))
    assert inner.parent == "outer" and outer.parent is None and broken.parent is None
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert (inner.items, outer.items, broken.items) == (2, 5, 0)
    # a raised body counts its seconds and no items, as the totals always have
    assert stages.counts == {"outer": 5} and set(stages.totals) == {"outer", "broken"}
    assert stages.totals["outer"] == pytest.approx(outer.end - outer.start)
    assert "outer:" in stages.report() and "broken:" in stages.report()


def test_the_log_is_bounded_and_a_reader_learns_what_it_dropped():
    t0 = time.perf_counter()
    for _ in range(timer.LOG_SIZE + 10):
        with timer.span("filler"):
            pass
    t1 = time.perf_counter()
    with timer.span("after"):
        pass
    assert timer.recorded(t0) is None  # the oldest of the fill is gone
    assert timer.recorded() is None
    after = timer.recorded(t1)
    assert [s.name for s in after] == ["after"]
    assert len(timer._log) == timer.LOG_SIZE


def test_exact_totals_from_many_threads():
    n_threads, per_thread = 8, 1000
    stages = timer.StageTimer()
    t0 = time.perf_counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    # every worker alive at once, so no thread reuses another's ident
    started = threading.Barrier(n_threads)
    try:
        def work():
            started.wait(timeout=60)
            with timer.span("worker"):
                for _ in range(per_thread):
                    with stages.time("stage", 1):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    log = timer.recorded(t0)
    assert log is not None
    spans = _named(log, "stage")
    assert len(spans) == n_threads * per_thread
    assert stages.counts["stage"] == n_threads * per_thread
    assert stages.totals["stage"] == pytest.approx(sum(s.end - s.start for s in spans), rel=1e-9)
    assert all(s.parent == "worker" for s in spans)
    assert len({s.thread for s in spans}) == n_threads
    by_thread = {w.thread for w in _named(log, "worker")}
    assert {s.thread for s in spans} == by_thread


def _profiled_names(on: bool) -> set[str]:
    with timer.profiler_ranges(on), profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.span("outer"):
            with timer.layer("inner"):
                torch.ones(4).add_(1)
    return {e.name for e in prof.events()}


def test_profiler_ranges_only_where_switched_on():
    off = _profiled_names(False)
    assert not any(n.startswith("ctpu.") for n in off)
    assert "aten::add_" in off
    assert {"ctpu.outer", "ctpu.inner"} <= _profiled_names(True)
    # off, a layer range is one shared no-op: no profiler call at all
    assert timer.layer("a") is timer.layer("b")


def _planted(n=300, d=20, seed=5):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (n, d)).astype(np.float32)
    for i in range(0, 60, 3):  # 20 near copies
        emb[i + 150] = emb[i] + rng.normal(0, 0.01, d).astype(np.float32)
    return emb


def _oracle(emb, threshold):
    x = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    iu, ju = np.triu_indices(len(x), k=1)
    keep = (x @ x.T)[iu, ju] > threshold
    return set(zip(iu[keep].tolist(), ju[keep].tolist()))


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("path", ["one_device", "ring"])
def test_dedup_stages_nest_and_leave_the_pairs(path, wire):
    emb = _planted()
    if path == "ring":
        def run(t):
            return find_duplicate_pairs_sharded(
                emb, threshold=0.99, wire=wire, row_block=64, timer=t,
                mesh=tmesh.get_mesh(devices=[torch.device("cpu")] * 3))
    else:
        def run(t):
            return find_duplicate_pairs(emb, threshold=0.99, wire=wire, row_block=64,
                                        device="cpu", timer=t)
    stages = timer.StageTimer()
    got = run(stages)
    s = stages.totals
    assert set(s) >= {"prepare", "normalize", "quantize_rows", "upload", "extract", "topk",
                      "recheck"}
    assert s["normalize"] + s["quantize_rows"] + s["upload"] <= s["prepare"]
    assert s["topk"] + s["recheck"] <= s["extract"]
    assert stages.counts["normalize"] == stages.counts["upload"] == len(emb)
    assert stages.counts["topk"] == stages.counts["recheck"] == stages.counts["extract"]
    assert got.pairs() == run(None).pairs()
    assert set(zip(got.rows.tolist(), got.cols.tolist())) == _oracle(emb, 0.99)


def test_run_dedup_prints_its_stages(tmp_path, capsys):
    emb = np.repeat(_planted(d=16)[:, None, :], 4, axis=1)
    store = EmbeddingStore.create(str(tmp_path), "ViT-Test/tiny",
                                  ["centre_crop", "square_padded_crop", "subcrop1_0.15",
                                   "subcrop2_0.1"], 16, [f"{i:032x}" for i in range(len(emb))])
    store.write_rows(0, emb)
    store.flush()
    tdedup.run_dedup(str(tmp_path), DedupConfig(threshold=0.99, test=True), device="cpu")
    out = capsys.readouterr().out
    for stage in ("prepare", "normalize", "quantize_rows", "upload", "scan", "extract",
                  "topk", "recheck"):
        assert f"\n{stage}: " in out


def test_embed_reports_cpu_wait_and_sidecar_wait(tmp_path, capsys):
    rng = np.random.default_rng(0)
    root = tmp_path / "d"
    root.mkdir()
    for i, (h, w) in enumerate([(40, 40), (70, 30), (50, 90), (64, 64), (30, 80)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"img_{i}.png")
    t0 = time.perf_counter()
    port_embed_main(["--root_dir", str(root), "--models_to_use", "ViT-Test/tiny", "--device",
                     "cpu", "--compute_dtype", "int8_static", "--batch_size", "2",
                     "--num_workers", "2", "--canvas_size", "128"])
    report = capsys.readouterr().out.split("--- Feature encoding done! ---")[1]
    stages = {line.split(":")[0] for line in report.splitlines()[2:] if ": " in line}
    assert stages == {"skip_check", "loader_wait", "dispatch", "cpu_wait", "store_write",
                      "sidecar_wait"}
    log = timer.recorded(t0)
    assert log is not None
    assert sum(s.items for s in _named(log, "decode")) == 5
    assert sum(s.items for s in _named(log, "sidecar_write")) == 5
    assert sum(s.items for s in _named(log, "probe")) == 5
    assert len(_named(log, "quantize_weights")) == 1
    (calibrate,) = _named(log, "calibrate")
    assert calibrate.parent == "dispatch" and calibrate.items == 2 * 4  # 2 images × 4 crops
    # the writers' and decoders' spans come from their own threads
    main = threading.get_ident()
    assert {s.thread for s in _named(log, "sidecar_write")} - {main}
    assert {s.thread for s in _named(log, "decode")} - {main}
