"""The harness is driven by data (a configuration, a traffic mix and a metric
added as files are found by name, no file edited), and its JAX guard."""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import guard, registry
from portbench import run as pbrun


def _added_cell(root: str, bench: dict) -> dict:
    """A new configuration, mix, metric and cell, as new files and entries."""
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny_vit.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(pb, "configs", "tiny_vit_b.json"), "w") as f:
        json.dump(dict(cfg, name="tiny_vit_b", model_name="ViT-Test-HF/tiny", layers=3), f)
    with open(os.path.join(pb, "traffic", "tiny_png.json")) as f:
        mix = json.load(f)
    with open(os.path.join(pb, "traffic", "tiny_png_b.json"), "w") as f:
        json.dump(dict(mix, sizes=[[48, 48], [64, 40]], per_size=2, batch_size=2), f)
    with open(os.path.join(pb, "limits", "tiny_b.embed.json"), "w") as f:
        json.dump({"embed_gap": 0.01, "stats_gap": 1e-3, "misplaced": 0, "misplaced_apart": 1e-3,
                   "images_checked": 2}, f)
    with open(os.path.join(pb, "metrics", "batches_in_window.py"), "w") as f:
        f.write('"""batches_in_window: batches the window wrote."""\n\n\n'
                'def read(run):\n    return run.window.get("batches")\n')
    bench["configs"].append({"name": "tiny_vit_b", "source": "tiny test tower",
                             "file": "portbench/configs/tiny_vit_b.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny_b.embed", "config": "tiny_vit_b",
                               "traffic": "tiny_png_b", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] == "embed_imgs_per_s":
            m["workloads"].append("tiny_b.embed")
    bench["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "embed_imgs_per_s", "workloads": ["tiny_b.embed"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def test_new_files_are_found_by_name(tiny_root):
    root, bench = tiny_root
    bench = _added_cell(root, bench)
    cell = registry.cell(bench, "tiny_b.embed", root)
    assert cell["config"]["model_name"] == "ViT-Test-HF/tiny"
    assert cell["traffic"]["per_size"] == 2
    # the per-layer metrics without a cell list follow the end-to-end metric they move
    assert [m["name"] for m in registry.metrics_of(bench, "tiny_b.embed", True)] == \
        ["loader_wait_ms", "write_ms", "idle_pct.embed", "batches_in_window"]
    assert [m["name"] for m in registry.metrics_of(bench, "tiny_b.embed", False)] == \
        ["embed_imgs_per_s", "setup_s"]
    traced = pbrun.execute(bench, "tiny_b.embed", 2**32 + 5, 5.0, True, "cpu", root=root)
    assert traced["correct"] and traced["metrics"]["batches_in_window"]["value"] >= 1
    assert {"loader_wait_ms", "write_ms", "idle_pct.embed"} <= set(traced["metrics"])
    plain = pbrun.execute(bench, "tiny_b.embed", 2**32 + 5, 5.0, False, "cpu", root=root)
    assert plain["correct"] and set(plain["metrics"]) == {"embed_imgs_per_s", "setup_s"}
    # every file the benchmark had is as it was: the cell came by additions alone
    src = os.path.join(registry.ROOT, "portbench")
    for sub in ("", "configs", "traffic", "metrics", "limits", "drivers", "reference"):
        listed = [f for f in os.listdir(os.path.join(src, sub))
                  if os.path.isfile(os.path.join(src, sub, f)) and not f.endswith(".pyc")]
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(src, sub),
                                               os.path.join(root, "portbench", sub), listed,
                                               shallow=False)
        assert not mismatch and not errors


def test_every_cell_reports_what_the_contract_asks(tiny_root):
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        ends = {m["name"] for m in registry.metrics_of(bench, w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert registry.metrics_of(bench, w["name"], True)
        cell = registry.cell(bench, w["name"])
        assert registry.driver(cell["traffic"]).drive
        for m in registry.metrics_of(bench, w["name"], True) + registry.metrics_of(bench, w["name"], False):
            assert callable(registry.metric_reader(m["name"]))


def test_a_split_metric_reads_its_quantity_file(tmp_path):
    """``idle_pct.embed`` and ``idle_pct.dedup`` both read ``metrics/idle_pct.py``;
    a file of the split's own name takes precedence."""
    metrics = tmp_path / "portbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "q.py").write_text("def read(run):\n    return 1.0\n")
    (metrics / "q.b.py").write_text("def read(run):\n    return 2.0\n")
    assert registry.metric_reader("q.a", str(tmp_path))(None) == 1.0
    assert registry.metric_reader("q.b", str(tmp_path))(None) == 2.0
    run = types.SimpleNamespace(trace=types.SimpleNamespace(busy_s=3.0, window_s=4.0))
    for name in ("idle_pct.embed", "idle_pct.dedup"):
        assert registry.metric_reader(name)(run) == pytest.approx(25.0)


@pytest.mark.parametrize("names,found", [
    (["numpy", "jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["clip_assisted_data_labeling_tpu.ops.attention"], ["clip_assisted_data_labeling_tpu"]),
    (["clip_assisted_data_labeling_tpu_torch", "clip_assisted_data_labeling_tpu_torch.ops",
      "torch", "jaxtyping", "jax_like"], []),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


RESULT = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
          "checks": {"gap": {"value": 0.0, "limit": 1.0}}}


def test_guard_fails_a_run_that_loaded_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert pbrun.finish(dict(RESULT)) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_guard_fails_a_run_that_loaded_the_jax_package(monkeypatch, capsys):
    name = "clip_assisted_data_labeling_tpu"
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert pbrun.finish(dict(RESULT)) == 3
    assert capsys.readouterr().out == ""


def test_guard_passes_a_run_of_the_port(capsys):
    import clip_assisted_data_labeling_tpu_torch  # noqa: F401

    if guard.forbidden_modules():
        pytest.skip("this test process holds JAX already (another suite imported it)")
    assert pbrun.finish(dict(RESULT)) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["checks"]["gap"]["limit"] == 1.0
    assert err.strip().splitlines()[-1] == "gap 0.0 limit 1.0"


def test_the_harness_loads_no_jax():
    code = ("import portbench.run, portbench.control, portbench.drivers.embed, "
            "portbench.drivers.dedup, portbench.registry as r\n"
            "import clip_assisted_data_labeling_tpu_torch.pipeline.embed\n"
            "b = r.load_benchmark()\n"
            "[r.metric_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "from portbench import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_directory_with_the_benchmark_alone_fails(tmp_path):
    import shutil

    shutil.copytree(os.path.join(registry.ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = ("from portbench import run\nimport torch\n"
            "print(run.execute(run.registry.load_benchmark(), 'l14_336.embed', 1, 1.0, False, 'cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "clip_assisted_data_labeling_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root, bench = tiny_root
    for name in ("tiny.embed", "tiny.dedup"):
        res = pbrun.execute(bench, name, 2**31 + 3, 1.0, True, "cuda", root=root)
        assert res["correct"] and res["device"]["busy_s"] > 0
