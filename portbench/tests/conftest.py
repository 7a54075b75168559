"""A benchmark root with tiny cells, for the CPU tests: a copy of
``BENCHMARK.json`` and ``portbench/`` in a temporary directory, with tiny
configurations (the port's test towers), mixes and limits added as files and
entries, as a later change would add them."""
from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench import registry

TINY_CELLS = ("tiny.embed", "tinysig.embed", "tiny.dedup")


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)


def make_tiny_root(root: str) -> dict:
    src = registry.ROOT
    shutil.copytree(os.path.join(src, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = registry.load_benchmark(src)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "clip_vit_l14_336.json")) as f:
        clip = json.load(f)
    with open(os.path.join(pb, "configs", "siglip_so400m_384.json")) as f:
        sig = json.load(f)
    configs = [
        dict(clip, name="tiny_vit", model_name="ViT-Test/tiny", width=64, layers=2, heads=4,
             head_dim=16, mlp_dim=256, patch_size=8, image_size=32, seq_len=17, embed_dim=16),
        dict(sig, name="tiny_siglip", model_name="SigLIP-Test-Ragged/tiny", width=64, layers=2,
             heads=4, head_dim=16, mlp_dim=224, patch_size=8, image_size=36, seq_len=16,
             embed_dim=64, pool_heads=4),
    ]
    for c in configs:
        _dump(c, pb, "configs", c["name"] + ".json")
        bench["configs"].append({"name": c["name"], "source": "tiny test tower",
                                 "file": f"portbench/configs/{c['name']}.json", "reduced": [],
                                 "why": "CPU tests"})
    with open(os.path.join(pb, "traffic", "png_pool.json")) as f:
        png = json.load(f)
    _dump(dict(png, sizes=[[40, 40], [80, 40], [48, 96]], per_size=4, batch_size=4,
               canvas_size=64, decode_workers=2, check_per_size=4, check_batch=8),
          pb, "traffic", "tiny_png.json")
    with open(os.path.join(pb, "traffic", "dedup_pass.json")) as f:
        dd = json.load(f)
    _dump(dict(dd, rows=4096, row_block=1024, warm_rows=2048, centres=64, pairs=16, groups=2,
               group_size=8, variants=256), pb, "traffic", "tiny_dedup.json")
    for name, conf, traffic in (("tiny.embed", "tiny_vit", "tiny_png"),
                                ("tinysig.embed", "tiny_siglip", "tiny_png"),
                                ("tiny.dedup", "tiny_vit", "tiny_dedup")):
        bench["workloads"].append({"name": name, "config": conf, "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
    embed_limits = {"embed_gap": 0.01, "stats_gap": 1e-3, "misplaced": 0, "misplaced_apart": 1e-3,
                    "images_checked": 4}
    _dump(embed_limits, pb, "limits", "tiny.embed.json")
    _dump(embed_limits, pb, "limits", "tinysig.embed.json")
    _dump({"missing": 0, "extra": 0, "metric_gap": 1e-5, "reference_pairs": 16 + 2 * 28},
          pb, "limits", "tiny.dedup.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            embed = any(w.endswith(".embed") for w in m["workloads"])
            m["workloads"] += ["tiny.embed", "tinysig.embed"] if embed else ["tiny.dedup"]
    _dump(bench, root, "BENCHMARK.json")
    return bench


@pytest.fixture()
def tiny_root(tmp_path):
    """(root, bench) of a benchmark copy with the tiny cells."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    return root, make_tiny_root(root)
