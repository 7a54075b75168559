"""The benchmark's NaFlex and data-parallel cells at tiny sizes on the CPU:
a copy of ``BENCHMARK.json`` and ``portbench/`` with the port's tiny naflex
tower under the ``embed_native`` driver and the tiny ViT under ``embed_dp``
(four CPU "cards"), as the real cells run them. Each runs correct; the
NaFlex control (int8 block products) and planted faults in the native
column come out not correct; the NaFlex roofline arithmetic and the three
new metric readers."""
from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
from clip_assisted_data_labeling_tpu_torch.models.naflex import target_grid
from portbench import naflex_roofline, registry, roofline
from portbench import run as pbrun
from portbench.tests.conftest import _dump, make_tiny_root
from tests.test_torch_naflex_varlen import tiny_config

SEED = 2**31 + 23
NATIVE, DP = "tinynaf.embed-native", "tiny.embed-dp4"
# the tiny cells' limits: the tiny bf16 program reads ~1e-4 on embed_gap, the
# int8 control and the faults above 1e-3 (test_the_native_control_is_not_correct)
LIMITS = {NATIVE: {"embed_gap": 1e-3, "stats_gap": 1e-3, "misplaced": 0, "misplaced_apart": 1e-3,
                   "images_checked": 4},
          DP: {"embed_gap": 0.01, "stats_gap": 1e-3, "misplaced": 0, "misplaced_apart": 1e-3,
               "images_checked": 4}}


def add_cells(root: str, bench: dict) -> dict:
    """The tiny NaFlex and data-parallel cells, added as files and entries."""
    pb = os.path.join(root, "portbench")
    _dump(tiny_config(), pb, "configs", "tiny_naflex.json")
    bench["configs"].append({"name": "tiny_naflex", "source": "tiny test tower",
                             "file": "portbench/configs/tiny_naflex.json", "reduced": [],
                             "why": "CPU tests"})
    with open(os.path.join(pb, "traffic", "tiny_png.json")) as f:
        png = json.load(f)
    _dump(dict(png, driver="embed_native"), pb, "traffic", "tiny_png_native.json")
    _dump(dict(png, driver="embed_dp", batch_size=8, decode_workers=4), pb, "traffic",
          "tiny_png_dp.json")
    bench["workloads"] += [
        {"name": NATIVE, "config": "tiny_naflex", "traffic": "tiny_png_native", "chips": 1,
         "why": "CPU tests"},
        {"name": DP, "config": "tiny_vit", "traffic": "tiny_png_dp", "chips": 4,
         "why": "CPU tests"}]
    for name, lim in LIMITS.items():
        _dump(lim, pb, "limits", name + ".json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("so400m16_naflex.embed-native", NATIVE), ("l14_336.embed-dp4", DP)):
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    _dump(bench, root, "BENCHMARK.json")
    return bench


@pytest.fixture()
def bench_root(tmp_path):
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    return root, add_cells(root, make_tiny_root(root))


def _run(bench_root, name, traced=False):
    root, bench = bench_root
    return pbrun.execute(bench, name, SEED, 0.5, traced, "cpu", root=root)


def test_the_native_cell_runs_correct(bench_root):
    """Five columns checked, each native forward's real patch counts in the
    window (each image's aspect-preserving grid at the cap)."""
    root, bench = bench_root
    cell = registry.cell(bench, NATIVE, root)
    run = pbrun.Run(cell, SEED, 0.5, True, torch.device("cpu"))
    registry.driver(cell["traffic"]).drive(run)
    assert run.correct, run.checks
    mix, cfg = cell["traffic"], cell["config"]
    lengths = sorted(n for b in run.window["native_batches"] for n in b)
    want = sorted(int(np.prod(target_grid(h, w, cfg["patch_size"], cfg["max_patches"])))
                  for w, h in mix["sizes"] for _ in range(mix["per_size"]))
    assert lengths == want * run.window["passes"]
    assert run.checks["images_checked"]["value"] == len(mix["sizes"]) * mix["check_per_size"]
    assert registry.metric_reader("native_prep_ms", root)(run) > 0


def test_the_dp_cell_runs_correct(bench_root):
    result = _run(bench_root, DP)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4


def test_the_native_control_is_not_correct(bench_root):
    """The reference one step below bfloat16 (int8 block products, bf16
    activations) reads past the cell's limit, three times the program's
    reading or more."""
    root, bench = bench_root
    program = _run(bench_root, NATIVE)
    cell = registry.cell(bench, NATIVE, root)
    run = pbrun.Run(cell, SEED, 0.0, False, torch.device("cpu"))
    numbers = registry.driver(cell["traffic"]).control(run)
    assert numbers["embed_gap"] > cell["limits"]["embed_gap"], numbers
    assert numbers["embed_gap"] >= 3 * program["checks"]["embed_gap"]["value"]
    assert numbers["native_embed_gap"] > 0


def _fault(monkeypatch, kind: str):
    real_patches, real_crops = CLIPImageEncoder.encode_patches, CLIPImageEncoder.embed_crops
    last = {}

    def embed_crops(self, canvas, params):
        last["crops"] = real_crops(self, canvas, params)
        return last["crops"]

    def encode_patches(self, patches, masks, grids):
        if kind == "unmasked":  # every padded key left in the softmax
            return real_patches(self, patches, np.ones_like(masks), grids)
        out = real_patches(self, patches, masks, grids)
        if kind == "swapped":  # one image's row written under another's
            return out.roll(1, dims=0)
        return last["crops"][: len(out), 0]  # a crop's row in the native column

    monkeypatch.setattr(CLIPImageEncoder, "embed_crops", embed_crops)
    monkeypatch.setattr(CLIPImageEncoder, "encode_patches", encode_patches)


@pytest.mark.parametrize("kind", ["unmasked", "swapped", "crop"])
def test_a_broken_native_column_is_not_correct(bench_root, monkeypatch, kind):
    _fault(monkeypatch, kind)
    result = _run(bench_root, NATIVE)
    assert not result["correct"], result["checks"]


def test_naflex_work_arithmetic():
    """At the cell's configuration: an image of 4 crops and a 1,024-patch
    native row is ~1.86 ms at the bf16 peak; a crop launch's attention bound
    equals ``roofline.attention_launch_s``'s; a native launch counts only its
    rows' real lengths."""
    path = os.path.join(registry.ROOT, "portbench", "configs", "siglip2_so400m16_naflex.json")
    with open(path) as f:
        cfg = json.load(f)
    per_image = naflex_roofline.window_bound_s(cfg, 4, [1024])
    assert 1.8e-3 < per_image < 1.95e-3
    w = cfg["width"]
    assert naflex_roofline.attention_bound_s([256] * 256, w) == pytest.approx(
        roofline.attention_launch_s(256, 256, w, 2, 2))
    assert naflex_roofline.attention_bound_s([1014, 10], w) == pytest.approx(
        4.0 * (1014 ** 2 + 10 ** 2) * w / roofline.PEAK_OPS["bf16"])
    # the native row's position resize and the MAP head are counted
    assert naflex_roofline.native_flops(cfg, 1024) > naflex_roofline.tower_flops(cfg, 1024)


def _metric(name):
    return registry.metric_reader(name)


def test_the_new_metric_readers():
    cfg = {"width": 64, "mlp_dim": 256, "patch_size": 8, "layers": 2, "seq_len": 16,
           "position_grid": 4}
    trace = types.SimpleNamespace(busy_s=2.0, op_seconds=lambda match: 0.5 if match(
        "void exact_wgmma_kernel<80, true, 0, bf16, true>") else 0.0)
    window = {"images": 6, "crops_per_forward": 8, "native_batches": [[16, 9], [4, 16, 16, 1]],
              "varlen_launches": 4}
    run = types.SimpleNamespace(trace=trace, window=window, config=cfg,
                                traffic={"batch_size": 2},
                                counters={"attention.fused_attention_packed.launches": 6,
                                          "attention.flash_attention_packed.launches": 2})
    want = naflex_roofline.window_bound_s(cfg, 6 * 4, [16, 9, 4, 16, 16, 1]) / 2.0 * 100
    assert _metric("naflex_mfu")(run) == pytest.approx(want)
    bound = (4 * naflex_roofline.attention_bound_s([16] * 8, 64)
             + 2 * (naflex_roofline.attention_bound_s([16, 9], 64)
                    + naflex_roofline.attention_bound_s([4, 16, 16, 1], 64)))
    assert _metric("naflex_attn_roofline_pct")(run) == pytest.approx(100 * bound / 0.5)
    parent = types.SimpleNamespace(trace=trace, window={"images": 6, "crops_per_forward": 8})
    assert _metric("naflex_mfu")(parent) is None
    assert _metric("naflex_attn_roofline_pct")(parent) is None
    assert _metric("native_prep_ms")(types.SimpleNamespace(setup_s=None)) is None
