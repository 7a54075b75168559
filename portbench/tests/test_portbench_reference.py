"""The plain reference against the port on the CPU, at tiny tower sizes and
small N: the crops (with the loader's pre-downscale), the stats, both towers'
float32 forwards and the all-pairs scan."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import registry, synth, weights
from portbench.reference import crops as ref_crops
from portbench.reference import dedup as ref_dedup
from portbench.reference import stats as ref_stats
from portbench.reference import vit as ref_vit

from clip_assisted_data_labeling_tpu_torch.data.loader import fit_to_canvas
from clip_assisted_data_labeling_tpu_torch.models.vit import init_vit_params, resolve_config, vit_encode_image
from clip_assisted_data_labeling_tpu_torch.models import clip_weights
from clip_assisted_data_labeling_tpu_torch.ops.crops import fused_crop_resize_normalize, make_crop_params
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS, image_stats_batch, make_stat_params
from clip_assisted_data_labeling_tpu_torch.ops.similarity import find_duplicate_pairs

SIZES = [(40, 40), (64, 40), (30, 64), (52, 17)]


def _tiny_configs(tiny_root):
    root, _bench = tiny_root
    out = []
    for name in ("tiny_vit", "tiny_siglip"):
        with open(os.path.join(root, "portbench", "configs", name + ".json")) as f:
            out.append(json.load(f))
    return out


def _image(seed: int, w: int, h: int) -> torch.Tensor:
    return synth.image_group(seed, 0, 1, w, h, 4, "cpu")[0]


@pytest.mark.parametrize("w,h", SIZES)
def test_crops_match_the_port(w, h):
    img = _image(3, w, h)
    canvas = np.zeros((1, 64, 64, 3), np.uint8)
    oy, ox = (64 - h) // 2, (64 - w) // 2
    canvas[0, oy:oy + h, ox:ox + w] = img.numpy()
    params = make_crop_params(w, h, 64, 32)[None]
    port = fused_crop_resize_normalize(torch.from_numpy(canvas), torch.from_numpy(params), 32)[0]
    ref = ref_crops.image_crops(img, 32, (0.48145466, 0.4578275, 0.40821073),
                                (0.26862954, 0.26130258, 0.27577711))
    step = 1.0 / (255.0 * 0.2613)  # one uint8 step in normalized units
    diff = (port - ref).abs()
    assert diff.max() <= step * 1.01
    assert (diff > 1e-5).float().mean() < 0.01


@pytest.mark.parametrize("w,h", [(96, 50), (50, 130), (200, 200), (1536, 1536), (832, 1216)])
def test_shrink_matches_the_loader(w, h):
    img = _image(5, w, h)
    ours = ref_crops.shrink_to_canvas(img, 64 if max(w, h) < 1000 else 1024).numpy().astype(int)
    port, pw, ph = fit_to_canvas(img.numpy(), 64 if max(w, h) < 1000 else 1024)
    assert ours.shape == port.shape == (ph, pw, 3)
    assert np.abs(ours - port.astype(int)).max() <= 1


@pytest.mark.parametrize("w,h", SIZES + [(900, 700), (256, 1024)])
def test_stats_match_the_port(w, h):
    img = _image(7, w, h)
    ours = ref_stats.image_stats(img).numpy()
    c = max(w, h) + max(w, h) % 2
    canvas = np.zeros((1, c, c, 3), np.uint8)
    oy, ox = (c - h) // 2, (c - w) // 2
    canvas[0, oy:oy + h, ox:ox + w] = img.numpy()
    port = image_stats_batch(torch.from_numpy(canvas),
                             torch.from_numpy(make_stat_params(w, h, c)[None]))[0].numpy()
    assert len(ours) == len(IMG_STAT_KEYS)
    np.testing.assert_allclose(ours, port, atol=2e-5)


def test_stats_match_cv2():
    cv2 = pytest.importorskip("cv2")
    del cv2
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import image_stats_reference

    for w, h in [(40, 40), (300, 200), (900, 700), (130, 1200)]:
        img = _image(11, w, h)
        want = image_stats_reference(img.numpy())
        np.testing.assert_allclose(ref_stats.image_stats(img).numpy(),
                                   [want[k] for k in IMG_STAT_KEYS], atol=5e-4)


def test_weights_layout_is_the_ports(tiny_root):
    for cfg in _tiny_configs(tiny_root):
        port = init_vit_params(resolve_config(cfg["model_name"]), torch.Generator().manual_seed(0))
        ours = weights.vit_params(cfg, 1, "cpu")
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: tuple(v.shape) for k, v in port.items()}


def test_vit_matches_the_ports_float32(tiny_root):
    for cfg in _tiny_configs(tiny_root):
        params = weights.vit_params(cfg, 2**40 + 9, "cpu")
        model = clip_weights.module_from_params(
            clip_weights.flatten_params({k: v.clone() for k, v in params.items()}),
            resolve_config(cfg["model_name"]), torch.device("cpu"))
        crops = torch.randn((6, cfg["image_size"], cfg["image_size"], 3),
                            generator=torch.Generator().manual_seed(4))
        port = vit_encode_image(model, crops, torch.float32)
        ours = ref_vit.encode(params, cfg, crops)
        assert (1.0 - (port * ours).sum(-1)).abs().max() < 1e-6
        control = ref_vit.encode(params, cfg, crops, control=True)
        assert (1.0 - (control * ours).sum(-1)).max() > 1e-3


def test_dedup_matches_the_port(tiny_root):
    root, bench = tiny_root
    mix = registry.cell(bench, "tiny.dedup", root)["traffic"]
    rows = synth.dedup_rows(2**33 + 1, mix["rows"], 48, mix, "cpu")
    res = find_duplicate_pairs(rows.numpy(), threshold=mix["threshold"], row_block=mix["row_block"],
                               max_per_row=mix["max_pairs_per_row"], device="cpu")
    i, j, c = ref_dedup.pairs_above(rows, mix["threshold"], mix["row_block"])
    assert len(i) >= mix["pairs"] + mix["groups"] * mix["group_size"] * (mix["group_size"] - 1) // 2
    order = np.lexsort((res.cols, res.rows))
    np.testing.assert_array_equal(res.rows[order], i)
    np.testing.assert_array_equal(res.cols[order], j)
    assert np.abs(res.metrics[order] - c).max() < 1e-6
