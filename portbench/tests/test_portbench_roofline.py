"""The least-work arithmetic at the configurations' published shapes, against
hand sums."""
from __future__ import annotations

import json
import os

import pytest

from portbench import registry, roofline


def _config(name: str) -> dict:
    with open(os.path.join(registry.PKG_DIR, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,int8_t,bf16_t,bound_ms", [
    # L-336: 4 crops × 24 layers × 2·577·(4·1024² + 2·1024·4096) int8 operations; attention
    # 4·577²·1024 a layer and the patch embedding 2·576·588·1024, in bf16
    ("clip_vit_l14_336", 1.394, 0.134, 0.84),
    # SO400M-384: 4 × 27 × 2·729·(4·1152² + 2·1152·4304); 4·729²·1152 a layer, 2·729·588·1152
    ("siglip_so400m_384", 2.397, 0.268, 1.48),
])
def test_an_image_at_the_published_shapes(name, int8_t, bf16_t, bound_ms):
    cfg = _config(name)
    work = roofline.vit_image_work(cfg, 4)
    assert work["int8_ops"] / 1e12 == pytest.approx(int8_t, abs=5e-4)
    assert work["bf16_flops"] / 1e12 == pytest.approx(bf16_t, abs=5e-4)
    assert roofline.vit_image_bound_s(cfg, 4) * 1e3 == pytest.approx(bound_ms, abs=5e-3)


def test_the_scan_at_n_524288():
    ops, nbytes = roofline.scan_work(524288, 768)
    assert ops == pytest.approx(2.111e14, rel=5e-4)
    assert nbytes == 524288 * 768
    assert roofline.scan_bound_s(524288, 768) == pytest.approx(0.1067, abs=1e-4)


@pytest.mark.parametrize("b,s,w,in_b,out_b,bound_ms", [
    (32, 577, 1024, 2, 2, 0.0452),  # K1 bf16 [32, 577, 3072]: bytes bound it
    (32, 729, 1152, 1, 1, 0.0792),  # K3 int8 [32, 729, 3456]: operations at the bf16 rate
])
def test_attention_launch_matches_the_kernel_table(b, s, w, in_b, out_b, bound_ms):
    assert roofline.attention_launch_s(b, s, w, in_b, out_b) * 1e3 == pytest.approx(bound_ms, abs=1e-4)
