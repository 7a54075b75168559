"""The port's preprocess against the JAX package's: crop geometry, parity-mode
crops and the 22 image stats."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.config import CLIP_MEAN, CLIP_STD
from clip_assisted_data_labeling_tpu.ops import crops as jcrops
from clip_assisted_data_labeling_tpu.ops import image_stats as jstats
from clip_assisted_data_labeling_tpu_torch.ops import crops as tcrops
from clip_assisted_data_labeling_tpu_torch.ops import image_stats as tstats
from tests.test_crops import make_test_image, put_on_canvas
from tests.test_image_stats import DEFAULT_TOL, TOLERANCES

SIZES = [(100, 80), (256, 96), (64, 200), (37, 190), (500, 500)]


@pytest.mark.parametrize("w,h", SIZES + [(1, 1), (3, 700)])
@pytest.mark.parametrize("canvas,out", [(700, 32), (1024, 336)])
def test_crop_params_equal(w, h, canvas, out):
    np.testing.assert_array_equal(
        tcrops.make_crop_params(w, h, canvas, out), jcrops.make_crop_params(w, h, canvas, out))
    assert tcrops.crop_boxes(w, h) == jcrops.crop_boxes(w, h)


def _to_pixels(x: np.ndarray) -> np.ndarray:
    """Normalized crops back to the uint8 grid they were resampled on."""
    return np.round(x * (np.asarray(CLIP_STD) * 255.0) + np.asarray(CLIP_MEAN) * 255.0)


def test_parity_crops_match_jax(rng):
    canvas_size, R = 256, 56
    imgs = [make_test_image(rng, w, h) for w, h in SIZES[:4]]
    canvases = np.stack([put_on_canvas(im, canvas_size) for im in imgs])
    params = np.stack([jcrops.make_crop_params(im.shape[1], im.shape[0], canvas_size, R)
                       for im in imgs])
    ref = np.asarray(jcrops.fused_crop_resize_normalize(
        jnp.asarray(canvases), jnp.asarray(params), out_size=R, parity=True))
    got = tcrops.fused_crop_resize_normalize(
        torch.from_numpy(canvases), torch.from_numpy(params), out_size=R, parity=True)
    assert got.shape == ref.shape == (4, 4, R, R, 3) and got.dtype == torch.float32
    diff = np.abs(_to_pixels(got.numpy()) - _to_pixels(ref))
    # the two resample passes sum in another order: a pixel sitting on a
    # floor(x + 0.5) boundary may land one uint8 step away, rarely
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_fast_crops_close_to_parity(rng):
    img = make_test_image(rng, 120, 90)
    canvas = torch.from_numpy(put_on_canvas(img, 128)[None])
    params = torch.from_numpy(tcrops.make_crop_params(120, 90, 128, 32)[None])
    exact = tcrops.fused_crop_resize_normalize(canvas, params, out_size=32, parity=True)
    fast = tcrops.fused_crop_resize_normalize(canvas, params, out_size=32, parity=False,
                                              dtype=torch.bfloat16)
    assert fast.dtype == torch.bfloat16
    assert (exact - fast.float()).abs().mean().item() < 0.05


@pytest.mark.parametrize("w,h,canvas_size", [
    (100, 80, 256), (256, 96, 512), (64, 200, 256), (900, 300, 1024), (300, 900, 1024),
])
def test_image_stats_match_jax(rng, w, h, canvas_size):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)  # white noise: the hard case
    canvas = put_on_canvas(img, canvas_size)[None]
    params = tstats.make_stat_params(w, h, canvas_size)[None]
    np.testing.assert_array_equal(params, jstats.make_stat_params(w, h, canvas_size)[None])
    ref = np.asarray(jstats.image_stats_batch(jnp.asarray(canvas), jnp.asarray(params)))[0]
    got = tstats.image_stats_batch(torch.from_numpy(canvas), torch.from_numpy(params))
    assert got.shape == (1, 22) and got.dtype == torch.float32
    assert tstats.IMG_STAT_KEYS == jstats.IMG_STAT_KEYS
    for key, g, r in zip(tstats.IMG_STAT_KEYS, got[0].numpy(), ref):
        tol = TOLERANCES.get(key, DEFAULT_TOL)
        assert abs(g - r) <= tol, f"{key}: port {g:.5f} vs JAX {r:.5f} (tol {tol})"


def test_image_stats_batched_rows_independent(rng):
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for w, h in ((90, 60), (40, 120))]
    canvas = torch.from_numpy(np.stack([put_on_canvas(im, 128) for im in imgs]))
    params = torch.from_numpy(np.stack([tstats.make_stat_params(im.shape[1], im.shape[0], 128)
                                        for im in imgs]))
    both = tstats.image_stats_batch(canvas, params)
    for i in range(2):
        one = tstats.image_stats_batch(canvas[i:i + 1], params[i:i + 1])
        torch.testing.assert_close(both[i:i + 1], one, atol=1e-5, rtol=0)
