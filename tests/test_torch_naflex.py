"""The port's SigLIP2 naflex path against the JAX package's: the grid
solver, the positional resize weights, the host preprocess (PIL's bilinear
where PIL is installed, the port's own fixed-point copy of it where it is
not — held against PIL pixel for pixel), the variable-aspect forward (the
port's block route with per-image key lengths, the JAX package's masked
blocks) at several aspects in one ragged batch (float32 and bfloat16), the square
path equal to the fixed path, and the encoder's ``encode_variable`` on
uint8 images against the JAX encoder's on the same weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import naflex as jnaflex
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import naflex as tnaflex
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params
from tests.test_torch_pe import _cos_err, _np_params

NAME = "SigLIP2-Naflex-Test/tiny"
SHAPES = [(4, 4), (2, 6), (3, 5), (1, 4), (6, 2)]


def test_target_grid_and_pos_weights_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(8, 3000, 2))
        patch = int(rng.choice([8, 14, 16]))
        maxp = int(rng.choice([16, 64, 256, 1024]))
        assert tnaflex.target_grid(h, w, patch, maxp) == jnaflex.target_grid(h, w, patch, maxp)
    for gh, gw in [(4, 4), (2, 6), (7, 3), (1, 16), (16, 16), (3, 20), (1, 1)]:
        np.testing.assert_array_equal(tnaflex.pos_resize_weights(gh, gw, 16),
                                      jnaflex.pos_resize_weights(gh, gw, 16))
    np.testing.assert_array_equal(tnaflex.build_pos_weights(SHAPES, 16, 4),
                                  jnaflex.build_pos_weights(SHAPES, 16, 4))


@pytest.mark.parametrize("src,dst", [
    ((37, 53), (64, 48)),  # up both ways
    ((400, 300), (96, 128)),  # down both ways: the triangle widened
    ((250, 250), (250, 112)),  # one axis unchanged: one pass only
    ((1000, 200), (240, 48)),  # a tall image, like the native aspect's
    ((7, 900), (16, 256)),
])
def test_pil_bilinear_copy_equals_pil(rng, src, dst):
    """The port's fixed-point bilinear (PIL's coefficients, 22-bit weights,
    the horizontal pass into uint8 first) gives PIL's pixels exactly."""
    img = rng.integers(0, 256, (*src, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    got = tnaflex.pil_bilinear_resize(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_pil", [True, False])
def test_preprocess_variable_matches_jax(rng, monkeypatch, with_pil):
    """One image at several aspects through both packages' host preprocess;
    without PIL the port's own resize gives the same patches."""
    if not with_pil:
        monkeypatch.setattr(tnaflex, "Image", None)
    cfg_j, cfg_t = jvit.resolve_config(NAME), tvit.resolve_config(NAME)
    for h, w in [(60, 200), (100, 40), (33, 33), (500, 90)]:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got, want = (tnaflex.preprocess_variable(img, cfg_t, 16),
                     jnaflex.preprocess_variable(img, cfg_j, 16))
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
def test_naflex_encode_matches_jax(rng, tdtype, jdtype, limit):
    """Five aspects in one ragged batch (the masked attention and the masked
    MAP head), both packages on the same params."""
    cfg_j, cfg_t = jvit.resolve_config(NAME), tvit.resolve_config(NAME)
    params = _np_params(cfg_j, rng, seed=31)
    n_max, p = cfg_t.seq_len, cfg_t.patch_size
    patches = np.zeros((len(SHAPES), n_max, p * p * 3), np.float32)
    masks = np.zeros((len(SHAPES), n_max), np.float32)
    for i, (gh, gw) in enumerate(SHAPES):
        patches[i, : gh * gw] = rng.normal(0, 1, (gh * gw, p * p * 3))
        masks[i, : gh * gw] = 1.0
    pos_w = tnaflex.build_pos_weights(SHAPES, n_max, cfg_t.grid)
    ref = np.asarray(jnaflex.naflex_encode(params, jnp.asarray(patches), jnp.asarray(pos_w),
                                           jnp.asarray(masks), cfg_j, compute_dtype=jdtype))
    got = tnaflex.naflex_encode(tweights.module_from_params(params, cfg_t),
                                torch.from_numpy(patches), torch.from_numpy(pos_w),
                                torch.from_numpy(masks), tdtype).numpy()
    assert got.shape == (len(SHAPES), cfg_t.width) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


def test_square_naflex_equals_fixed_path(rng):
    """A full-grid naflex forward (no padding, identity interpolation) equals
    the fixed-resolution vit_encode_image on the same pixels: what lets the
    square crops take the kernels' path."""
    cfg = tvit.resolve_config(NAME)
    params = _np_params(jvit.resolve_config(NAME), rng, seed=32)
    model = tweights.module_from_params(params, cfg)
    x = rng.normal(0, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    a = tvit.vit_encode_image(model, torch.from_numpy(x), torch.float32).numpy()
    p, g = cfg.patch_size, cfg.grid
    patches = x.reshape(3, g, p, g, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(3, g * g, -1)
    pos_w = tnaflex.build_pos_weights([(g, g)] * 3, cfg.seq_len, g)
    np.testing.assert_allclose(pos_w[0], np.eye(cfg.seq_len, dtype=np.float32), atol=1e-6)
    b = tnaflex.naflex_encode(model, torch.from_numpy(patches), torch.from_numpy(pos_w),
                              torch.ones((3, cfg.seq_len)), torch.float32).numpy()
    np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_encode_variable_matches_jax_encoder(rng, dtype, limit):
    """uint8 images of several aspects through both encoders on one set of
    params; int8 encoders and fixed-resolution towers refuse, as in the JAX
    package."""
    params = _np_params(jvit.resolve_config(NAME), rng, seed=33)
    imgs = [rng.integers(0, 255, shape, dtype=np.uint8)
            for shape in [(60, 200, 3), (100, 40, 3), (48, 48, 3)]]
    ref = np.asarray(jenc.CLIPImageEncoder(NAME, params=params, compute_dtype=jnp.dtype(dtype))
                     .encode_variable(imgs))
    enc = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype=dtype, device="cpu")
    got = enc.encode_variable(imgs).numpy()
    assert got.shape == (3, 64)
    assert _cos_err(got, ref) < limit
    with pytest.raises(ValueError, match="not a naflex"):
        tenc.CLIPImageEncoder("SigLIP-Test/tiny", compute_dtype="float32",
                              device="cpu").encode_variable(imgs)
    with pytest.raises(ValueError, match="int8"):
        tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="int8",
                              device="cpu").encode_variable(imgs)


def test_naflex_square_crops_take_the_fixed_kernel_path(rng):
    """The naflex tower's square crops through embed_crops: the fixed path,
    K1's plain version here (the card runs K1 at S = 256 for the SO400M
    naflex tower), within 1e-5 of the JAX encoder's embed_crops in float32."""
    params = _np_params(jvit.resolve_config(NAME), rng, seed=34)
    canvas = rng.integers(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    crops = np.stack([make_crop_params(96, 70, 96, 32), make_crop_params(50, 96, 96, 32)])
    ref = np.asarray(jenc.CLIPImageEncoder(NAME, params=params, compute_dtype=jnp.float32)
                     .embed_crops(jnp.asarray(canvas), jnp.asarray(crops.astype(np.float32))))
    got = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32",
                                device="cpu").embed_crops(canvas, crops).numpy()
    assert _cos_err(got.reshape(-1, 64), ref.reshape(-1, 64)) < 1e-5
    assert tvit.resolve_config("ViT-SO400M-16-SigLIP2-naflex").seq_len == 256
