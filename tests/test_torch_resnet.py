"""The port's modified-ResNet towers against the JAX package's: the
open_clip/OpenAI converter (BatchNorm folded) leaf for leaf on the JAX
tests' mirror, the forward in float32 and bfloat16 on weights carried across,
int8_static through both encoders from one ``.npz`` and one ``.calib.npz``
under every value of the ResNet knobs (``CTPU_RN_INT8``,
``CTPU_RN_INT8_CONV``, ``CTPU_RN_INT8_MIN_MID``), the calibration forward,
each package reading the other's calibration file, the calibration checks,
the downgrade log lines, and one full RN50 image in float32. Inputs are
numpy from a seed."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import resnet as jrn
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import knobs as jknobs
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import resnet as trn
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops import knobs as tknobs
from tests.test_rn_parity import make_mirror

NAME = "RN-Test/openai"


def _cos_err(a, b):
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


@pytest.fixture()
def knob_env(monkeypatch):
    """Sets (a value) or clears (None) CTPU_* variables for both packages'
    knobs, dropping JAX's traces, which keep the values they were made with;
    restores and re-reads everything afterwards."""
    def set_env(**env):
        for name, value in env.items():
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        jknobs.reload()
        tknobs.reload()
        jax.clear_caches()

    yield set_env
    monkeypatch.undo()
    jknobs.reload()
    tknobs.reload()
    jax.clear_caches()


def _np_params(cfg, rng, seed=0):
    """JAX random init with the folded affines and biases perturbed, as
    numpy."""
    p = jax.tree.map(np.asarray, jax.jit(lambda k: jrn.init_rn_params(cfg, k))(
        jax.random.key(seed)))
    for k, v in p.items():
        if k.endswith(("_bias", "_scale")):
            p[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_rn_converter_matches_jax(rng, prefix):
    """open_clip's 'visual.*' and bare layouts with randomized BatchNorm
    stats: the same leaves bit for bit as the JAX converter, and the port's
    float32 forward within 1e-5 of the mirror's torch forward."""
    cfg = trn.RN_TEST_TINY
    mirror = make_mirror(cfg, seed=3)
    sd = {prefix + k: v for k, v in mirror.state_dict().items()}
    want = jax.tree.map(np.asarray, jweights.convert_torch_state_dict(sd, jrn.RN_TEST_TINY))
    got = tweights.convert_torch_state_dict(sd, cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = mirror(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    out = trn.rn_encode_image(tweights.module_from_params(got, cfg), torch.from_numpy(x),
                              torch.float32).numpy()
    assert _cos_err(out, ref) < 1e-5


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
def test_rn_encode_matches_jax(rng, tdtype, jdtype, limit):
    """RN-Test on weights carried across, against the JAX forward (jitted,
    and op by op: the port computes the JAX code as written, so in bf16 it
    stays within 1e-4 of the op-by-op run, seen ~2e-6)."""
    params = _np_params(jrn.RN_TEST_TINY, rng, seed=1)
    x = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jrn.rn_encode_image(params, jnp.asarray(x), jrn.RN_TEST_TINY,
                                         compute_dtype=jdtype))
    with jax.disable_jit():
        eager = np.asarray(jrn.rn_encode_image(params, jnp.asarray(x), jrn.RN_TEST_TINY,
                                               compute_dtype=jdtype))
    model = tweights.module_from_params(params, trn.RN_TEST_TINY)
    got = trn.rn_encode_image(model, torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, 16) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit
    assert _cos_err(got, eager) < 1e-4


def test_rn_avgpool_equals_jax_bit_for_bit(rng):
    """The 2x2 pool in bf16: the window summed in XLA's order, then × 1/4."""
    x = rng.normal(0, 3, (2, 8, 8, 16)).astype(np.float32)
    ref = np.asarray(jrn._avgpool(jnp.asarray(x, jnp.bfloat16), 2).astype(jnp.float32))
    got = trn._avgpool(torch.from_numpy(x).to(torch.bfloat16), 2).float().numpy()
    np.testing.assert_array_equal(got, ref)


def _write_npz(tmp_path, rng):
    path = str(tmp_path / "RN-Test-openai.npz")
    jweights.save_params_npz(path, _np_params(jrn.RN_TEST_TINY, rng, seed=2))
    return path


# (CTPU_RN_INT8, CTPU_RN_INT8_CONV, CTPU_RN_INT8_MIN_MID); None: unset
RN_KNOBS = [("1", None, None), ("1", "1", None), ("1", None, "32"), ("1", "1", "32"),
            ("0", None, None), (None, None, None)]


@pytest.mark.parametrize("rn_int8,conv,min_mid", RN_KNOBS)
def test_rn_int8_static_matches_jax(rng, tmp_path, knob_env, rn_int8, conv, min_mid):
    """Both encoders in int8_static from one .npz and one .calib.npz (the
    JAX encoder calibrates and writes it, the port's reads it): the same
    route (W8A8, or bfloat16 where CTPU_RN_INT8 is off or auto resolves off
    at this width), the same quantized leaves, embeddings within the
    int8_static budget."""
    knob_env(CTPU_RN_INT8=rn_int8, CTPU_RN_INT8_CONV=conv, CTPU_RN_INT8_MIN_MID=min_mid)
    npz, calib = _write_npz(tmp_path, rng), str(tmp_path / "rn.calib.npz")
    x = rng.normal(0, 0.7, (4, 64, 64, 3)).astype(np.float32)
    j = jenc.CLIPImageEncoder(NAME, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib)
    ref = np.asarray(j.encode(jnp.asarray(x)))
    t = tenc.CLIPImageEncoder(NAME, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib, device="cpu")
    assert (t.quantized, t.static_quant) == (j.quantized, j.static_quant) == (
        (rn_int8 == "1",) * 2)
    if t.static_quant:
        assert t.load_calibration() and t.model.calibrated
        back = tweights.params_from_module(t.model)
        flat = jax.tree.map(np.asarray, j.params)
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_allclose(back[k], v, rtol=1e-7, err_msg=k)
        assert ("s0b0_conv1_scale" in back) == (min_mid is None)  # mid 8 < 32 stays float
    got = trn.rn_encode_image(t.model, torch.from_numpy(x), t.compute_dtype).numpy()
    assert _cos_err(got, ref) <= (2e-3 if t.static_quant else 1e-3)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16)])
def test_rn_calibration_matches_jax(rng, quantized, tdtype, jdtype):
    """The calibration forward's [2] site amaxes per block within 1e-2 of
    the JAX package's (jitted and op by op), on float or quantized weights
    (dequantized for this forward)."""
    params = _np_params(jrn.RN_TEST_TINY, rng, seed=5)
    jp = jrn.quantize_rn_params(params) if quantized else params
    tp = trn.quantize_rn_params(params) if quantized else params
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.tree.map(np.asarray, jrn.rn_act_amax(jp, jnp.asarray(x), jrn.RN_TEST_TINY,
                                                   compute_dtype=jdtype))
    with jax.disable_jit():
        eager = jax.tree.map(np.asarray, jrn.rn_act_amax(jp, jnp.asarray(x), jrn.RN_TEST_TINY,
                                                         compute_dtype=jdtype))
    got = trn.rn_act_amax(tweights.module_from_params(tp, trn.RN_TEST_TINY),
                          torch.from_numpy(x), tdtype)
    assert set(got) == set(ref) == {f"s{s}b0_act_amax" for s in range(4)}
    for k in ref:
        assert got[k].shape == (2,) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)
        np.testing.assert_allclose(got[k], eager[k], rtol=1e-2, err_msg=k)


def test_port_calibration_file_loads_in_jax(rng, tmp_path, knob_env):
    """The port's .calib.npz (s{s}b{b}_act_amax with the model name) is what
    the JAX encoder reads, and it attaches the same scales."""
    knob_env(CTPU_RN_INT8="1")
    npz, calib = _write_npz(tmp_path, rng), str(tmp_path / "port.calib.npz")
    x = rng.normal(0, 0.7, (2, 64, 64, 3)).astype(np.float32)
    t = tenc.CLIPImageEncoder(NAME, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib, device="cpu")
    t._maybe_calibrate(torch.from_numpy(x).to(torch.bfloat16))
    with np.load(calib) as f:
        assert str(f["_model_name"]) == NAME and sorted(f.files) == sorted(
            [f"s{s}b0_act_amax" for s in range(4)] + ["_model_name"])
    j = jenc.CLIPImageEncoder(NAME, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib)
    assert j.load_calibration()
    back = tweights.params_from_module(t.model)
    for s in range(4):
        k = f"s{s}b0_act_amax"
        np.testing.assert_array_equal(np.asarray(j.params[k]), back[k], err_msg=k)


@pytest.mark.parametrize("case", ["other_model", "vit_file", "wrong_depth", "cnx_file"])
def test_rn_check_calibration_as_jax(tmp_path, case):
    """A file of another model, family or depth is rejected with the JAX
    package's message."""
    cfg_j, cfg_t = jvit.resolve_config("RN50/openai"), tvit.resolve_config("RN50/openai")
    blocks = {f"s{s}b{b}_act_amax": np.ones(2, np.float32)
              for s, n in enumerate(cfg_t.layers) for b in range(n)}
    amax = {"other_model": {**blocks, "_model_name": np.asarray("RN101/openai")},
            "vit_file": {"act_amax": np.ones((24, 4), np.float32)},
            "wrong_depth": {k: v for k, v in blocks.items() if k != "s2b5_act_amax"},
            "cnx_file": {f"s{s}_act_amax": np.ones((3, 2), np.float32) for s in range(4)},
            }[case]
    path = str(tmp_path / "x.calib.npz")
    with pytest.raises(ValueError) as want:
        jenc.check_calibration(amax, cfg_j, path, "RN50/openai")
    with pytest.raises(ValueError) as got:
        tenc.check_calibration(amax, cfg_t, path, "RN50/openai")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype,rn_int8,level", [
    ("int8", None, logging.WARNING),
    ("int8_static", None, logging.INFO),
    ("int8_static", "0", logging.INFO),
])
def test_rn_downgrade_log_lines(caplog, knob_env, dtype, rn_int8, level):
    """Dynamic int8 and int8_static where the gate is off run bfloat16, with
    the JAX package's log line at its level."""
    knob_env(CTPU_RN_INT8=rn_int8)
    lines = {}
    for pkg, make in (("jax", lambda: jenc.CLIPImageEncoder(NAME, compute_dtype=dtype)),
                      ("port", lambda: tenc.CLIPImageEncoder(NAME, compute_dtype=dtype,
                                                             device="cpu"))):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            enc = make()
        assert not enc.quantized and not enc.static_quant
        lines[pkg] = [(r.levelno, r.getMessage()) for r in caplog.records
                      if "running bfloat16" in r.getMessage()]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 1
    assert lines["jax"][0][0] == level


@pytest.mark.parametrize("rn_int8", ["1", "0", None])
def test_rn_int8_gate_matches_jax(knob_env, rn_int8):
    """rn_int8_static_enabled under on, off and auto, for every tower."""
    knob_env(CTPU_RN_INT8=rn_int8)
    for arch in ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64", "RN-Test"):
        name = arch + "/openai"
        assert (trn.rn_int8_static_enabled(tvit.resolve_config(name))
                == jrn.rn_int8_static_enabled(jvit.resolve_config(name))), name


def test_rn_min_mid_quantizes_as_jax(rng):
    """quantize_rn_params with a min_mid: the same leaves as the JAX
    package's, the narrow blocks float."""
    params = _np_params(jrn.RN_TEST_TINY, rng, seed=6)
    want = jax.tree.map(np.asarray, jrn.quantize_rn_params(params, min_mid=32))
    got = trn.quantize_rn_params(params, min_mid=32)
    assert set(got) == set(want) and "s0b0_conv1_scale" not in got
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_rn50_full_geometry_float32(rng):
    """RN50 at its published width and depth, one image in float32 on
    weights carried across: within 1e-5 of the JAX package."""
    jcfg = jvit.resolve_config("RN50/openai")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jrn.init_rn_params(jcfg, k))(
        jax.random.key(7)))
    x = rng.normal(0, 1, (1, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jrn.rn_encode_image(params, jnp.asarray(x), jcfg,
                                         compute_dtype=jnp.float32))
    tcfg = tvit.resolve_config("RN50/openai")
    got = trn.rn_encode_image(tweights.module_from_params(params, tcfg), torch.from_numpy(x),
                              torch.float32).numpy()
    assert got.shape == (1, 1024)
    assert _cos_err(got, ref) < 1e-5


def test_rn_embed_crops_matches_jax(rng):
    """The encoders' fused crop path: the same [B·n, R, R, 3] crops into the
    tower, float32, random weights carried across as params."""
    from clip_assisted_data_labeling_tpu.ops.crops import make_crop_params

    params = _np_params(jrn.RN_TEST_TINY, rng, seed=8)
    canvas = np.zeros((2, 128, 128, 3), np.uint8)
    crop = np.zeros((2, 4, 2, 4), np.float32)
    for i, (w, h) in enumerate([(120, 80), (40, 50)]):
        oy, ox = (128 - h) // 2, (128 - w) // 2
        canvas[i, oy:oy + h, ox:ox + w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        crop[i] = make_crop_params(w, h, 128, 64)
    j = jenc.CLIPImageEncoder(NAME, params=params, compute_dtype=jnp.float32)
    t = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32", device="cpu")
    ref = np.asarray(j.embed_crops(jnp.asarray(canvas), jnp.asarray(crop)))
    got = t.embed_crops(canvas, crop).numpy()
    assert got.shape == ref.shape == (2, 4, 16)
    assert _cos_err(got.reshape(-1, 16), ref.reshape(-1, 16)) < 1e-5


@pytest.mark.parametrize("debug_nans", [False, True])
def test_rn_debug_nans_names_the_block(rng, debug_nans):
    """An encoder built with ``debug_nans`` on weights with a NaN in block
    s2b0's folded bias raises ``FloatingPointError`` naming that block;
    without the flag the forward returns (NaN rows)."""
    from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params

    params = _np_params(jrn.RN_TEST_TINY, rng, seed=5)
    params["s2b0_bn3_bias"][0] = np.nan
    t = tenc.CLIPImageEncoder(NAME, params=params, compute_dtype="float32", device="cpu",
                              debug_nans=debug_nans)
    canvas = rng.integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    crop = make_crop_params(64, 64, 64, 64)[None]
    if debug_nans:
        with pytest.raises(FloatingPointError, match="the output of block s2b0"):
            t.embed_crops(canvas, crop)
    else:
        assert np.isnan(t.embed_crops(canvas, crop).numpy()).all()
