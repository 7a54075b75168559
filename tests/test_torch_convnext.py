"""The port's ConvNeXt towers against the JAX package's: the converter leaf
for leaf on the JAX tests' HF ``ConvNextModel`` mirror in both layouts (HF,
and open_clip/timm with a linear or mlp head), the forward of CNX-Test and
CNX-Test-mlp in float32 and bfloat16 on weights carried across, the exact
GELU step by step, int8_static through both encoders from one ``.npz`` and
one ``.calib.npz`` under every value of ``CTPU_CNX_INT8``, the calibration
forward, each package reading the other's calibration file, the calibration
checks, the downgrade log lines, and one full convnext_base_w image in
float32. Inputs are numpy from a seed."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import convnext as jcnx
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import convnext as tcnx
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from tests.test_cnx_parity import _hf_forward, _to_timm_sd, make_mirror
from tests.test_torch_resnet import _cos_err, knob_env  # noqa: F401  (fixture)

NAMES = ["CNX-Test/laion2b", "CNX-Test-mlp/laion2b"]


def _np_params(cfg, rng, seed=0):
    """JAX random init with the LN affines, biases and layer scales
    perturbed (gamma to ~0.3, so the blocks move the residual), as numpy."""
    p = jax.tree.map(np.asarray, jax.jit(lambda k: jcnx.init_cnx_params(cfg, k))(
        jax.random.key(seed)))
    for k, v in p.items():
        if k.endswith(("_bias", "_scale")):
            p[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        elif k.endswith("gamma"):
            p[k] = (0.3 + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    return p


def _check_leaves(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_cnx_hf_layout_converts_as_jax(rng):
    """HF ConvNextModel (trunk only: an identity projection, the HF post-pool
    LN's eps): the JAX converter's leaves, and the port's float32 forward
    within 1e-5 of the mirror's pooler output."""
    jcfg = dataclasses.replace(jcnx.CNX_TEST_TINY, embed_dim=32)
    tcfg = dataclasses.replace(tcnx.CNX_TEST_TINY, embed_dim=32)
    mirror = make_mirror(jcfg, seed=2)
    sd = mirror.state_dict()
    got = tweights.convert_torch_state_dict(sd, tcfg)
    _check_leaves(got, jax.tree.map(np.asarray, jweights.convert_torch_state_dict(sd, jcfg)))
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = _hf_forward(mirror, x)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    out = tcnx.cnx_encode_image(tweights.module_from_params(got, tcfg), torch.from_numpy(x),
                                torch.float32).numpy()
    assert _cos_err(out, ref) < 1e-5


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_cnx_timm_layout_converts_as_jax(rng, proj):
    """open_clip/timm 'visual.trunk.*' + 'visual.head.*' with either head:
    the JAX converter's leaves, and both packages' float32 forwards agree."""
    jcfg = dataclasses.replace(jcnx.CNX_TEST_TINY, proj=proj)
    tcfg = dataclasses.replace(tcnx.CNX_TEST_TINY, proj=proj)
    sd = _to_timm_sd(make_mirror(jcfg, seed=3).state_dict(), jcfg)
    torch.manual_seed(7)
    cl, e = jcfg.final_width, jcfg.embed_dim
    if proj == "linear":
        head = torch.nn.Linear(cl, e)
        sd["visual.head.proj.weight"], sd["visual.head.proj.bias"] = head.weight, head.bias
    else:
        fc1, fc2 = torch.nn.Linear(cl, 2 * e), torch.nn.Linear(2 * e, e)
        sd["visual.head.mlp.fc1.weight"], sd["visual.head.mlp.fc1.bias"] = fc1.weight, fc1.bias
        sd["visual.head.mlp.fc2.weight"], sd["visual.head.mlp.fc2.bias"] = fc2.weight, fc2.bias
    want = jax.tree.map(np.asarray, jweights.convert_torch_state_dict(sd, jcfg))
    got = tweights.convert_torch_state_dict(sd, tcfg)
    _check_leaves(got, want)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jcnx.cnx_encode_image(want, jnp.asarray(x), jcfg,
                                           compute_dtype=jnp.float32))
    out = tcnx.cnx_encode_image(tweights.module_from_params(got, tcfg), torch.from_numpy(x),
                                torch.float32).numpy()
    assert _cos_err(out, ref) < 1e-5


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
@pytest.mark.parametrize("name", NAMES)
def test_cnx_encode_matches_jax(rng, name, tdtype, jdtype, limit):
    """CNX-Test and CNX-Test-mlp on weights carried across, against the JAX
    forward: jitted within the mode's limit, op by op within 1e-4 (the port
    computes the JAX code as written; XLA's jit skips some bf16 roundings)."""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = _np_params(jcfg, rng, seed=1)
    x = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jcnx.cnx_encode_image(params, jnp.asarray(x), jcfg, compute_dtype=jdtype))
    with jax.disable_jit():
        eager = np.asarray(jcnx.cnx_encode_image(params, jnp.asarray(x), jcfg,
                                                 compute_dtype=jdtype))
    got = tcnx.cnx_encode_image(tweights.module_from_params(params, tcfg),
                                torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, 16) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit
    assert _cos_err(got, eager) < 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_exact_equals_jax_op_by_op(rng, dtype):
    """``jax.nn.gelu(approximate=False)`` op by op, bit for bit; F.gelu's
    single rounding would differ on about a third of the bf16 values."""
    x = rng.normal(0, 2, (4096,)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with jax.disable_jit():
        ref = np.asarray(jax.nn.gelu(jnp.asarray(x, jd), approximate=False).astype(jnp.float32))
    got = tcnx.gelu_exact(torch.from_numpy(x).to(dtype)).float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def _write_npz(tmp_path, name, rng):
    path = str(tmp_path / (name.replace("/", "-") + ".npz"))
    jweights.save_params_npz(path, _np_params(jvit.resolve_config(name), rng, seed=2))
    return path


@pytest.mark.parametrize("cnx_int8", ["1", "0", None])
@pytest.mark.parametrize("name", NAMES)
def test_cnx_int8_static_matches_jax(rng, tmp_path, knob_env, name, cnx_int8):
    """Both encoders in int8_static from one .npz and one .calib.npz (the
    JAX encoder calibrates and writes it, the port's reads it) under
    CTPU_CNX_INT8 on, off and auto (off at this width): the same route, the
    same quantized leaves, embeddings within the int8_static budget."""
    knob_env(CTPU_CNX_INT8=cnx_int8)
    npz, calib = _write_npz(tmp_path, name, rng), str(tmp_path / "cnx.calib.npz")
    x = rng.normal(0, 0.7, (4, 64, 64, 3)).astype(np.float32)
    j = jenc.CLIPImageEncoder(name, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib)
    ref = np.asarray(j.encode(jnp.asarray(x)))
    t = tenc.CLIPImageEncoder(name, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib, device="cpu")
    assert (t.quantized, t.static_quant) == (j.quantized, j.static_quant) == (
        (cnx_int8 == "1",) * 2)
    if t.static_quant:
        assert t.load_calibration() and t.model.calibrated
        back = tweights.params_from_module(t.model)
        flat = jax.tree.map(np.asarray, j.params)
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_allclose(back[k], v, rtol=1e-7, err_msg=k)
    got = tcnx.cnx_encode_image(t.model, torch.from_numpy(x), t.compute_dtype).numpy()
    assert _cos_err(got, ref) <= (2e-3 if t.static_quant else 1e-3)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_cnx_calibration_matches_jax(rng, name, quantized):
    """The calibration forward's [depth, 2] site amaxes per stage within
    1e-2 of the JAX package's op-by-op run, on float or quantized weights."""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = _np_params(jcfg, rng, seed=5)
    jp = jcnx.quantize_cnx_params(params) if quantized else params
    tp = tcnx.quantize_cnx_params(params) if quantized else params
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.disable_jit():
        ref = jax.tree.map(np.asarray, jcnx.cnx_act_amax(jp, jnp.asarray(x), jcfg,
                                                         compute_dtype=jnp.bfloat16))
    got = tcnx.cnx_act_amax(tweights.module_from_params(tp, tcfg), torch.from_numpy(x),
                            torch.bfloat16)
    assert set(got) == set(ref) == {f"s{s}_act_amax" for s in range(4)}
    for s, d in enumerate(tcfg.depths):
        k = f"s{s}_act_amax"
        assert got[k].shape == (d, 2) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)
    if quantized:
        _check_leaves({k: v for k, v in tp.items()}, jax.tree.map(np.asarray, jp))


def test_port_calibration_file_loads_in_jax(rng, tmp_path, knob_env):
    knob_env(CTPU_CNX_INT8="1")
    name = NAMES[1]
    npz, calib = _write_npz(tmp_path, name, rng), str(tmp_path / "port.calib.npz")
    x = rng.normal(0, 0.7, (2, 64, 64, 3)).astype(np.float32)
    t = tenc.CLIPImageEncoder(name, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib, device="cpu")
    t._maybe_calibrate(torch.from_numpy(x).to(torch.bfloat16))
    j = jenc.CLIPImageEncoder(name, model_path=npz, compute_dtype="int8_static",
                              calibration_path=calib)
    assert j.load_calibration()
    back = tweights.params_from_module(t.model)
    for s in range(4):
        k = f"s{s}_act_amax"
        assert back[k].shape == (tvit.resolve_config(name).depths[s], 2)
        np.testing.assert_array_equal(np.asarray(j.params[k]), back[k], err_msg=k)


@pytest.mark.parametrize("case", ["wrong_depth", "rn_file", "vit_file"])
def test_cnx_check_calibration_as_jax(tmp_path, case):
    name = "convnext_large_d_320/laion2b_s29b_b131k_ft_soup"
    cfg_j, cfg_t = jvit.resolve_config(name), tvit.resolve_config(name)
    stages = {f"s{s}_act_amax": np.ones((d, 2), np.float32)
              for s, d in enumerate(cfg_t.depths)}
    amax = {"wrong_depth": {**stages, "s2_act_amax": np.ones((9, 2), np.float32)},
            "rn_file": {"s0b0_act_amax": np.ones(2, np.float32)},
            "vit_file": {"act_amax": np.ones((24, 4), np.float32),
                         "_model_name": np.asarray(name)}}[case]
    path = str(tmp_path / "x.calib.npz")
    with pytest.raises(ValueError) as want:
        jenc.check_calibration(amax, cfg_j, path, name)
    with pytest.raises(ValueError) as got:
        tenc.check_calibration(amax, cfg_t, path, name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype,cnx_int8,level", [
    ("int8", None, logging.WARNING),
    ("int8_static", None, logging.INFO),
    ("int8_static", "0", logging.INFO),
])
def test_cnx_downgrade_log_lines(caplog, knob_env, dtype, cnx_int8, level):
    knob_env(CTPU_CNX_INT8=cnx_int8)
    name = NAMES[0]
    lines = {}
    for pkg, make in (("jax", lambda: jenc.CLIPImageEncoder(name, compute_dtype=dtype)),
                      ("port", lambda: tenc.CLIPImageEncoder(name, compute_dtype=dtype,
                                                             device="cpu"))):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            enc = make()
        assert not enc.quantized and not enc.static_quant
        lines[pkg] = [(r.levelno, r.getMessage()) for r in caplog.records
                      if "running bfloat16" in r.getMessage()]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 1
    assert lines["jax"][0][0] == level


@pytest.mark.parametrize("cnx_int8", ["1", "0", None])
def test_cnx_int8_gate_matches_jax(knob_env, cnx_int8):
    knob_env(CTPU_CNX_INT8=cnx_int8)
    for arch in list(tcnx._CNX_ARCHS) + ["CNX-Test", "CNX-Test-mlp"]:
        name = arch + "/x"
        assert (tcnx.cnx_int8_static_enabled(tvit.resolve_config(name))
                == jcnx.cnx_int8_static_enabled(jvit.resolve_config(name))), name


def test_convnext_base_w_full_geometry_float32(rng):
    """convnext_base_w at its published width and depth (256 px), one image
    in float32 on weights carried across: within 1e-5 of the JAX package."""
    name = "convnext_base_w/laion2b_s13b_b82k"
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jcnx.init_cnx_params(jcfg, k))(
        jax.random.key(9)))
    for s in range(4):  # layer scales of 1e-6 would leave the blocks unseen
        params[f"s{s}_gamma"] = np.full_like(params[f"s{s}_gamma"], 0.2)
    x = rng.normal(0, 1, (1, 256, 256, 3)).astype(np.float32)
    ref = np.asarray(jcnx.cnx_encode_image(params, jnp.asarray(x), jcfg,
                                           compute_dtype=jnp.float32))
    got = tcnx.cnx_encode_image(tweights.module_from_params(params, tcfg), torch.from_numpy(x),
                                torch.float32).numpy()
    assert got.shape == (1, 640)
    assert _cos_err(got, ref) < 1e-5


@pytest.mark.parametrize("debug_nans", [False, True])
def test_cnx_debug_nans_names_the_block(rng, debug_nans):
    """An encoder built with ``debug_nans`` on weights with a NaN in stage
    2's second block raises ``FloatingPointError`` naming that block;
    without the flag the forward returns (NaN rows)."""
    from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params

    params = _np_params(jcnx.CNX_TEST_TINY, rng, seed=5)
    params["s2_fc2_bias"][1, 0] = np.nan
    t = tenc.CLIPImageEncoder(NAMES[0], params=params, compute_dtype="float32", device="cpu",
                              debug_nans=debug_nans)
    canvas = rng.integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    crop = make_crop_params(64, 64, 64, 64)[None]
    if debug_nans:
        with pytest.raises(FloatingPointError, match="the output of stage 2 block 1"):
            t.embed_crops(canvas, crop)
    else:
        assert np.isnan(t.embed_crops(canvas, crop).numpy()).all()
