"""The port's ViT tower against the JAX package's at a small width: weights
carried from the JAX params through ``module_from_params``, inputs from
numpy, the JAX fused (Pallas) path run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.models.clip_weights import (
    flatten_params,
    module_from_params,
    params_from_module,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

# width 128 takes the JAX package's fused int8_static lnk path; head dim 64
# makes the attention scale 0.125 exact in bf16
DIMS = dict(width=128, layers=2, heads=2, patch_size=8, image_size=32, embed_dim=32)
JCFG = jvit.VitConfig(**DIMS)
TCFG = tvit.VitConfig(**DIMS)


def _np_params(rng) -> dict:
    """JAX random init with the layernorm affines and biases perturbed, as
    nested numpy (the JAX pytree layout)."""
    p = jax.tree.map(np.asarray, jvit.init_vit_params(JCFG, jax.random.key(3)))
    for k in ("ln_pre_scale", "ln_post_scale"):
        p[k] = (p[k] + rng.normal(0, 0.1, p[k].shape)).astype(np.float32)
    for k, v in p["blocks"].items():
        if k.endswith(("_bias", "_scale")):
            p["blocks"][k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return p


def _jax_encode(params, x, dtype, monkeypatch):
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    out = jvit.vit_encode_image(params, jnp.asarray(x), JCFG, compute_dtype=dtype,
                                fused_attention=True)
    monkeypatch.delenv("CTPU_PALLAS_INTERPRET")
    return np.asarray(out)


def _cos_err(a, b):
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
def test_vit_encode_matches_jax(rng, monkeypatch, tdtype, jdtype, limit):
    params = _np_params(rng)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    ref = _jax_encode(params, x, jdtype, monkeypatch)
    model = module_from_params(params, TCFG)
    got = tvit.vit_encode_image(model, torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (4, 32) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


def test_quantize_weight_bit_exact(rng):
    params = _np_params(rng)
    ref = jax.tree.map(np.asarray, jax_quantize(params))
    got = quantize_vit_params(flatten_params(params))
    flat_ref = flatten_params(ref)
    assert set(got) == set(flat_ref)
    for k, v in flat_ref.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_int8_static_and_calibration_match_jax(rng, monkeypatch):
    params = _np_params(rng)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    qparams = jax_quantize(params)
    model = module_from_params(quantize_vit_params(flatten_params(params)), TCFG)
    # calibration forward: dynamic per-row int8 matmuls and, in both
    # packages, the XLA attention path. Against the jitted JAX function every
    # per-tensor site is within 1e-2 in both dtypes, and the per-channel
    # qkv_amax in float32. In bfloat16 a 1-ulp change in a row's amax moves
    # that row's whole dynamic int8 grid, and under jit XLA feeds some bf16
    # sums to the next layernorm unrounded (the stem's x + pos_emb, the
    # residual before ln2): the jitted and the op-by-op JAX runs of this
    # function differ by 2.3% in qkv_amax at layer 2. The port computes the
    # JAX code as written, op by op, so bf16 is also held, at every site,
    # against the JAX function run without jit.
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jamax = jax.tree.map(np.asarray, jvit.vit_act_amax(
            qparams, jnp.asarray(x), JCFG, compute_dtype=jdt))
        tamax = tvit.vit_act_amax(model, torch.from_numpy(x), tdt)
        for k in ("act_amax", "qkv_amax") if tdt == torch.float32 else ("act_amax",):
            assert tamax[k].shape == jamax[k].shape
            np.testing.assert_allclose(tamax[k], jamax[k], rtol=1e-2, err_msg=f"{tdt} {k}")
    with jax.disable_jit():
        eager = jax.tree.map(np.asarray, jvit.vit_act_amax(
            qparams, jnp.asarray(x), JCFG, compute_dtype=jnp.bfloat16))
    for k in ("act_amax", "qkv_amax"):
        np.testing.assert_allclose(tamax[k], eager[k], rtol=1e-2, err_msg=f"bf16 op by op {k}")

    # the same act_amax into both: the JAX lnk path (Pallas, interpret) vs
    # the port's lnk path (K2 + K1 plain versions on the CPU)
    sparams = jvit.attach_act_amax(qparams, {"act_amax": jamax["act_amax"]})
    ref = _jax_encode(sparams, x, jnp.bfloat16, monkeypatch)
    tvit.attach_act_amax(model, {"act_amax": jamax["act_amax"]})
    assert model.calibrated
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos_err(got, ref) <= 2e-3  # the int8_static budget (tests/test_quant.py)


def test_params_round_trip_through_module(rng):
    params = flatten_params(quantize_vit_params(flatten_params(_np_params(rng))))
    back = params_from_module(module_from_params(params, TCFG))
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_registry_and_unported_families():
    cfg = tvit.resolve_config("ViT-L-14-336/openai")
    assert (cfg.width, cfg.layers, cfg.seq_len, cfg.act) == (1024, 24, 577, "quick_gelu")
    assert tvit.resolve_config("ViT-B-32/laion2b_s34b_b79k").act == "gelu"
    for name in ("ViT-L-14-336/openai", "ViT-B-16/laion400m_e32", "ViT-Test/tiny"):
        j, t = jvit.resolve_config(name), tvit.resolve_config(name)
        assert (j.width, j.layers, j.heads, j.patch_size, j.image_size, j.embed_dim,
                j.mlp_dim, j.act) == (t.width, t.layers, t.heads, t.patch_size,
                                      t.image_size, t.embed_dim, t.mlp_dim, t.act)
    # every family resolves, the convolutional towers to their own configs
    assert tvit.resolve_config("EVA02-L-14-336/merged2b_s6b_b61k").mlp_type == "swiglu"
    rn = tvit.resolve_config("RN50/openai")
    assert isinstance(rn, tvit.RNConfig) and (rn.final_width, rn.seq_len) == (2048, 50)
    jrn = jvit.resolve_config("RN50/openai")
    assert (rn.layers, rn.width, rn.embed_dim, rn.heads) == (jrn.layers, jrn.width,
                                                             jrn.embed_dim, jrn.heads)
    cnx = tvit.resolve_config("convnext_large_d_320/laion2b_s29b_b131k_ft_soup")
    assert isinstance(cnx, tvit.CNXConfig) and (cnx.proj, cnx.final_width) == ("mlp", 1536)
