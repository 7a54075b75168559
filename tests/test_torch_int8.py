"""The port's dynamic int8 (``compute_dtype="int8"``) against the JAX
package: the plain versions of K6 (``rowquant``), K9 (``q_linear_fused``)
and K1's ``quant_out`` against the JAX Pallas functions in interpret mode,
and the tower in each ``CTPU_INT8_BLOCK`` route and under
``CTPU_FUSED_QMATMUL=1``, with the dispatch of the JAX package's ``_block``.
Inputs are numpy from a seed; weights come from the JAX params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import knobs as jknobs
from clip_assisted_data_labeling_tpu.ops.attention import fused_attention_packed as jax_attn
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu.ops.quant import quantize_weight
from clip_assisted_data_labeling_tpu.ops.quant_kernel import q_linear_fused as jax_qlf
from clip_assisted_data_labeling_tpu.ops.quant_kernel import rowquant as jax_rowquant
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.models.clip_weights import (
    flatten_params,
    module_from_params,
)
from clip_assisted_data_labeling_tpu_torch.ops import knobs as tknobs
from clip_assisted_data_labeling_tpu_torch.ops import quant_kernel
from clip_assisted_data_labeling_tpu_torch.ops.attention import fused_attention_packed_plain
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    q_linear_fused_plain,
    rowquant_plain,
)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
FLIP_SHARE = 1e-3  # int8 values may differ by ±1 on at most this share of entries


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _to_jax(a: np.ndarray, dtype):
    return jnp.asarray(a).astype(JDT[dtype])


def _assert_int8_close(got: np.ndarray, ref: np.ndarray) -> None:
    """Equal except ±1 on at most FLIP_SHARE of the entries (a value a few
    ulps from a .5 boundary rounds either way after other summation orders)."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, f"int8 values differ by {diff.max()}"
    assert (diff > 0).mean() <= FLIP_SHARE, f"±1 on {(diff > 0).mean():.2e} of entries"


# ---- K6: rowquant ---------------------------------------------------------

@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu_tanh", "gelu"])
@pytest.mark.parametrize("ln", [False, True])
def test_rowquant_plain_matches_jax(rng, ln, act, dtype, k):
    """int8 equal except ±1 on ≤ 0.1% of entries; row scales within rtol
    1e-6. The activations run in float32, gelu with erf."""
    m = 40
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    lns = rng.normal(1, 0.1, (k,)).astype(np.float32) if ln else None
    lnb = rng.normal(0, 0.1, (k,)).astype(np.float32) if ln else None
    jq, js = jax_rowquant(_to_jax(x, dtype), None if lns is None else jnp.asarray(lns),
                          None if lnb is None else jnp.asarray(lnb), act=act, block_m=16,
                          interpret=True)
    tq, ts = rowquant_plain(_to_torch(x, dtype), None if lns is None else torch.from_numpy(lns),
                            None if lnb is None else torch.from_numpy(lnb), act=act)
    assert tq.dtype == torch.int8 and tq.shape == (m, k)
    assert ts.dtype == torch.float32 and ts.shape == (m, 1)
    _assert_int8_close(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_rowquant_refuses_unknown_activation():
    with pytest.raises(ValueError, match="activation"):
        rowquant_plain(torch.zeros((2, 128)), act="relu")
    with pytest.raises(ValueError, match="both"):
        rowquant_plain(torch.zeros((2, 128)), ln_scale=torch.ones(128))


# ---- K9: q_linear_fused --------------------------------------------------

@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("m,k,n,with_bias", [
    (40, 64, 32, True),
    (13, 32, 16, False),   # M not a multiple of the TPU block
    (20, 48, 72, False),   # ragged K and N (test_fused_non_divisible_dims)
    (20, 48, 72, True),
])
def test_q_linear_fused_plain_matches_jax(rng, m, k, n, with_bias, dtype, out_dtype):
    """Relative error ≤ 1e-5 in float32 or one bf16 ulp, except on rows
    where an int8 value flipped by ±1, at most 0.1% of the rows (none of
    these few)."""
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    wq, ws = quantize_weight(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    b = rng.normal(0, 0.1, (n,)).astype(np.float32) if with_bias else None
    ref = np.asarray(jax_qlf(_to_jax(x, dtype), jnp.asarray(wq), jnp.asarray(ws),
                             None if b is None else jnp.asarray(b), block_m=8,
                             interpret=True, out_dtype=JDT[out_dtype])).astype(np.float32)
    got = q_linear_fused_plain(_to_torch(x, dtype), torch.from_numpy(wq.T.copy()),
                               torch.from_numpy(ws), None if b is None else torch.from_numpy(b),
                               out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    rel = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    bad = np.abs(got.float().numpy() - ref) > rel * np.abs(ref) + 1e-7
    assert bad.any(axis=1).sum() <= int(FLIP_SHARE * m), f"{bad.sum()} entries off"


# ---- K1: quant_out ---------------------------------------------------------

@pytest.mark.parametrize("s,heads,dtype", [
    (17, 2, torch.float32), (17, 4, torch.bfloat16),     # one tile
    (577, 2, torch.bfloat16), (577, 4, torch.float32),   # q-row tiles on the TPU
])
def test_attention_quant_out_plain_matches_jax(rng, s, heads, dtype):
    """int8 ±1 on ≤ 0.1% of entries, per-token scales within rtol 1e-5: the
    amax spans the whole [w] row, all heads.

    In bf16, P is rounded to bf16 before P·V, and XLA's and PyTorch's f32
    exp differ in the last bit on ~10% of values, so ~2e-6 of the P values
    land on the other bf16 neighbour (at S=577, a few of the 1.3M); each
    moves its token's outputs by up to one bf16 step of that p. Those
    tokens (≤ 5%) are held to rtol 2^-8 instead."""
    b, w = 2, 128
    qkv = rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)
    scale = (w // heads) ** -0.5
    jq, js = jax_attn(_to_jax(qkv, dtype), heads=heads, scale=scale, interpret=True,
                      quant_out=True)
    tq, ts = fused_attention_packed_plain(_to_torch(qkv, dtype), heads, scale, quant_out=True)
    assert tq.dtype == torch.int8 and tq.shape == (b, s, w) and ts.shape == (b, s, 1)
    _assert_int8_close(tq.numpy(), np.asarray(jq))
    rel = np.abs(ts.numpy() / np.asarray(js) - 1)
    if dtype == torch.float32:
        assert rel.max() <= 1e-5
    else:
        assert (rel > 1e-5).mean() <= 5e-2 and rel.max() <= 2.0 ** -8


# ---- the tower -----------------------------------------------------------

# width 128 lets the JAX package take its hybrid block (rowquant needs
# K % 128 == 0); head dim 64 makes the attention scale 0.125 exact in bf16
DIMS = dict(width=128, layers=2, heads=2, patch_size=8, image_size=32, embed_dim=32)
ROPE = dict(act="gelu", use_rope2d=True, pool="attn", attn_pooler_heads=2)


@pytest.fixture()
def knob_env(monkeypatch):
    """Sets CTPU_* variables for both packages' knobs; restores the
    environment and re-reads both knob modules afterwards."""
    def set_env(**env):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        jknobs.reload()
        tknobs.reload()
        jax.clear_caches()  # traces keep the knob values they were made with

    yield set_env
    monkeypatch.undo()
    jknobs.reload()
    tknobs.reload()
    jax.clear_caches()


def _tower(rng, **over):
    """(JAX config, port config, JAX quantized params, port module)."""
    kw = dict(DIMS, **over)
    jcfg, tcfg = jvit.VitConfig(**kw), tvit.VitConfig(**kw)
    p = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(5)))

    def perturb(d):
        for k, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.endswith(("_bias", "_scale")):
                d[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(p)
    model = module_from_params(quantize_vit_params(flatten_params(p)), tcfg)
    return jcfg, tcfg, jax_quantize(p), model


def _encode_both(jcfg, tcfg, qparams, model, x, knob_env, **env):
    """Both towers' embeddings under the same CTPU_* settings: the JAX one
    with fused (Pallas, interpret mode) attention and bf16 compute."""
    knob_env(CTPU_PALLAS_INTERPRET="1", **env)
    ref = np.asarray(jvit.vit_encode_image(qparams, jnp.asarray(x), jcfg,
                                           compute_dtype=jnp.bfloat16, fused_attention=True))
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


def _cos_err(a, b):
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("mode,route", [
    ("xla-plain", "generic"), ("xla", "xla"), ("hybrid", "hybrid"),
])
def test_dynamic_int8_tower_matches_jax(rng, knob_env, mode, route, act):
    """Each CTPU_INT8_BLOCK route against the JAX package's, cosine error
    ≤ 2e-3. The hybrid gelu tower runs erf in K6, the others tanh."""
    jcfg, tcfg, qparams, model = _tower(rng, act=act)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    got, ref = _encode_both(jcfg, tcfg, qparams, model, x, knob_env, CTPU_INT8_BLOCK=mode)
    assert tvit.block_route(model.blocks[0], tcfg) == route
    assert _cos_err(got, ref) <= 2e-3


@pytest.mark.parametrize("mode", ["xla-plain", "xla", "hybrid"])
def test_dynamic_int8_rope_tower_is_generic_in_every_mode(rng, knob_env, mode):
    """A PE-style RoPE tower at width 128 takes the generic block whatever
    CTPU_INT8_BLOCK says, in both packages."""
    jcfg, tcfg, qparams, model = _tower(rng, use_cls_token=False, **ROPE)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    got, ref = _encode_both(jcfg, tcfg, qparams, model, x, knob_env, CTPU_INT8_BLOCK=mode)
    rope = tvit._rope_on(tcfg, torch.device("cpu"))
    assert tvit.block_route(model.blocks[0], tcfg, rope) == "generic"
    assert _cos_err(got, ref) <= 2e-3


@pytest.mark.parametrize("mode,route", [("hybrid", "generic"), ("xla", "xla")])
def test_dynamic_int8_narrow_tower_routes(rng, knob_env, mode, route):
    """Width 64: hybrid needs width % 128 == 0 and falls to the generic
    block (not to xla); xla takes any width."""
    jcfg, tcfg, qparams, model = _tower(rng, width=64, heads=1)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    got, ref = _encode_both(jcfg, tcfg, qparams, model, x, knob_env, CTPU_INT8_BLOCK=mode)
    assert tvit.block_route(model.blocks[0], tcfg) == route
    assert _cos_err(got, ref) <= 2e-3


def test_fused_qmatmul_tower_matches_jax_xla_route(rng, knob_env, monkeypatch):
    """CTPU_FUSED_QMATMUL=1: every dynamic q_matmul of the port runs K9
    (its plain version here), against the JAX package's XLA route (the JAX
    package takes K9 only on a TPU backend); cosine error ≤ 2e-3."""
    jcfg, tcfg, qparams, model = _tower(rng)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    calls = []
    real = quant_kernel.q_linear_fused

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(quant_kernel, "q_linear_fused", spy)
    got, ref = _encode_both(jcfg, tcfg, qparams, model, x, knob_env, CTPU_FUSED_QMATMUL="1")
    assert tknobs.FUSED_QMATMUL and len(calls) == 4 * tcfg.layers
    assert _cos_err(got, ref) <= 2e-3
