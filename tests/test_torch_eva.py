"""The port's EVA towers against the JAX package's: EVA02 (swiglu, the
attention and ffn sub-LNs, RoPE with a cls row), EVA02-E's post-norm blocks
and EVA01's plain blocks, in float32, bfloat16 and int8_static (the JAX fused
paths in interpret mode), the EVA02 calibration sites, the block routes, the
dynamic-int8 downgrade, the K padding of int8 weights (EVA02-L's fc2 has
K = 2730), and the converter from an EVA state dict written by the test
through both packages. Weights come from the JAX params or the JAX tests'
EVA mirrors; inputs are numpy from a seed."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops import quant_kernel
from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params
from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    K_ALIGN,
    int_matmul,
    pad_k,
    q_matmul,
    quantize_vit_params,
    quantize_weight,
)
from tests.test_eva_parity import EvaMirror, EvaPostMirror
from tests.test_torch_pe import _cos_err, _jax_encode, _np_params

EVA_NAMES = ["EVA01-g-14/laion400m_s11b_b41k", "EVA01-g-14-plus/merged2b_s11b_b114k",
             "EVA02-B-16/merged2b_s8b_b131k", "EVA02-L-14/merged2b_s4b_b131k",
             "EVA02-L-14-336/merged2b_s6b_b61k", "EVA02-E-14/laion2b_s4b_b115k",
             "EVA02-E-14-plus/laion2b_s9b_b144k", "EVA-Test/tiny", "EVA-Test-Wide/tiny",
             "EVA-Test-Post/tiny"]
TINY = ["EVA-Test/tiny", "EVA-Test-Wide/tiny", "EVA-Test-Post/tiny"]


def _eva_params(name, rng, seed):
    return jvit.resolve_config(name), tvit.resolve_config(name), _np_params(
        jvit.resolve_config(name), rng, seed)


@pytest.mark.parametrize("name", EVA_NAMES)
def test_eva_config_matches_jax(name):
    j, t = jvit.resolve_config(name), tvit.resolve_config(name)
    assert dataclasses_dict(t) == dataclasses_dict(j)
    assert (t.seq_len, t.head_dim, t.mlp_dim) == (j.seq_len, j.head_dim, j.mlp_dim)


def dataclasses_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_eva02_l336_main_path_shapes():
    """The card's main path: S = 577 with the cls row's identity rotation,
    16 heads of 64, the ragged swiglu hidden 2730 packed into fc1 (5460)."""
    cfg = tvit.resolve_config("EVA02-L-14-336/merged2b_s6b_b61k")
    assert (cfg.seq_len, cfg.head_dim, cfg.mlp_dim, cfg.use_ln_pre, cfg.patch_bias) == (
        577, 64, 2730, False, True)
    params = tvit.init_vit_params(tvit.VitConfig(**{**dataclasses_dict(cfg), "layers": 1}),
                                  torch.Generator().manual_seed(0))
    assert params["blocks/fc1_kernel"].shape == (1, 1024, 5460)
    assert params["blocks/ffn_ln_scale"].shape == (1, 2730)
    assert params["blocks/attn_ln_scale"].shape == (1, 1024)
    cos, sin = tvit._rope_on(cfg, torch.device("cpu"))
    assert cos.shape == (577, 32) and (cos[0] == 1).all() and (sin[0] == 0).all()


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
@pytest.mark.parametrize("name", TINY)
def test_eva_encode_matches_jax(rng, monkeypatch, name, tdtype, jdtype, limit):
    jcfg, tcfg, params = _eva_params(name, rng, seed=11)
    x = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = _jax_encode(params, x, jcfg, jdtype, monkeypatch)
    got = tvit.vit_encode_image(tweights.module_from_params(params, tcfg),
                                torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, tcfg.embed_dim) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


@pytest.mark.parametrize("name,route,k2_per_layer", [
    ("EVA-Test-Wide/tiny", "lnk", 3),  # ln1, the attention sub-LN (a[1]), ln2
    ("EVA-Test/tiny", "static", 0),  # width 64: the generic block, static scales
    ("EVA-Test-Post/tiny", "static", 0),  # post-norm: always the generic block
])
def test_eva_int8_static_and_calibration_match_jax(rng, monkeypatch, name, route, k2_per_layer):
    """The calibration forward (EVA02's a[1] after the attention sub-LN, a[3]
    after the ffn sub-LN; post-norm's a[0] and a[2] on the raw stream), then
    the same act_amax into both packages' int8_static blocks. float32 is held
    against the jitted JAX function, bf16 against the op-by-op JAX run:
    act_amax within 1e-2 (Known differences), qkv_amax within 3e-2 (a sum in
    another order moves a row's amax by an ulp, and with it that row's
    dynamic int8 grid; seen on the wide tower: 1.2% in float32, 2.1% in
    bf16). The embedding within the int8_static budget."""
    jcfg, tcfg, params = _eva_params(name, rng, seed=12)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    qparams = jax_quantize(params)
    model = tweights.module_from_params(quantize_vit_params(tweights.flatten_params(params)),
                                        tcfg)
    jamax = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                       compute_dtype=jnp.float32))
    tamax = tvit.vit_act_amax(model, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(tamax["act_amax"], jamax["act_amax"], rtol=1e-2)
    np.testing.assert_allclose(tamax["qkv_amax"], jamax["qkv_amax"], rtol=3e-2)
    with jax.disable_jit():
        eager = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                           compute_dtype=jnp.bfloat16))
    tamax = tvit.vit_act_amax(model, torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_allclose(tamax["act_amax"], eager["act_amax"], rtol=1e-2)
    np.testing.assert_allclose(tamax["qkv_amax"], eager["qkv_amax"], rtol=3e-2)

    amax = {"act_amax": eager["act_amax"]}
    ref = _jax_encode(jvit.attach_act_amax(qparams, amax), x, jcfg, jnp.bfloat16, monkeypatch)
    tvit.attach_act_amax(model, amax)
    rope = tvit._rope_on(tcfg, torch.device("cpu")) if tcfg.use_rope2d else None
    assert {tvit.block_route(b, tcfg, rope) for b in model.blocks} == {route}
    calls = []
    real = quant_kernel.rowquant_static_plain

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(quant_kernel, "rowquant_static_plain", counting)
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert len(calls) == k2_per_layer * tcfg.layers
    assert _cos_err(got, ref) <= 2e-3  # the int8_static budget


@pytest.mark.parametrize("name", TINY)
def test_eva_dynamic_int8_follows_jax(rng, caplog, name):
    """compute_dtype 'int8': EVA02's swiglu/sub-LN towers run bfloat16 with
    the JAX package's warning (both encoders), a post-norm tower runs its
    dynamic-int8 blocks through the generic block; the embeddings within the
    int8 budget of the JAX encoder's on the same weights."""
    jcfg, tcfg, params = _eva_params(name, rng, seed=13)
    canvas = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    crops = np.stack([make_crop_params(64, 48, 64, tcfg.image_size)] * 2).astype(np.float32)
    with caplog.at_level(logging.WARNING):
        jax_enc = jenc.CLIPImageEncoder(name, params=params, compute_dtype="int8")
        port = tenc.CLIPImageEncoder(name, params=params, compute_dtype="int8", device="cpu")
    eva02 = tcfg.mlp_type == "swiglu"
    assert (port.quantized, jax_enc.quantized) == (not eva02, not eva02)
    assert ("no dynamic-int8 formulation" in caplog.text) == eva02
    if not eva02:
        assert {tvit.block_route(b, tcfg) for b in port.model.blocks} == {"generic"}
    ref = np.asarray(jax_enc.embed_crops(jnp.asarray(canvas), jnp.asarray(crops)))
    got = port.embed_crops(canvas, crops).numpy()
    assert _cos_err(got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])) <= 2e-3


@pytest.mark.parametrize("m,k,n", [(20, 2730, 64), (5, 2730, 24), (33, 100, 8)])
def test_int_matmul_pads_k_against_float64(m, k, n):
    """K = 2730 (EVA02-L's fc2): the weights' K is padded with zeros to a
    multiple of K_ALIGN once, the activations to match inside int_matmul;
    the int32 product equals a float64 one exactly. q_matmul and K9's plain
    version take the padded weights too."""
    g = torch.Generator().manual_seed(k + m)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    wp = pad_k(w)
    assert wp.shape == (n, -(-k // K_ALIGN) * K_ALIGN) and (wp[:, k:] == 0).all()
    want = xq.double() @ w.double().t()
    got = int_matmul(xq, wp)
    assert got.dtype == torch.int32 and torch.equal(got.double(), want)
    x = torch.randn((m, k), generator=g)
    wf = torch.randn((k, n), generator=g) * k ** -0.5
    wq, ws = quantize_weight(wf)
    plain = q_matmul(x, wq.t().contiguous(), ws, out_dtype=torch.float32)
    padded = q_matmul(x, pad_k(wq.t().contiguous()), ws, out_dtype=torch.float32)
    assert torch.equal(plain, padded)
    fused = quant_kernel.q_linear_fused(x, pad_k(wq.t().contiguous()), ws,
                                        out_dtype=torch.float32)
    assert torch.equal(fused, quant_kernel.q_linear_fused_plain(x, wq.t().contiguous(), ws,
                                                                out_dtype=torch.float32))
    # only pad_k's width is matched: a weight of any other width still fails
    with pytest.raises(RuntimeError):
        int_matmul(xq, F.pad(wp, (0, K_ALIGN)))


def test_padded_int8_weights_round_trip(rng):
    """module_from_params pads each int8 kernel's K (fc2's 112 → 112, a
    ragged 100 → 112); params_from_module strips it: the quantized params
    come back leaf for leaf."""
    cfg = tvit.VitConfig(width=64, layers=2, heads=4, patch_size=8, image_size=32,
                         embed_dim=16, mlp_hidden=100, act="gelu", use_ln_pre=False,
                         patch_bias=True, mlp_type="swiglu", attn_inner_ln=True,
                         use_rope2d=True, ln_eps=1e-6)
    params = tweights.flatten_params(quantize_vit_params(
        tvit.init_vit_params(cfg, torch.Generator().manual_seed(3))))
    model = tweights.module_from_params(params, cfg)
    assert model.blocks[0].fc2_kernel.shape == (64, 112)
    assert model.blocks[0].fc1_kernel.shape == (200, 64)
    back = tweights.params_from_module(model)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def _state_dict(mirror):
    return {"visual." + k: v for k, v in mirror.state_dict().items()}


def _fuse(sd):
    """The fused EVA dialect: attn.qkv + bare q_bias/v_bias, mlp.w12."""
    fused = {}
    for k, v in sd.items():
        if ".attn.q_proj.weight" in k:
            b = k[: -len("q_proj.weight")]
            fused[b + "qkv.weight"] = torch.cat(
                [sd[b + "q_proj.weight"], sd[b + "k_proj.weight"], sd[b + "v_proj.weight"]])
            fused[b + "q_bias"], fused[b + "v_bias"] = sd[b + "q_proj.bias"], sd[b + "v_proj.bias"]
        elif ".mlp.w1.weight" in k:
            b = k[: -len("w1.weight")]
            fused[b + "w12.weight"] = torch.cat([sd[b + "w1.weight"], sd[b + "w2.weight"]])
            fused[b + "w12.bias"] = torch.cat([sd[b + "w1.bias"], sd[b + "w2.bias"]])
        elif not any(t in k for t in (".attn.k_proj.", ".attn.v_proj.", ".attn.q_proj.bias",
                                      ".mlp.w1.bias", ".mlp.w2.")):
            fused[k] = v
    return fused


@pytest.mark.parametrize("name,mirror,dialect", [
    ("EVA-Test/tiny", EvaMirror, "separate"),
    ("EVA-Test/tiny", EvaMirror, "fused"),
    ("EVA-Test-Post/tiny", EvaPostMirror, "separate"),
])
def test_eva_checkpoint_converts_as_jax(rng, name, mirror, dialect):
    """An EVA state dict in open_clip's 'visual.*' layout (the JAX tests'
    from-spec mirrors: q/k/v with no k bias, interleaved RoPE pairs, the
    sub-LNs, swiglu w1/w2/w3 — or the fused qkv and w12 dialect; EVA02-E's
    post-norm blocks) through both converters: the same leaves, the
    half-split RoPE marker, and the port's float32 forward within 1e-5 of
    the mirror's torch forward."""
    cfg = tvit.resolve_config(name)
    model = mirror(jvit.resolve_config(name), seed=5).eval()
    sd = _state_dict(model)
    if dialect == "fused":
        sd = _fuse(sd)
    ref_params = jax.tree.map(np.asarray,
                              jweights.convert_torch_state_dict(sd, jvit.resolve_config(name)))
    got = tweights.convert_torch_state_dict(sd, cfg)
    want = tweights.flatten_params(ref_params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert ("rope_half" in got) == cfg.use_rope2d
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    out = tvit.vit_encode_image(tweights.module_from_params(got, cfg), torch.from_numpy(x),
                                torch.float32).numpy()
    assert _cos_err(out, ref) < 1e-5


def test_eva_head_bias_refused_and_npz_across(rng, tmp_path):
    """A non-zero EVA head bias is refused (the readout has no projection
    bias), as in the JAX package; an EVA02 .npz the JAX package writes loads
    into the port with its rope_half marker, and a copy without the marker
    is upgraded by both packages alike."""
    jcfg = jvit.resolve_config("EVA-Test/tiny")
    sd = _state_dict(EvaMirror(jcfg, seed=6).eval())
    sd["visual.head.bias"] = torch.ones(jcfg.embed_dim)
    with pytest.raises(ValueError, match="head.bias"):
        tweights.convert_torch_state_dict(sd, tvit.resolve_config("EVA-Test/tiny"))
    params = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(1)))
    params.pop("rope_half")
    path = str(tmp_path / "eva.npz")
    jweights.save_params_npz(path, params)
    upgraded_j = tweights.flatten_params(jax.tree.map(np.asarray, jweights.ensure_rope_half(
        jweights.load_params_npz(path), jcfg)))
    upgraded_t = tweights.ensure_rope_half(tweights.load_params_npz(path),
                                           tvit.resolve_config("EVA-Test/tiny"))
    for k, v in upgraded_j.items():
        np.testing.assert_array_equal(np.asarray(upgraded_t[k]), v, err_msg=k)
