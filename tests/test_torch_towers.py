"""The port's name surface, CoCa and CLIPA towers against the JAX package's:
every name of the JAX package's open_clip list resolves to the JAX geometry
field for field (the ViT trunks, the modified ResNets and ConvNeXt); the
CoCa pooler readout and CLIPA's
mean-pool readout in float32, bfloat16 and int8_static on shared params; and
open_clip-style CoCa and CLIPA state dicts written by the JAX tests' mirrors
through both converters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.models.convnext import CNXConfig
from clip_assisted_data_labeling_tpu.models.resnet import RNConfig
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params
from tests.test_clipa_parity import ClipaVision
from tests.test_coca_parity import TorchCocaVisual
from tests.test_name_resolution import OPEN_CLIP_NAMES
from tests.test_torch_pe import _cos_err, _jax_encode, _np_params


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", [n for n, _ in OPEN_CLIP_NAMES])
def test_open_clip_name_surface(name):
    """Each name resolves to the JAX package's config field for field: a
    ViT trunk, a modified ResNet or a ConvNeXt tower, of the same family and
    with the same derived geometry."""
    ref, got = jvit.resolve_config(name), tvit.resolve_config(name)
    assert type(got).__name__ == type(ref).__name__
    assert _fields(got) == _fields(ref)
    if isinstance(ref, (RNConfig, CNXConfig)):
        props = ("final_width", "grid") + (("seq_len", "stage_widths")
                                           if isinstance(ref, RNConfig) else ())
        assert {p: getattr(got, p) for p in props} == {p: getattr(ref, p) for p in props}


@pytest.mark.parametrize("name,match", [
    ("hf-hub:laion/CLIP-ViT-L-14-laion2B-s32B-b82K", "--model_path"),
    ("MobileCLIP-S1/datacompdr", "recognized open_clip family"),
    ("ViTamin-L-336/datacomp1b", "recognized open_clip family"),
    ("ViT-Q-99/nope", "Unknown model format"),
    ("not-a-model", "Unknown model format"),
    ("RN42/openai", "Unknown model format"),
    ("convnext_huge/laion2b", "Unknown model format"),
])
def test_name_surface_refusals_match_jax(name, match):
    """The refusals the JAX package raises, with its guidance and message."""
    with pytest.raises(ValueError, match=match) as got:
        tvit.resolve_config(name)
    with pytest.raises(ValueError, match=match) as want:
        jvit.resolve_config(name)
    if match == "Unknown model format":
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["RN-Test/tiny", "convnext_base_w-quickgelu/laion2b_s13b_b82k"])
def test_conv_test_and_quickgelu_names_resolve_as_jax(name):
    """The two conv names the port refused before its conv towers: the test
    tower and a '-quickgelu' conv alias, which keeps the plain config (the
    suffix changes only open_clip's text side)."""
    ref, got = jvit.resolve_config(name), tvit.resolve_config(name)
    assert isinstance(got, (tvit.RNConfig, tvit.CNXConfig))
    assert type(got).__name__ == type(ref).__name__ and _fields(got) == _fields(ref)
    assert got == tvit.resolve_config(name.replace("-quickgelu", ""))


@pytest.mark.parametrize("name", ["ViT-Test2/tiny", "ViT-Test-HF/tiny", "CoCa-Test/tiny",
                                  "CLIPA-Test/tiny", "SigLIP2-Naflex-Test/tiny",
                                  "coca_base/anytag", "nllb-clip-large-siglip/v1",
                                  "ViT-SO400M-16-SigLIP2-naflex",
                                  "ViT-L-14-quickgelu/dfn2b"])
def test_registry_and_aliases_match_jax(name):
    assert _fields(tvit.resolve_config(name)) == _fields(jvit.resolve_config(name))


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
@pytest.mark.parametrize("name", ["CoCa-Test/tiny", "CLIPA-Test/tiny"])
def test_coca_clipa_encode_matches_jax(rng, monkeypatch, name, tdtype, jdtype, limit):
    """CoCa's pooler (query 0 of 7, ln_q/ln_k, separate q/k/v, ln_post and
    an [e, e] projection on the pooled dim) and CLIPA's mean of the patch
    tokens with ln_post after the pool, against the JAX fused path."""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = _np_params(jcfg, rng, seed=21)
    x = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = _jax_encode(params, x, jcfg, jdtype, monkeypatch)
    got = tvit.vit_encode_image(tweights.module_from_params(params, tcfg),
                                torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, tcfg.embed_dim) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


@pytest.mark.parametrize("name", ["CoCa-Test/tiny", "CLIPA-Test/tiny"])
def test_coca_clipa_int8_static_matches_jax(rng, monkeypatch, name):
    """int8_static on shared act_amax (the op-by-op JAX calibration, which
    the port's equals within the Known differences' bounds): the embedding
    within the int8_static budget."""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = _np_params(jcfg, rng, seed=22)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    qparams = jax_quantize(params)
    model = tweights.module_from_params(quantize_vit_params(tweights.flatten_params(params)),
                                        tcfg)
    with jax.disable_jit():
        eager = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                           compute_dtype=jnp.bfloat16))
    tamax = tvit.vit_act_amax(model, torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_allclose(tamax["act_amax"], eager["act_amax"], rtol=1e-2)
    amax = {"act_amax": eager["act_amax"]}
    ref = _jax_encode(jvit.attach_act_amax(qparams, amax), x, jcfg, jnp.bfloat16, monkeypatch)
    tvit.attach_act_amax(model, amax)
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos_err(got, ref) <= 2e-3


def _check_converted(sd, name, forward, rng, images=2):
    """Both converters on one state dict: the same leaves; the port's float32
    forward within 1e-5 of ``forward`` (the mirror's torch forward on NCHW
    images), returned normalized."""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    want = tweights.flatten_params(jax.tree.map(np.asarray,
                                                jweights.convert_torch_state_dict(sd, jcfg)))
    got = tweights.convert_torch_state_dict(sd, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    x = rng.normal(0, 1, (images, tcfg.image_size, tcfg.image_size, 3)).astype(np.float32)
    with torch.no_grad():
        ref = forward(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    out = tvit.vit_encode_image(tweights.module_from_params(got, tcfg), torch.from_numpy(x),
                                torch.float32).numpy()
    assert _cos_err(out, ref) < 1e-5
    return got


def test_coca_checkpoint_converts_as_jax(rng):
    """open_clip's CoCa 'visual' layout (the JAX test's mirror): the pooler's
    separate q/k/v weights and packed in_proj bias, ln_q/ln_k, ln_post and
    proj on the pooled dim."""
    torch.manual_seed(3)
    tower = TorchCocaVisual(jvit.resolve_config("CoCa-Test/tiny")).eval()
    got = _check_converted(tower.state_dict(), "CoCa-Test/tiny", tower, rng)
    assert got["proj"].shape == (16, 16) and got["pool_query"].shape == (7, 16)


def test_clipa_checkpoint_converts_as_jax(rng):
    """open_clip's CLIPA layout: no ln_pre (the converter leaves it out),
    the mean-pool readout."""
    torch.manual_seed(4)
    model = ClipaVision(jvit.resolve_config("CLIPA-Test/tiny")).eval()
    got = _check_converted(model.state_dict(), "CLIPA-Test/tiny", model, rng)
    assert "ln_pre_scale" not in got
