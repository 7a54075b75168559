"""The knobs that pick the int8_static block, ``CTPU_INT8_WIRE`` and
``CTPU_LN_KERNEL``, read by both packages: the port's ``block_route`` equals
the block the JAX package's ``_block`` runs (found by tracing one block
abstractly, with its three candidate paths watched), for the test towers and
the full-size towers of the port, and the tiny int8_static towers give the
JAX package's embeddings in every setting. Inputs are numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import attention as jattn
from clip_assisted_data_labeling_tpu.ops import knobs as jknobs
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.models.clip_weights import (
    flatten_params,
    module_from_params,
)
from clip_assisted_data_labeling_tpu_torch.ops import attention as tattn
from clip_assisted_data_labeling_tpu_torch.ops import knobs as tknobs
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params

# (CTPU_INT8_WIRE, CTPU_LN_KERNEL); None leaves the variable unset
SETTINGS = [(w, ln) for w in ("0", "1", None) for ln in ("0", None)]
TOWERS = ["ViT-Test/tiny", "SigLIP-Test/tiny", "PE-Test/tiny", "ViT-L-14-336/openai",
          "ViT-SO400M-14-SigLIP-384/webli", "ViT-SO400M-14-SigLIP2-512/webli", "PE-Core-L14-336"]


@pytest.fixture()
def knobs_set(monkeypatch):
    """Sets or clears CTPU_INT8_WIRE and CTPU_LN_KERNEL for both packages'
    knobs; restores the environment and re-reads both afterwards."""
    def set_env(wire, ln, **extra):
        for name, value in (("CTPU_INT8_WIRE", wire), ("CTPU_LN_KERNEL", ln), *extra.items()):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        jknobs.reload()
        tknobs.reload()
        jax.clear_caches()  # traces keep the knob values they were made with

    yield set_env
    monkeypatch.undo()
    jknobs.reload()
    tknobs.reload()
    jax.clear_caches()


def _port_block(cfg, wire: bool) -> tvit.VitBlock:
    """An int8_static block's markers (the route reads only which leaves are
    attached)."""
    leaves = {"qkv_kernel_scale": torch.ones(3 * cfg.width), "act_amax": torch.ones(4)}
    if wire:
        leaves["qkv_amax"] = torch.ones(3 * cfg.width)
    return tvit.VitBlock(leaves)


def _jax_route(cfg, wire: bool) -> str:
    """The block the JAX ``_block`` runs for one int8_static layer of ``cfg``
    at its padded token count: its wire and lnk paths and the attention are
    replaced by recorders (in a monkeypatch of their own, so the knobs'
    environment stays set), and the block is traced with abstract inputs."""
    calls = []

    def recorder(name):
        def fn(x, *args, **kw):
            calls.append(name)
            return x if name != "attention" else x[..., : x.shape[-1] // 3]
        return fn

    w, s = cfg.width, jattn._pad_for_tiling(cfg.seq_len)
    f32, i8 = jnp.float32, jnp.int8
    p = {"ln1_scale": (w,), "ln1_bias": (w,), "ln2_scale": (w,), "ln2_bias": (w,),
         "qkv_bias": (3 * w,), "out_bias": (w,), "fc1_bias": (cfg.mlp_dim,), "fc2_bias": (w,),
         "qkv_kernel_scale": (3 * w,), "out_kernel_scale": (w,),
         "fc1_kernel_scale": (cfg.mlp_dim,), "fc2_kernel_scale": (w,), "act_amax": (4,)}
    p = {k: jax.ShapeDtypeStruct(v, f32) for k, v in p.items()}
    for name, shape in (("qkv_kernel", (w, 3 * w)), ("out_kernel", (w, w)),
                        ("fc1_kernel", (w, cfg.mlp_dim)), ("fc2_kernel", (cfg.mlp_dim, w))):
        p[name] = jax.ShapeDtypeStruct(shape, i8)
    if wire:
        p["qkv_amax"] = jax.ShapeDtypeStruct((3 * w,), f32)
    rope = None
    if cfg.use_rope2d:
        rope = tuple(jnp.zeros((s, cfg.head_dim // 2), f32) for _ in range(2))
    x = jax.ShapeDtypeStruct((1, s, w), jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "_block_int8_static_wire", recorder("wire"))
        mp.setattr(jvit, "_block_int8_static_lnk", recorder("lnk"))
        mp.setattr(jattn, "packed_attention_auto", recorder("attention"))
        jax.eval_shape(lambda x_, p_: jvit._block(x_, p_, cfg, True, True, rope), x, p)
    route = [c for c in calls if c != "attention"]
    assert len(route) <= 1
    return route[0] if route else "static"


@pytest.mark.parametrize("wire_env,ln_env", SETTINGS)
@pytest.mark.parametrize("name", TOWERS)
def test_block_route_matches_jax(knobs_set, name, wire_env, ln_env):
    """int8_wire_enabled and the int8_static block of every setting, against
    the JAX package's choice: the wire only without RoPE and where the wire
    kernel's gate takes S, lnk under CTPU_LN_KERNEL at widths 128 divides,
    else the generic block with static scales."""
    knobs_set(wire_env, ln_env)
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    wire = tvit.int8_wire_enabled(tcfg)
    assert wire == jvit.int8_wire_enabled(jcfg)
    rope = tvit._rope_on(tcfg, torch.device("cpu")) if tcfg.use_rope2d else None
    route = tvit.block_route(_port_block(tcfg, wire), tcfg, rope)
    assert route == _jax_route(jcfg, wire)
    expect_wire = (wire_env == "1" or (wire_env is None and name.startswith("ViT-SO400M-14-SigLIP-384"))) \
        and not tcfg.use_rope2d and tattn.packed_q8s_fits(tcfg.seq_len, tcfg.width, tcfg.heads)
    assert (route == "wire") == expect_wire


@pytest.mark.parametrize("s", [577, 729, 1296])
def test_wire_gate_at_unpadded_and_padded_length(s):
    """The port asks the wire kernel's gate at S tokens, the JAX package at
    its padded count: the same answer (the gate pads S itself)."""
    pad = jattn._pad_for_tiling(s)
    assert tattn.packed_q8s_fits(s, 1152, 16) == jattn.packed_q8s_fits(pad, 1152, 16)
    assert tattn.packed_q8s_fits(s, 1024, 16) == jattn.packed_q8s_fits(pad, 1024, 16)
    assert tattn.packed_q8s_fits(s, 1152, 16) == (s != 1296)


def test_forced_wire_on_siglip2_512_takes_lnk(knobs_set):
    """CTPU_INT8_WIRE=1 on ViT-SO400M-14-SigLIP2-512 (S=1296, over the wire
    kernel's gate): qkv_amax is attached, and both packages run lnk (K2, and
    K5 for the attention)."""
    knobs_set("1", None)
    name = "ViT-SO400M-14-SigLIP2-512/webli"
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    assert tcfg.seq_len == 1296 and tvit.int8_wire_enabled(tcfg)
    assert not tattn.packed_q8s_fits(tcfg.seq_len, tcfg.width, tcfg.heads)
    assert tvit.block_route(_port_block(tcfg, True), tcfg) == "lnk"
    assert _jax_route(jcfg, True) == "lnk"
    assert tattn.attention_route(tcfg.seq_len, tcfg.width, tcfg.heads, 2) == "flash"


def _tiny_towers(rng, width):
    """(JAX config, port config, JAX quantized params, port module) of a tiny
    CLIP tower of ``width`` (head dim 32 or 64)."""
    kw = dict(width=width, layers=2, heads=2, patch_size=8, image_size=32, embed_dim=32)
    jcfg, tcfg = jvit.VitConfig(**kw), tvit.VitConfig(**kw)
    p = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(7)))

    def perturb(d):
        for k, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.endswith(("_bias", "_scale")):
                d[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(p)
    model = module_from_params(quantize_vit_params(flatten_params(p)), tcfg)
    return jcfg, tcfg, jax_quantize(p), model


@pytest.mark.parametrize("wire_env,ln_env", SETTINGS)
@pytest.mark.parametrize("width", [64, 128])
def test_int8_static_tower_matches_jax_in_every_setting(rng, knobs_set, width, wire_env, ln_env):
    """The tiny int8_static towers (width 64: the static generic block, or
    the wire; width 128: lnk as well) with the JAX package's calibration
    attached to both: cosine error ≤ 2e-3 against ``vit_encode_image``
    (Pallas in interpret mode)."""
    knobs_set(wire_env, ln_env, CTPU_PALLAS_INTERPRET="1")
    jcfg, tcfg, qparams, model = _tiny_towers(rng, width)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    wire = tvit.int8_wire_enabled(tcfg)
    assert wire == jvit.int8_wire_enabled(jcfg) == (wire_env == "1")
    amax = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                      compute_dtype=jnp.bfloat16))
    if not wire:
        amax = {"act_amax": amax["act_amax"]}
    ref = np.asarray(jvit.vit_encode_image(jvit.attach_act_amax(qparams, amax), jnp.asarray(x),
                                           jcfg, compute_dtype=jnp.bfloat16,
                                           fused_attention=True))
    tvit.attach_act_amax(model, amax, wire=wire)
    route = tvit.block_route(model.blocks[0], tcfg)
    assert route == ("wire" if wire else "lnk" if width == 128 and ln_env is None else "static")
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3
