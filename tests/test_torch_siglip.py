"""The port's SigLIP towers against the JAX package's: the routing rule
(which attention arithmetic and whether the int8 wire runs), the tower
forward, the int8_static wire forward at SO400M-384's geometry (narrow), the
HF SigLIP checkpoint converter, weights and calibration files both ways, and
the embed CLI's output read by the JAX package's train and predict stages.
Weights are carried from the JAX params; inputs are numpy from a seed; the
JAX fused (Pallas) paths run in interpret mode."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.config import EmbedConfig, TrainConfig
from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import attention as jattn
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu.pipeline.embed import embed_dataset as jax_embed
from clip_assisted_data_labeling_tpu.pipeline.predict import predict_labels
from clip_assisted_data_labeling_tpu.pipeline.train import (
    load_training_data,
    save_model,
    train_regressor,
)
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops import attention as tattn
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main

SO400M = "ViT-SO400M-14-SigLIP-384/webli"
# every SigLIP/SigLIP2 name of the JAX package's name-resolution list (the
# test below adds the port's other registered towers)
SIGLIP_NAMES = [
    "ViT-B-16-SigLIP/webli", "ViT-B-16-SigLIP-256/webli", "ViT-B-16-SigLIP-i18n-256/webli",
    "ViT-B-16-SigLIP-384/webli", "ViT-B-16-SigLIP-512/webli", "ViT-L-16-SigLIP-256/webli",
    "ViT-L-16-SigLIP-384/webli", "ViT-SO400M-14-SigLIP/webli", SO400M,
    "ViT-B-32-SigLIP2-256/webli", "ViT-B-16-SigLIP2/webli", "ViT-B-16-SigLIP2-384/webli",
    "ViT-L-16-SigLIP2-256/webli", "ViT-L-16-SigLIP2-512/webli", "ViT-SO400M-14-SigLIP2/webli",
    "ViT-SO400M-14-SigLIP2-378/webli", "ViT-SO400M-16-SigLIP2-256/webli",
    "ViT-SO400M-16-SigLIP2-384/webli", "ViT-SO400M-16-SigLIP2-512/webli",
    "ViT-gopt-16-SigLIP2-256/webli", "ViT-gopt-16-SigLIP2-384/webli",
]
FIELDS = ("width", "layers", "heads", "patch_size", "image_size", "embed_dim", "mlp_dim",
          "act", "ln_eps", "use_cls_token", "pool", "attn_pooler_heads", "use_ln_pre",
          "use_proj", "patch_bias", "norm_mean", "norm_std", "seq_len")
# SO400M-384's geometry at a narrow width: 27·14 + 6 = 384, S = 729, d = 72
WIRE_DIMS = dict(width=144, layers=2, heads=2, patch_size=14, image_size=384,
                 embed_dim=144, mlp_hidden=288, attn_pooler_heads=2)


def _cos_err(a, b):
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


def _jax_route(s, w, heads, itemsize):
    if jattn.packed_attention_fits(s, w, itemsize):
        return "packed"
    if jattn.grouped_attention_fits(s, w, heads, itemsize):
        return "grouped"
    return "flash"


@pytest.mark.parametrize("name", sorted(set(SIGLIP_NAMES) | set(tvit.MODEL_REGISTRY)))
def test_config_route_and_wire_match_jax(name):
    """Every name the port resolves: the same tower, the same attention
    kernel in bf16 and f32 (K1 where the JAX package runs its whole-block
    kernel, K4 where it runs grouped, K5 where it runs flash), the same int8
    wire rule."""
    j, t = jvit.resolve_config(name), tvit.resolve_config(name)
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}
    for itemsize in (2, 4):
        assert tvit_route(t, itemsize) == _jax_route(j.seq_len, j.width, j.heads, itemsize)
    assert tvit.int8_wire_enabled(t) == jvit.int8_wire_enabled(j)
    assert tattn.flash_panel(t.seq_len) == jattn._flash_tiles(
        jattn._round_up(j.seq_len, 8))[2]


def tvit_route(cfg, itemsize):
    return tattn.attention_route(cfg.seq_len, cfg.width, cfg.heads, itemsize)


def test_so400m_384_routes_to_flash_and_the_wire():
    cfg = tvit.resolve_config(SO400M)
    assert (cfg.seq_len, cfg.head_dim, cfg.mlp_dim) == (729, 72, 4304)
    assert tvit_route(cfg, 2) == tvit_route(cfg, 4) == "flash"
    assert tvit.int8_wire_enabled(cfg) and tattn.flash_panel(729) == 368
    assert not tvit.int8_wire_enabled(tvit.resolve_config("ViT-L-14-336/openai"))
    assert tvit.int8_wire_enabled(cfg, wire=False) is False
    # the naflex towers resolve since their port: a full 16×16 grid at patch 16
    naflex = tvit.resolve_config("ViT-SO400M-16-SigLIP2-naflex/webli")
    assert naflex.naflex and (naflex.seq_len, naflex.image_size) == (256, 256)


def _jax_encode(params, x, cfg, dtype, monkeypatch):
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    out = jvit.vit_encode_image(params, jnp.asarray(x), cfg, compute_dtype=dtype,
                                fused_attention=True)
    monkeypatch.delenv("CTPU_PALLAS_INTERPRET")
    return np.asarray(out)


def _np_params(cfg, rng, seed):
    """JAX random init with the affines and biases perturbed, as numpy."""
    p = jax.tree.map(np.asarray, jvit.init_vit_params(cfg, jax.random.key(seed)))

    def perturb(d):
        for k, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.endswith(("_bias", "_scale")):
                d[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(p)
    return p


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
@pytest.mark.parametrize("name", ["SigLIP-Test/tiny", "SigLIP-Test-Ragged/tiny"])
def test_siglip_encode_matches_jax(rng, monkeypatch, name, tdtype, jdtype, limit):
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = _np_params(jcfg, rng, seed=1)
    x = rng.normal(0, 1, (3, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    ref = _jax_encode(params, x, jcfg, jdtype, monkeypatch)
    got = tvit.vit_encode_image(tweights.module_from_params(params, tcfg),
                                torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, 64) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


def test_int8_wire_forward_matches_jax(rng, monkeypatch):
    """int8_static with the wire at SO400M-384's geometry (narrow): the same
    calibration into both, the JAX wire block (its K3 in interpret mode, on
    736 padded tokens) against the port's (K3's plain version, 729 tokens)."""
    jcfg = jvit.VitConfig(**WIRE_DIMS, **jvit._SIGLIP)
    tcfg = tvit.VitConfig(**WIRE_DIMS, **tvit._SIGLIP)
    assert tcfg.seq_len == 729 and jattn.packed_q8s_fits(736, 144, 2)
    params = _np_params(jcfg, rng, seed=2)
    x = rng.normal(0, 1, (2, 384, 384, 3)).astype(np.float32)
    qparams = jax_quantize(params)
    amax = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                      compute_dtype=jnp.bfloat16))
    ref = _jax_encode(jvit.attach_act_amax(qparams, amax), x, jcfg, jnp.bfloat16, monkeypatch)
    model = tweights.module_from_params(quantize_vit_params(tweights.flatten_params(params)),
                                        tcfg)
    tvit.attach_act_amax(model, amax, wire=True)
    assert all(blk.wire for blk in model.blocks)
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos_err(got, ref) <= 2e-3  # the int8_static budget
    # without the wire the same blocks take the K2 path and still agree
    model = tweights.module_from_params(quantize_vit_params(tweights.flatten_params(params)),
                                        tcfg)
    tvit.attach_act_amax(model, amax)
    assert not any(blk.wire for blk in model.blocks)
    no_wire = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos_err(no_wire, ref) <= 2e-3


def _hf_siglip_state_dict(cfg, rng, prefix="vision_model."):
    """A synthetic HF SiglipVisionModel state dict (torch layout)."""
    w, p, mlp = cfg.width, cfg.patch_size, cfg.mlp_dim

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {
        "embeddings.patch_embedding.weight": t(w, 3, p, p),
        "embeddings.patch_embedding.bias": t(w),
        "embeddings.position_embedding.weight": t(cfg.seq_len, w),
        "post_layernorm.weight": t(w), "post_layernorm.bias": t(w),
        "head.probe": t(1, 1, w),
        "head.attention.in_proj_weight": t(3 * w, w), "head.attention.in_proj_bias": t(3 * w),
        "head.attention.out_proj.weight": t(w, w), "head.attention.out_proj.bias": t(w),
        "head.layernorm.weight": t(w), "head.layernorm.bias": t(w),
        "head.mlp.fc1.weight": t(mlp, w), "head.mlp.fc1.bias": t(mlp),
        "head.mlp.fc2.weight": t(w, mlp), "head.mlp.fc2.bias": t(w),
    }
    for i in range(cfg.layers):
        b = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = t(w), t(w)
        for n in ("q", "k", "v", "out"):
            sd[b + f"self_attn.{n}_proj.weight"], sd[b + f"self_attn.{n}_proj.bias"] = t(w, w), t(w)
        sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = t(mlp, w), t(mlp)
        sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = t(w, mlp), t(w)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["vision_model.", ""])
def test_convert_siglip_visual_matches_jax(rng, prefix):
    name = "SigLIP-Test/tiny"
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    sd = _hf_siglip_state_dict(tcfg, rng, prefix)
    got = tweights.convert_torch_state_dict(sd, tcfg)  # dispatches to SigLIP first
    ref = tweights.flatten_params(jax.tree.map(
        np.asarray, jweights.convert_torch_state_dict(sd, jcfg)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    tweights.module_from_params(got, tcfg)  # every leaf the tower needs


@pytest.mark.parametrize("name", ["SigLIP-Test/tiny", SO400M])
def test_siglip_init_has_the_jax_leaves(name):
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    shapes = jax.eval_shape(lambda: jvit.init_vit_params(jcfg, jax.random.key(0)))
    ref = {k: tuple(v.shape) for k, v in tweights.flatten_params(shapes).items()}
    if name != SO400M:  # the full tower's leaves only by shape, never allocated
        got = tvit.init_vit_params(tcfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == ref
    assert set(ref) == set(tweights._top_keys(tcfg)) | {
        f"blocks/{k}" for k in tweights._BLOCK_KEYS}


def test_siglip_weights_npz_both_ways(tmp_path):
    name = "SigLIP-Test/tiny"
    params = jax.tree.map(np.asarray, jvit.init_vit_params(jvit.resolve_config(name),
                                                           jax.random.key(0)))
    jpath = str(tmp_path / "j.npz")
    jweights.save_params_npz(jpath, params)
    model = tweights.module_from_params(tweights.load_params_npz(jpath), tvit.resolve_config(name))
    tpath = str(tmp_path / "t.npz")
    tweights.save_params_npz(tpath, tweights.params_from_module(model))
    back = tweights.flatten_params(jweights.load_params_npz(tpath))
    flat = tweights.flatten_params(params)
    assert set(back) == set(flat)
    for k, v in back.items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)


@pytest.mark.parametrize("writer,reader", [(tenc, jenc), (jenc, tenc)])
def test_siglip_calibration_with_qkv_amax_both_ways(rng, tmp_path, writer, reader):
    cfg = (tvit if reader is tenc else jvit).resolve_config(SO400M)
    amax = {"act_amax": rng.random((27, 4)).astype(np.float32),
            "qkv_amax": rng.random((27, 3456)).astype(np.float32)}
    path = writer.calibration_file(SO400M, str(tmp_path))
    writer.save_calibration(path, amax, SO400M)
    got = reader.load_calibration(path)
    reader.check_calibration(got, cfg, path, SO400M)
    for k, v in amax.items():
        np.testing.assert_array_equal(got[k], v)


def test_encoder_attaches_qkv_amax_only_with_the_wire(rng, tmp_path):
    """The JAX package's rule (encoders.py:429-440, :503-515): a calibration
    file without qkv_amax is recalibrated when the wire is on; with the wire
    off only act_amax is attached."""
    name = "SigLIP-Test/tiny"
    images = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    path = str(tmp_path / "c.calib.npz")
    off = tenc.CLIPImageEncoder(name, compute_dtype="int8_static", calibration_path=path,
                                device="cpu")
    assert not off.wire
    off._maybe_calibrate(images)
    assert off.model.calibrated and not off.model.blocks[0].wire
    assert "qkv_amax" in tenc.load_calibration(path)  # the file keeps every site
    on = tenc.CLIPImageEncoder(name, compute_dtype="int8_static", calibration_path=path,
                               device="cpu", wire=True)
    assert on.load_calibration() and all(b.wire for b in on.model.blocks)
    tenc.save_calibration(path, {"act_amax": tenc.load_calibration(path)["act_amax"]}, name)
    on = tenc.CLIPImageEncoder(name, compute_dtype="int8_static", calibration_path=path,
                               device="cpu", wire=True)
    assert not on.load_calibration()  # lacks qkv_amax: recalibrate
    on._maybe_calibrate(images)
    assert all(b.wire for b in on.model.blocks)
    assert "qkv_amax" in tenc.load_calibration(path)


MODEL = "SigLIP-Test/tiny"
N = 6


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_siglip_e2e")
    root = base / "data" / "mydata"
    root.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i in range(N):
        w, h = int(rng.integers(60, 240)), int(rng.integers(60, 240))
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        arr[: h // 2] = (41 * i) % 255
        Image.fromarray(arr).save(root / f"img_{i:02d}.jpg", quality=95)  # predict reads .jpg
    weights = base / "weights"
    weights.mkdir()
    params = jvit.init_vit_params(jvit.resolve_config(MODEL), jax.random.key(9))
    jweights.save_params_npz(str(weights / "SigLIP-Test-tiny.npz"), params)
    jroot = base / "jax_data" / "mydata"
    shutil.copytree(root, jroot)
    port_embed_main(["--root_dir", str(root), "--models_to_use", MODEL, "--device", "cpu",
                     "--model_path", str(weights), "--batch_size", "4",
                     "--num_workers", "2", "--canvas_size", "256"])
    return base, root, jroot, weights


def test_siglip_cli_store_matches_jax_embed(embedded):
    """The port's CLI (SigLIP normalization, MAP head, int8_static) writes a
    store the JAX package reads, with rows within the int8_static budget of a
    JAX embed of the same files, weights and calibration file."""
    _base, root, jroot, weights = embedded
    assert os.path.exists(root / "SigLIP-Test-tiny.calib.npz")
    shutil.copy(root / "SigLIP-Test-tiny.calib.npz", jroot / "SigLIP-Test-tiny.calib.npz")
    cfg = EmbedConfig(models_to_use=(MODEL,), batch_size=4, num_workers=2, canvas_size=256,
                      model_path=str(weights), compute_dtype="int8_static",
                      shuffle_filenames=False)
    jstore = jax_embed(str(jroot), cfg)[MODEL]
    pstore = JaxStore.open(str(root), MODEL)
    pe = np.asarray(pstore.embeddings, np.float32)
    assert pe.shape == (N, 4, 64) and np.asarray(pstore.valid).all()
    je = np.asarray(jstore.embeddings, np.float32)
    for i, u in enumerate(pstore.uuids):
        cos = np.sum(pe[i] * je[jstore.index_of(u)], axis=-1)
        assert np.all(cos >= 1 - 2e-3), f"{u}: cosine {cos}"


def test_jax_train_and_predict_read_siglip_output(embedded):
    base, root, _jroot, _w = embedded
    db = LabelDatabase.load_or_create(str(root))
    uuids = sorted(f[:-4] for f in os.listdir(root) if f.endswith(".jpg"))
    for i, u in enumerate(uuids[:5]):
        db.relabel(u, (i % 3) / 3.0)
    db.save()
    crops = ["centre_crop", "square_padded_crop"]
    feats, labels, models = load_training_data(str(base / "data"), ["mydata"], ["all"],
                                               crops, False)
    assert models == [MODEL] and feats.shape == (5, 128)
    cfg = TrainConfig(crop_names=tuple(crops), n_epochs=3, batch_size=2,
                      test_fraction=0.25, hidden_sizes=(8,), dropout_prob=0.0)
    model, history = train_regressor(feats, labels, cfg, models, plot_dir=str(base),
                                     verbose=False)
    assert np.isfinite(history["train"]).all()
    path = save_model(model, history, cfg, out_dir=str(base / "models"))
    assert predict_labels(str(root), path, batch_size=4, copy_imgs_fraction=0.0) == N
