"""The port's PE (Perception Encoder) towers against the JAX package's: the
RoPE tables, the tower forward in float32, bfloat16 and int8_static (the
JAX fused paths with RoPE inside the Pallas kernels, run in interpret mode),
the calibration forward with RoPE, the Meta-layout checkpoint converter, the
``rope_half`` leaf through ``.npz`` both ways and the legacy upgrade, the
int8-wire gates, and the embed CLI's output read by the JAX package's train
and predict stages. Weights come from the JAX params; inputs are numpy from a
seed."""
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
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main

PE_NAMES = ["PE-Core-B16-224", "PE-Core-L14-336", "PE-Core-G14-448", "PE-Test/tiny"]
FIELDS = ("width", "layers", "heads", "patch_size", "image_size", "embed_dim", "mlp_dim",
          "act", "ln_eps", "use_cls_token", "use_rope2d", "rope_theta", "pool",
          "attn_pooler_heads", "use_ln_pre", "use_proj", "patch_bias", "norm_mean",
          "norm_std", "seq_len", "grid", "head_dim")
# width 128 takes the JAX package's fused int8_static lnk path (RoPE inside
# its attention kernel); head dim 64 as in PE-Core-L14-336
WIDE = dict(width=128, layers=2, heads=2, patch_size=8, image_size=32, embed_dim=32,
            act="gelu", use_rope2d=True, pool="attn", attn_pooler_heads=2)


def _cfgs(name):
    """(JAX config, port config) of a registered name or of the width-128
    test tower, 'wide-cls' or 'wide-nocls'."""
    if name.startswith("wide"):
        cls = name == "wide-cls"
        return (jvit.VitConfig(**WIDE, use_cls_token=cls),
                tvit.VitConfig(**WIDE, use_cls_token=cls))
    return jvit.resolve_config(name), tvit.resolve_config(name)


def _cos_err(a, b):
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


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


def _jax_encode(params, x, cfg, dtype, monkeypatch):
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    out = jvit.vit_encode_image(params, jnp.asarray(x), cfg, compute_dtype=dtype,
                                fused_attention=True)
    monkeypatch.delenv("CTPU_PALLAS_INTERPRET")
    return np.asarray(out)


@pytest.mark.parametrize("name", PE_NAMES)
def test_pe_config_matches_jax(name):
    j, t = _cfgs(name)
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}
    with pytest.raises(ValueError, match="Unknown model format"):
        tvit.resolve_config(name + "/somewhere")  # PE names take no pretrained tag


@pytest.mark.parametrize("grid,d,theta,cls", [
    (24, 64, 10000.0, True),   # PE-Core-L14-336: S = 577
    (32, 96, 10000.0, False),  # PE-Core-G14-448: S = 1024, no cls row
    (14, 64, 10000.0, True),   # PE-Core-B16-224
    (4, 16, 10000.0, False),   # PE-Test/tiny
    (4, 64, 500.0, True),
])
def test_rope2d_tables_bit_equal(grid, d, theta, cls):
    got, ref = tvit._rope2d_tables(grid, d, theta, cls), jvit._rope2d_tables(grid, d, theta, cls)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == (grid * grid + cls, d // 2)
        np.testing.assert_array_equal(g, r)
    if cls:  # the cls row: identity rotation
        assert (got[0][0] == 1).all() and (got[1][0] == 0).all()


def test_pe_l14_resolves_with_the_main_path_shapes():
    cfg = tvit.resolve_config("PE-Core-L14-336")
    assert (cfg.seq_len, cfg.width, cfg.heads, cfg.head_dim, cfg.mlp_dim, cfg.embed_dim,
            cfg.layers) == (577, 1024, 16, 64, 4096, 1024, 24)
    cos, sin = tvit._rope_on(cfg, torch.device("cpu"))
    assert cos.shape == sin.shape == (577, 32) and cos.dtype == torch.float32


@pytest.mark.parametrize("tdtype,jdtype,limit", [
    (torch.float32, jnp.float32, 1e-5),
    (torch.bfloat16, jnp.bfloat16, 1e-3),
])
@pytest.mark.parametrize("name", ["PE-Test/tiny", "wide-cls", "wide-nocls"])
def test_pe_encode_matches_jax(rng, monkeypatch, name, tdtype, jdtype, limit):
    jcfg, tcfg = _cfgs(name)
    params = _np_params(jcfg, rng, seed=5)
    x = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = _jax_encode(params, x, jcfg, jdtype, monkeypatch)
    got = tvit.vit_encode_image(tweights.module_from_params(params, tcfg),
                                torch.from_numpy(x), tdtype).numpy()
    assert got.shape == (3, tcfg.embed_dim) and np.isfinite(got).all()
    assert _cos_err(got, ref) < limit


@pytest.mark.parametrize("name", ["wide-cls", "wide-nocls"])
def test_pe_int8_static_and_calibration_match_jax(rng, monkeypatch, name):
    """The calibration forward with RoPE (XLA form: unscaled q and k rotated),
    then the same act_amax into both lnk paths (the JAX one with RoPE inside
    its Pallas kernel, interpret mode; the port's K2 and K1 plain versions).
    float32 is held against the jitted JAX function at every site. In bf16
    the jitted JAX run itself differs from the op-by-op one (XLA leaves some
    bf16 sums unrounded under jit: up to 1.1% in act_amax, 3% in qkv_amax on
    these towers), so the port, which computes the JAX code op by op, is held
    against the op-by-op run: act_amax within 1e-2 (seen: equal), qkv_amax
    within one bf16 ulp (a float32 sum taken in another order can move a
    channel's amax by one)."""
    jcfg, tcfg = _cfgs(name)
    params = _np_params(jcfg, rng, seed=6)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    qparams = jax_quantize(params)
    model = tweights.module_from_params(quantize_vit_params(tweights.flatten_params(params)),
                                        tcfg)
    jamax = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                       compute_dtype=jnp.float32))
    tamax = tvit.vit_act_amax(model, torch.from_numpy(x), torch.float32)
    for k in ("act_amax", "qkv_amax"):
        assert tamax[k].shape == jamax[k].shape
        np.testing.assert_allclose(tamax[k], jamax[k], rtol=1e-2, err_msg=f"float32 {k}")
    with jax.disable_jit():
        eager = jax.tree.map(np.asarray, jvit.vit_act_amax(qparams, jnp.asarray(x), jcfg,
                                                           compute_dtype=jnp.bfloat16))
    tamax = tvit.vit_act_amax(model, torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_allclose(tamax["act_amax"], eager["act_amax"], rtol=1e-2)
    np.testing.assert_allclose(tamax["qkv_amax"], eager["qkv_amax"], rtol=2.0 ** -6)

    amax = {"act_amax": eager["act_amax"]}
    ref = _jax_encode(jvit.attach_act_amax(qparams, amax), x, jcfg, jnp.bfloat16, monkeypatch)
    tvit.attach_act_amax(model, amax)
    got = tvit.vit_encode_image(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos_err(got, ref) <= 2e-3  # the int8_static budget


def test_wire_gates_keep_rope_towers_off_the_wire(rng, monkeypatch):
    """int8_wire_enabled is off for every RoPE tower (as in the JAX package),
    and a wire forced onto a RoPE tower's blocks still runs the lnk path
    (K3 has no rotation)."""
    for name in PE_NAMES:
        j, t = _cfgs(name)
        assert tvit.int8_wire_enabled(t) is False and jvit.int8_wire_enabled(j) is False
    # the same geometry without RoPE would take the wire where SO400M does
    assert tvit.int8_wire_enabled(tvit.resolve_config("ViT-SO400M-14-SigLIP-384/webli"))
    _, tcfg = _cfgs("wide-cls")
    assert tvit.int8_wire_enabled(tcfg, wire=True) is True  # forcing still forces the flag
    params = quantize_vit_params(tweights.flatten_params(_np_params(_cfgs("wide-cls")[0], rng, 7)))
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    plain = tweights.module_from_params(params, tcfg)
    amax = tvit.vit_act_amax(plain, x)
    tvit.attach_act_amax(plain, amax)
    wired = tweights.module_from_params(params, tcfg)
    tvit.attach_act_amax(wired, amax, wire=True)
    assert all(b.wire for b in wired.blocks)

    def no_wire(*a, **k):
        raise AssertionError("the int8 wire ran on a RoPE tower")

    monkeypatch.setattr(tvit, "_block_int8_static_wire", no_wire)
    got = tvit.vit_encode_image(wired, x, torch.bfloat16)
    assert torch.equal(got, tvit.vit_encode_image(plain, x, torch.bfloat16))


def _pe_state_dict(cfg, rng, prefix="visual."):
    """A synthetic Meta PE 'visual.*' state dict (torch layout: CLIP's
    transformer naming, the attn_pool head, no class token without cls)."""
    w, p, mlp = cfg.width, cfg.patch_size, cfg.mlp_dim

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {
        "conv1.weight": t(w, 3, p, p), "positional_embedding": t(cfg.seq_len, w),
        "ln_pre.weight": t(w), "ln_pre.bias": t(w), "ln_post.weight": t(w),
        "ln_post.bias": t(w), "proj": t(w, cfg.embed_dim),
        "attn_pool.probe": t(1, 1, w),
        "attn_pool.attn.in_proj_weight": t(3 * w, w), "attn_pool.attn.in_proj_bias": t(3 * w),
        "attn_pool.attn.out_proj.weight": t(w, w), "attn_pool.attn.out_proj.bias": t(w),
        "attn_pool.layernorm.weight": t(w), "attn_pool.layernorm.bias": t(w),
    }
    if cfg.use_cls_token:
        sd["class_embedding"] = t(w)
    for i in range(cfg.layers):
        b = f"transformer.resblocks.{i}."
        for n in ("ln_1", "ln_2"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = t(w), t(w)
        sd[b + "attn.in_proj_weight"], sd[b + "attn.in_proj_bias"] = t(3 * w, w), t(3 * w)
        sd[b + "attn.out_proj.weight"], sd[b + "attn.out_proj.bias"] = t(w, w), t(w)
        sd[b + "mlp.c_fc.weight"], sd[b + "mlp.c_fc.bias"] = t(mlp, w), t(mlp)
        sd[b + "mlp.c_proj.weight"], sd[b + "mlp.c_proj.bias"] = t(w, mlp), t(w)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("name,prefix", [("PE-Test/tiny", "visual."), ("wide-cls", ""),
                                         ("wide-nocls", "visual.")])
def test_convert_pe_visual_matches_jax(rng, name, prefix):
    jcfg, tcfg = _cfgs(name)
    sd = _pe_state_dict(tcfg, rng, prefix)
    got = tweights.convert_torch_state_dict(sd, tcfg)  # dispatches on attn_pool.*
    ref = tweights.flatten_params(jax.tree.map(
        np.asarray, jweights.convert_torch_state_dict(sd, jcfg)))
    assert set(got) == set(ref) and "rope_half" in got
    assert ("class_emb" in got) == tcfg.use_cls_token
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    tweights.module_from_params(got, tcfg)  # every leaf the tower needs


def test_rope_half_leaf_through_npz_both_ways(tmp_path):
    name = "PE-Test/tiny"
    jcfg, tcfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(0)))
    jpath = str(tmp_path / "j.npz")
    jweights.save_params_npz(jpath, params)
    model = tweights.module_from_params(tweights.load_params_npz(jpath), tcfg)
    assert model.rope_half.dtype == torch.int8 and model.rope_half.item() == 1
    tpath = str(tmp_path / "t.npz")
    tweights.save_params_npz(tpath, tweights.params_from_module(model))
    back = tweights.flatten_params(jweights.load_params_npz(tpath))
    flat = tweights.flatten_params(params)
    assert set(back) == set(flat)
    for k, v in back.items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    # the port's own random init carries the same leaves
    got = tvit.init_vit_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in flat.items()}


@pytest.mark.parametrize("quantized", [False, True])
def test_legacy_npz_without_rope_half_is_upgraded(rng, tmp_path, quantized):
    """A checkpoint saved before the marker (interleaved q/k columns, no
    rope_half) is permuted on load exactly as the JAX package permutes it —
    with a quantized one's per-column scales and a calibrated one's qkv_amax
    following the columns."""
    name = "PE-Test/tiny"
    jcfg, tcfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(1)))
    params.pop("rope_half")
    params["blocks"]["qkv_bias"] = rng.normal(0, 0.1, params["blocks"]["qkv_bias"].shape
                                              ).astype(np.float32)
    if quantized:
        params = jax.tree.map(np.asarray, jax_quantize(params))
        params["blocks"]["qkv_amax"] = rng.random((jcfg.layers, 3 * jcfg.width)).astype(
            np.float32)
    path = str(tmp_path / "PE-Test-tiny.npz")
    jweights.save_params_npz(path, params)
    ref = tweights.flatten_params(jax.tree.map(np.asarray, jweights.ensure_rope_half(
        jweights.load_params_npz(path), jcfg)))
    got = tweights.flatten_params(tenc.CLIPImageEncoder(
        name, model_path=path, compute_dtype="float32", device="cpu")._load_params(path))
    assert set(got) == set(ref) and "rope_half" in got
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    # marked params are left alone
    assert tweights.ensure_rope_half(got, tcfg) is got
    with pytest.raises(KeyError, match="rope_half"):  # unmarked params are refused
        tweights.module_from_params(tweights.flatten_params(params), tcfg)


@pytest.mark.parametrize("with_qkv_amax", [True, False])
def test_pe_calibration_file_attaches_no_wire(rng, tmp_path, with_qkv_amax):
    """A PE .calib.npz loads with or without qkv_amax (the wire is off for
    RoPE towers, so only act_amax is attached), whichever package wrote it."""
    name = "PE-Test/tiny"
    jcfg, tcfg = _cfgs(name)
    amax = {"act_amax": rng.random((tcfg.layers, 4)).astype(np.float32) + 0.5}
    if with_qkv_amax:
        amax["qkv_amax"] = rng.random((tcfg.layers, 3 * tcfg.width)).astype(np.float32)
    for writer in (tenc, jenc):
        path = writer.calibration_file(name, str(tmp_path))
        writer.save_calibration(path, amax, name)
        enc = tenc.CLIPImageEncoder(name, compute_dtype="int8_static", calibration_path=path,
                                    device="cpu")
        assert not enc.wire and enc.load_calibration() and enc.model.calibrated
        assert not any(b.wire for b in enc.model.blocks)
        np.testing.assert_array_equal(enc.model.blocks[1].act_amax.numpy(),
                                      amax["act_amax"][1] * np.float32(1.1))
        jenc.check_calibration(jenc.load_calibration(path), jcfg, path, name)


MODEL = "PE-Test/tiny"
N = 6


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_pe_e2e")
    root = base / "data" / "mydata"
    root.mkdir(parents=True)
    rng = np.random.default_rng(13)
    for i in range(N):
        w, h = int(rng.integers(60, 240)), int(rng.integers(60, 240))
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        arr[: h // 2] = (37 * i) % 255
        Image.fromarray(arr).save(root / f"img_{i:02d}.jpg", quality=95)  # predict reads .jpg
    weights = base / "weights"
    weights.mkdir()
    params = jvit.init_vit_params(jvit.resolve_config(MODEL), jax.random.key(4))
    jweights.save_params_npz(str(weights / "PE-Test-tiny.npz"), params)
    jroot = base / "jax_data" / "mydata"
    shutil.copytree(root, jroot)
    port_embed_main(["--root_dir", str(root), "--models_to_use", MODEL, "--device", "cpu",
                     "--model_path", str(weights), "--batch_size", "4",
                     "--num_workers", "2", "--canvas_size", "256"])
    return base, root, jroot, weights


def test_pe_cli_store_matches_jax_embed(embedded):
    """The port's CLI (RoPE, attention pool, int8_static) writes sidecars, a
    store and a calibration file the JAX package reads, with rows within the
    int8_static budget of a JAX embed of the same files, weights and
    calibration."""
    _base, root, jroot, weights = embedded
    calib = root / "PE-Test-tiny.calib.npz"
    assert calib.exists() and len(list(root.glob("*.pt"))) == N
    with np.load(calib) as f:
        assert f["act_amax"].shape == (2, 4)
    shutil.copy(calib, jroot / calib.name)
    cfg = EmbedConfig(models_to_use=(MODEL,), batch_size=4, num_workers=2, canvas_size=256,
                      model_path=str(weights), compute_dtype="int8_static",
                      shuffle_filenames=False)
    jstore = jax_embed(str(jroot), cfg)[MODEL]
    pstore = JaxStore.open(str(root), MODEL)
    pe = np.asarray(pstore.embeddings, np.float32)
    assert pe.shape == (N, 4, 16) and np.asarray(pstore.valid).all()
    je = np.asarray(jstore.embeddings, np.float32)
    for i, u in enumerate(pstore.uuids):
        cos = np.sum(pe[i] * je[jstore.index_of(u)], axis=-1)
        assert np.all(cos >= 1 - 2e-3), f"{u}: cosine {cos}"


def test_jax_train_and_predict_read_pe_output(embedded):
    base, root, _jroot, _w = embedded
    db = LabelDatabase.load_or_create(str(root))
    uuids = sorted(f[:-4] for f in os.listdir(root) if f.endswith(".jpg"))
    for i, u in enumerate(uuids[:5]):
        db.relabel(u, (i % 3) / 3.0)
    db.save()
    crops = ["centre_crop", "square_padded_crop"]
    feats, labels, models = load_training_data(str(base / "data"), ["mydata"], ["all"],
                                               crops, False)
    assert models == [MODEL] and feats.shape == (5, 32)
    cfg = TrainConfig(crop_names=tuple(crops), n_epochs=3, batch_size=2,
                      test_fraction=0.25, hidden_sizes=(8,), dropout_prob=0.0)
    model, history = train_regressor(feats, labels, cfg, models, plot_dir=str(base),
                                     verbose=False)
    assert np.isfinite(history["train"]).all()
    path = save_model(model, history, cfg, out_dir=str(base / "models"))
    assert predict_labels(str(root), path, batch_size=4, copy_imgs_fraction=0.0) == N
