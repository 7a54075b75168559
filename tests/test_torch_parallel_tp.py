"""Tensor parallelism in the port (``parallel/tp.py``, ``parallel/tp_static.py``)
on 2-D CPU meshes (``devices=[cpu] * n``) against the JAX package's on its
virtual CPU devices, and against the port's own single-device forward.

  * int8_static: for every tower of the JAX package's
    ``tests/test_tp_static.py`` the port's TP forward is ``torch.equal`` to
    its single-device forward with the same scales (the int32 partials sum
    before the one dequant), and within the int8_static limit (1 − cosine
    2e-3) of the JAX TP forward; the qkv reorder and the swiglu pairing are
    the JAX package's array for array, and each shard holds the slice the
    JAX placement gives its device;
  * float32, bfloat16 and dynamic int8 (the JAX package's GSPMD path,
    written out here): float32 within 2e-4 of the JAX 2-D run, bfloat16
    within 1 − cosine 1e-3; dynamic int8 within 1 − cosine 2e-3 of JAX and
    bit for bit the port's single-device generic block;
  * the refusals: a mesh without the model axis, uncalibrated params, and
    a post-norm tower in int8_static on a 2-D mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu.parallel import embed_sharded as jemb
from clip_assisted_data_labeling_tpu.parallel import mesh as jmesh
from clip_assisted_data_labeling_tpu.parallel import tp_static as jtps
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.models.clip_weights import (
    flatten_params,
    module_from_params,
)
from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
from clip_assisted_data_labeling_tpu_torch.parallel import mesh as tmesh
from clip_assisted_data_labeling_tpu_torch.parallel import tp as ttp
from clip_assisted_data_labeling_tpu_torch.parallel import tp_static as ttps
from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the suite's
    other workers, so these tests run on one (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TOWERS = ["ViT-Test/tiny", "CoCa-Test/tiny", "PE-Test/tiny", "SigLIP-Test/tiny",
          "CLIPA-Test/tiny", "EVA-Test-Wide/tiny"]


def mesh_2d(data: int, model: int) -> tmesh.Mesh:
    return tmesh.get_mesh_2d(data, model, devices=[CPU] * (data * model))


def _cos_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float(1.0 - np.min(np.sum(a * b, axis=-1)))


def _static(name: str, rng, wire: bool = False, seed: int = 0):
    """(cfg, JAX calibrated params as numpy, the port's module with the same
    leaves, inputs): random init, W8A8, act_amax (and qkv_amax with
    ``wire``) from the JAX calibration forward on two images."""
    cfg = jvit.resolve_config(name)
    q = jax_quantize(jvit.init_vit_params(cfg, jax.random.key(seed)))
    calib = jnp.asarray(rng.normal(0, 1, (2, cfg.image_size, cfg.image_size, 3)), jnp.float32)
    amax = jvit.vit_act_amax(q, calib, cfg, compute_dtype=jnp.float32)
    sites = {"act_amax": amax["act_amax"]} | ({"qkv_amax": amax["qkv_amax"]} if wire else {})
    sparams = jax.tree.map(np.asarray, jvit.attach_act_amax(q, sites))
    x = rng.normal(0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return cfg, sparams, module_from_params(sparams, tvit.resolve_config(name)), x


@pytest.mark.parametrize("name", TOWERS)
def test_tp_static_bit_identical_to_single_and_near_jax(name, rng, monkeypatch):
    cfg, sparams, model, x = _static(name, rng)
    tcfg = model.cfg
    lnk = tvit.block_route(model.blocks[0], tcfg, object() if tcfg.use_rope2d else None) == "lnk"
    # the lnk block's bf16 qkv fixes its dtype: it runs in bfloat16 only
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if lnk else (torch.float32, jnp.float32)
    xt = torch.from_numpy(x).to(tdt)
    single = tvit.vit_encode_image(model, xt, tdt)
    tpm = ttps.place_tp_static(model, mesh_2d(2, 2), tcfg)
    got = ttps.vit_encode_tp_static(tpm, xt, tdt)
    assert torch.equal(got, single)
    single_route, shard_route = ttps.tp_static_routes(tcfg, 2, wire=False, compute_dtype=tdt)
    assert single_route == shard_route
    if lnk:
        monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    mesh = jmesh.get_mesh_2d(2, 2)
    ref = np.asarray(jtps.vit_encode_tp_static(
        jtps.place_tp_static(sparams, mesh, cfg), jnp.asarray(x, jdt), cfg, mesh,
        compute_dtype=jdt, fused_attention=lnk))
    assert _cos_err(got.numpy(), ref) <= 2e-3


def test_tp_static_fused_attention_near_jax(rng, monkeypatch):
    """The JAX TP forward on its fused attention kernels (Pallas in interpret
    mode, routed at the shard's local shape): the port's TP forward, bit-equal
    to its single device, within the int8_static limit of it too."""
    cfg, sparams, model, x = _static("ViT-Test/tiny", rng)
    xt = torch.from_numpy(x)
    got = ttps.vit_encode_tp_static(ttps.place_tp_static(model, mesh_2d(2, 2), model.cfg), xt,
                                    torch.float32)
    assert torch.equal(got, tvit.vit_encode_image(model, xt, torch.float32))
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    mesh = jmesh.get_mesh_2d(2, 2)
    ref = np.asarray(jtps.vit_encode_tp_static(
        jtps.place_tp_static(sparams, mesh, cfg), jnp.asarray(x), cfg, mesh,
        compute_dtype=jnp.float32, fused_attention=True))
    assert _cos_err(got.numpy(), ref) <= 2e-3


def test_tp_static_int8_wire(rng, monkeypatch):
    """The int8 attention wire: the local qkv_amax slice folded into K3's
    channel scales at the local head count, the int8 output into the int32
    out-projection psum."""
    cfg, sparams, model, x = _static("ViT-Test/tiny", rng, wire=True)
    assert model.blocks[0].wire
    xt = torch.from_numpy(x)
    single = tvit.vit_encode_image(model, xt, torch.float32)
    tpm = ttps.place_tp_static(model, mesh_2d(2, 2), model.cfg)
    assert ttps.tp_static_routes(model.cfg, 2, wire=True) == ("wire/K3", "wire/K3")
    assert torch.equal(ttps.vit_encode_tp_static(tpm, xt, torch.float32), single)
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")
    mesh = jmesh.get_mesh_2d(2, 2)
    ref = np.asarray(jtps.vit_encode_tp_static(
        jtps.place_tp_static(sparams, mesh, cfg), jnp.asarray(x), cfg, mesh,
        compute_dtype=jnp.float32, fused_attention=True))
    assert _cos_err(single.numpy(), ref) <= 2e-3


def test_reorder_and_shards_match_jax(rng):
    """The qkv reorder (with the wire's qkv_amax) and EVA02's swiglu pairing
    are the JAX package's array for array, on numpy params and on the
    module; each shard's leaves are the slice the JAX TP_BLOCK_SPECS
    placement hands the device at (0, j)."""
    for name, wire in (("ViT-Test/tiny", True), ("EVA-Test-Wide/tiny", False)):
        cfg, sparams, model, _ = _static(name, rng, wire=wire)
        want = flatten_params(jax.tree.map(np.asarray, jtps.reorder_qkv_tp(sparams, cfg, 2)))
        for got in (ttps.reorder_qkv_tp(flatten_params(sparams), model.cfg, 2),
                    ttps.reorder_qkv_tp(model, model.cfg, 2)):
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=f"{name} {k}")
        mesh = jmesh.get_mesh_2d(2, 2)
        placed = jtps.place_tp_static(sparams, mesh, cfg)
        specs = ttps.tp_static_specs(want)
        for k, spec in specs.items():
            jleaf = placed["blocks"][k[len("blocks/"):]] if k.startswith("blocks/") else placed[k]
            assert spec == tuple(jtps.tp_static_specs(placed)["blocks"][k[7:]]
                                 if k.startswith("blocks/") else ()), k
            by_dev = {s.device: np.asarray(s.data) for s in jleaf.addressable_shards}
            for j in range(2):
                np.testing.assert_array_equal(
                    ttp.shard_leaf(k[7:], want[k], 2, j) if k.startswith("blocks/") else want[k],
                    by_dev[mesh.devices[0, j]], err_msg=f"{name} {k} shard {j}")


def test_reorder_swiglu_fc1_pairing(rng):
    cfg, sparams, model, _ = _static("EVA-Test-Wide/tiny", rng)
    k0 = np.asarray(sparams["blocks"]["fc1_kernel"])
    k2 = ttps.reorder_qkv_tp(model, model.cfg, 2)["blocks/fc1_kernel"]
    mlp = k0.shape[-1] // 2
    ml = mlp // 2
    for j in range(2):  # shard j holds [w1_j | w2_j]
        local = ttp.shard_leaf("fc1_kernel", k2, 2, j)
        np.testing.assert_array_equal(local[:, :, :ml], k0[:, :, j * ml:(j + 1) * ml])
        np.testing.assert_array_equal(local[:, :, ml:], k0[:, :, mlp + j * ml:mlp + (j + 1) * ml])
    with pytest.raises(ValueError, match="heads"):
        ttps.reorder_qkv_tp(model, model.cfg, 3)


def test_tp_static_refusals(rng):
    cfg = tvit.resolve_config("ViT-Test/tiny")
    qparams = jax.tree.map(np.asarray, jax_quantize(
        jvit.init_vit_params(jvit.resolve_config("ViT-Test/tiny"), jax.random.key(0))))
    tpm = ttps.place_tp_static(module_from_params(qparams, cfg), mesh_2d(2, 2), cfg)
    with pytest.raises(ValueError, match="act_amax"):
        ttps.vit_encode_tp_static(tpm, torch.zeros(4, 32, 32, 3), torch.float32)
    with pytest.raises(ValueError, match="model"):
        ttp.apply_tp_sharding(module_from_params(qparams, cfg),
                              tmesh.get_mesh(devices=[CPU] * 2))
    post = tvit.resolve_config("EVA-Test-Post/tiny")
    pq = jax.tree.map(np.asarray, jax_quantize(
        jvit.init_vit_params(jvit.resolve_config("EVA-Test-Post/tiny"), jax.random.key(0))))
    canvases, crop_params = _example_batch(4, 128, post.image_size, seed=2)
    emb = ShardedEmbedder(pq, post, mesh_2d(2, 2))
    with pytest.raises(ValueError, match="post-norm towers has no tensor-parallel"):
        emb.calibrate_static(canvases, crop_params)
    # a 1-D mesh takes the post-norm tower data-parallel
    one_d = ShardedEmbedder(pq, post, tmesh.get_mesh(devices=[CPU] * 2))
    one_d.calibrate_static(canvases, crop_params)
    assert one_d.embed(canvases, crop_params).shape == (4, 4, post.embed_dim)


def test_sharded_embedder_tp_static_pipeline(rng, tmp_path):
    """A 2-D ShardedEmbedder in int8_static switches to the explicit TP
    program after calibration and gives exactly the single-device static
    embeddings with the persisted scales."""
    name = "ViT-Test/tiny"
    cfg = tvit.resolve_config(name)
    qparams = jax.tree.map(np.asarray, jax_quantize(
        jvit.init_vit_params(jvit.resolve_config(name), jax.random.key(0))))
    canvases, crop_params = _example_batch(4, 128, cfg.image_size)
    path = str(tmp_path / "tiny.calib.npz")
    emb = ShardedEmbedder(qparams, cfg, mesh_2d(2, 2), calibration_path=path, model_name=name)
    emb.calibrate_static(canvases, crop_params)
    assert emb._tp_static
    got = emb.embed(canvases, crop_params)
    single = ShardedEmbedder(qparams, cfg, tmesh.get_mesh(devices=[CPU]), calibration_path=path,
                             model_name=name)
    single.calibrate_static(canvases, crop_params)  # loads the file
    assert torch.equal(got, single.embed(canvases, crop_params))


@pytest.mark.parametrize("name", ["ViT-Test/tiny", "EVA-Test-Wide/tiny"])
def test_tp_float_matches_jax_and_single(name, rng):
    """The tower on the same images in both packages (the JAX GSPMD forward
    on its TP-placed params), and the port's 2-D ShardedEmbedder end to end
    against its one-device run. (End to end against JAX the fast
    preprocess's bf16 resampling alone moves a crop by up to 2.7e-4.)"""
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    params = jax.tree.map(np.asarray, jvit.init_vit_params(jcfg, jax.random.key(2)))
    x = rng.normal(0, 1, (8, tcfg.image_size, tcfg.image_size, 3)).astype(np.float32)
    canvases, crop_params = _example_batch(8, 128, tcfg.image_size, seed=5)
    tp = ttp.apply_tp_sharding(module_from_params(params, tcfg), mesh_2d(4, 2))
    assert tp.heads_local == tcfg.heads // 2
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jse = jemb.ShardedEmbedder(params, jcfg, jmesh.get_mesh_2d(4, 2), compute_dtype=jdt)
        fwd = jax.jit(lambda p, im: jvit.vit_encode_image(p, im, jcfg, compute_dtype=jdt))
        ref = np.asarray(fwd(jse.params, jax.device_put(jnp.asarray(x, jdt), jse._data)))
        got = ttp.vit_encode_tp(tp, torch.from_numpy(x).to(tdt), tdt).numpy()
        emb = ShardedEmbedder(params, tcfg, mesh_2d(4, 2), compute_dtype=tdt)
        assert not emb._dp_only
        e2e = emb.embed(canvases, crop_params).numpy()
        one = ShardedEmbedder(params, tcfg, tmesh.get_mesh(devices=[CPU]),
                              compute_dtype=tdt).embed(canvases, crop_params).numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, ref, atol=2e-4)
            np.testing.assert_allclose(e2e, one, atol=2e-6)
        else:
            assert _cos_err(got, ref) <= 1e-3 and _cos_err(e2e, one) <= 1e-3


def test_tp_dynamic_int8(rng):
    """Dynamic int8 over the model shards: within the int8 budget of the JAX
    2-D run, and bit for bit the port's single-device generic block (the row
    scale of a row-parallel input is the pmax of the shards' row amax)."""
    name = "ViT-Test/tiny"
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    qparams = jax.tree.map(np.asarray, jax_quantize(
        jvit.init_vit_params(jcfg, jax.random.key(4))))
    canvases, crop_params = _example_batch(8, 128, tcfg.image_size, seed=6)
    ref = np.asarray(jemb.ShardedEmbedder(qparams, jcfg, jmesh.get_mesh_2d(4, 2))
                     .embed(canvases, crop_params))
    got = ShardedEmbedder(qparams, tcfg, mesh_2d(4, 2)).embed(canvases, crop_params)
    one = ShardedEmbedder(qparams, tcfg, tmesh.get_mesh(devices=[CPU])).embed(canvases,
                                                                              crop_params)
    assert torch.equal(got, one)
    assert _cos_err(got.numpy(), ref) <= 2e-3
    # EVA02 has no dynamic-int8 block: the encoder runs it in bfloat16
    enc = CLIPImageEncoder("EVA-Test/tiny", compute_dtype="int8", device="cpu")
    assert not enc.quantized and enc.compute_dtype == torch.bfloat16
    eva = ShardedEmbedder(enc.model, enc.cfg, mesh_2d(2, 2), compute_dtype=torch.bfloat16)
    c4, p4 = _example_batch(4, 128, enc.cfg.image_size, seed=7)
    one = ShardedEmbedder(enc.model, enc.cfg, tmesh.get_mesh(devices=[CPU]),
                          compute_dtype=torch.bfloat16)
    assert _cos_err(eva.embed(c4, p4).numpy(), one.embed(c4, p4).numpy()) <= 1e-3


MATRIX_TOWERS = ["ViT-Test/tiny", "SigLIP-Test/tiny", "PE-Test/tiny", "EVA-Test-Wide/tiny",
                 "EVA-Test-Post/tiny", "CoCa-Test/tiny", "CLIPA-Test/tiny", "RN-Test/openai",
                 "CNX-Test/x"]


@pytest.mark.parametrize("layout", ["dp", "tp"])
@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int8_static"])
@pytest.mark.parametrize("name", MATRIX_TOWERS)
def test_family_mode_mesh_matrix(name, mode, layout):
    """Every family x compute mode x mesh layout through ShardedEmbedder,
    from the encoder the embed stage builds (with its downgrades): each cell
    matches the one-device run of the same weights, or raises its pinned
    refusal (a post-norm tower in int8_static on a 2-D mesh); a conv tower
    runs data-parallel on either mesh."""
    enc = CLIPImageEncoder(name, compute_dtype=mode, device="cpu")
    canvases, crop_params = _example_batch(4, 96, enc.cfg.image_size, seed=11)
    mesh = (tmesh.get_mesh(devices=[CPU] * 2) if layout == "dp" else mesh_2d(2, 2))
    one = ShardedEmbedder(enc.model, enc.cfg, tmesh.get_mesh(devices=[CPU]),
                          compute_dtype=enc.compute_dtype)
    emb = ShardedEmbedder(enc.model, enc.cfg, mesh, compute_dtype=enc.compute_dtype)
    if enc.static_quant:
        one.calibrate_static(canvases, crop_params)
        if layout == "tp" and getattr(enc.cfg, "block_norm", "pre") == "post":
            with pytest.raises(ValueError, match="post-norm"):
                emb.calibrate_static(canvases, crop_params)
            return
        emb.calibrate_static(canvases, crop_params)
    ref = one.embed(canvases, crop_params)
    got = emb.embed(canvases, crop_params)
    assert got.shape == ref.shape == (4, 4, enc.cfg.embed_dim)
    assert torch.isfinite(got).all()
    if enc.quantized:
        # the int8 products are exact, and every TP route here is the single
        # device's: the static and dynamic TP forwards are the single one's bits
        assert torch.equal(got, ref)
    else:
        assert _cos_err(got.numpy(), ref.numpy()) <= 1e-3
