"""The port's parallel layer (``clip_assisted_data_labeling_tpu_torch/parallel``)
against the JAX package's on the CPU: the mesh, data-parallel prediction,
data-parallel embedding and the ring dedup. The port's meshes list the CPU
several times (``devices=[cpu] * n``: the shards run one after another);
the JAX side runs on its 8 virtual CPU devices, as its own tests do. Inputs
are numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from clip_assisted_data_labeling_tpu.models import convnext as jcnx
from clip_assisted_data_labeling_tpu.models import regressor as jreg
from clip_assisted_data_labeling_tpu.models import resnet as jrn
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import similarity as jsim
from clip_assisted_data_labeling_tpu.ops.quant import quantize_vit_params as jax_quantize
from clip_assisted_data_labeling_tpu.parallel import embed_sharded as jemb
from clip_assisted_data_labeling_tpu.parallel import mesh as jmesh
from clip_assisted_data_labeling_tpu.parallel.dedup_sharded import (
    find_duplicate_pairs_sharded as jax_sharded_pairs,
)
from clip_assisted_data_labeling_tpu.parallel.predict_sharded import (
    predict_sharded as jax_predict_sharded,
)
from clip_assisted_data_labeling_tpu_torch.models import regressor as treg
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
from clip_assisted_data_labeling_tpu_torch.models.encoders import load_calibration
from clip_assisted_data_labeling_tpu_torch.ops import similarity as tsim
from clip_assisted_data_labeling_tpu_torch.ops.crops import fused_crop_resize_normalize
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import (
    image_stats_batch,
    make_stat_params,
)
from clip_assisted_data_labeling_tpu_torch.parallel import mesh as tmesh
from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
    find_duplicate_pairs_sharded,
)
from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder
from clip_assisted_data_labeling_tpu_torch.parallel.predict_sharded import predict_sharded

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the suite's
    other workers, so these tests run on one (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int = 8) -> tmesh.Mesh:
    return tmesh.get_mesh(devices=[CPU] * n)


# ---- the mesh ----------------------------------------------------------------------

def test_get_mesh_needs_a_card_or_a_device_list():
    if torch.cuda.is_available():
        pytest.skip("a card is present: get_mesh() takes it")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.get_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.get_mesh_2d(1, 2)
    m = tmesh.get_mesh(devices=["cpu"] * 3)
    assert m.shape == {"data": 3} and m.size == 3 and not m.spans_processes
    m2 = tmesh.get_mesh_2d(2, 2, devices=[CPU] * 4)
    assert m2.shape == {"data": 2, "model": 2} and m2.local_devices("data") == [CPU, CPU]
    assert tmesh.get_global_mesh(devices=[CPU] * 2).shape == {"data": 2}
    assert tmesh.device_count() == 0


def test_multihost_init_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert tmesh.multihost_init() == (0, 1)
    assert tmesh.multihost_init() == (0, 1)  # safe to call twice
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="process count"):
        tmesh.multihost_init()


def test_collectives_and_shard_batch():
    x = torch.arange(24, dtype=torch.int32).reshape(6, 4)
    parts = tmesh.shard_batch(cpu_mesh(3), x)
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * 3
    assert torch.equal(tmesh.all_gather(parts, dim=0), x)
    assert torch.equal(tmesh.psum(parts), x[:2] + x[2:4] + x[4:])
    assert torch.equal(tmesh.pmax(parts), x[4:])
    rotated = tmesh.ring_shift(cpu_mesh(3), [(p,) for p in parts])
    assert [r[0][0, 0].item() for r in rotated] == [16, 0, 8]
    with pytest.raises(ValueError, match="split"):
        tmesh.shard_batch(cpu_mesh(4), x)
    assert len(tmesh.replicate(cpu_mesh(3), x)) == 3


# ---- data-parallel prediction -------------------------------------------------------

def _regressors(classification: bool = False):
    classes = (0.0, 2.0, 5.0) if classification else None
    meta = jreg.RegressorMeta(
        clip_models=("ViT-B-32/openai",), crop_names=("centre_crop",), input_size=24,
        hidden_sizes=(8,), output_size=3 if classification else 1, data_min=0.0,
        data_max=1.0, class_values=classes)
    jm = jreg.SimpleFCRegressor.create(jax.random.key(5), meta)
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jm.params]
    tm = treg.regressor_from_params(params, treg.RegressorMeta(**dataclasses.asdict(meta)), "cpu")
    return jm, tm, params


@pytest.mark.parametrize("n", [1, 8, 173])
def test_predict_sharded_matches_jax_and_single(rng, n):
    jm, tm, params = _regressors()
    x = rng.normal(0, 1, (n, 24)).astype(np.float32)
    got = predict_sharded(params, x, cpu_mesh(), wire="float32")
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_predict_sharded(jm.params, x, jmesh.get_mesh(),
                                                        wire="float32"), atol=1e-6)
    np.testing.assert_allclose(got, tm.predict(x, wire="float32"), atol=1e-6)


def test_predict_sharded_wires_chunks_and_classification(rng):
    jm, tm, params = _regressors()
    x = rng.normal(0, 1, (67, 24)).astype(np.float32)
    exact = tm.predict(x, wire="float32")
    got16 = predict_sharded(params, x, cpu_mesh(), batch_size=16, wire="float16")
    np.testing.assert_allclose(got16, exact, atol=2e-3)
    np.testing.assert_allclose(got16, jax_predict_sharded(jm.params, x, jmesh.get_mesh(),
                                                          batch_size=16, wire="float16"),
                               atol=1e-6)
    got8 = predict_sharded(params, x, cpu_mesh(), batch_size=16, wire="int8")
    np.testing.assert_allclose(got8, exact, atol=1e-2)
    assert np.abs(got8 - exact).mean() < 2e-3
    np.testing.assert_allclose(got8, tm.predict(x, wire="int8"), atol=1e-6)
    assert predict_sharded(params, x[:0], cpu_mesh()).shape == (0,)
    with pytest.raises(ValueError, match="wire"):
        predict_sharded(params, x, cpu_mesh(), wire="bf16")

    jc, tc, cparams = _regressors(classification=True)
    got = predict_sharded(cparams, x, cpu_mesh(3), wire="float32",
                          class_values=tc.meta.class_values)
    np.testing.assert_allclose(got, tc.predict(x, wire="float32"), atol=1e-6)
    np.testing.assert_allclose(got, jax_predict_sharded(
        jc.params, x, jmesh.get_mesh(), wire="float32",
        class_values=jc.meta.class_values), atol=1e-6)


# ---- data-parallel embedding --------------------------------------------------------

def _vit_params(name: str, seed: int) -> dict:
    cfg = jvit.resolve_config(name)
    return jax.tree.map(np.asarray, jvit.init_vit_params(cfg, jax.random.key(seed)))


def _single_embed(model, canvases, crop_params, cfg, dtype) -> np.ndarray:
    crops = fused_crop_resize_normalize(
        torch.from_numpy(canvases), torch.from_numpy(crop_params), out_size=cfg.image_size,
        parity=False, dtype=dtype, mean=cfg.norm_mean, std=cfg.norm_std)
    b, n = crops.shape[:2]
    return tvit.vit_encode_image(model, crops.reshape((b * n,) + crops.shape[2:]),
                                 dtype).reshape(b, n, -1).numpy()


@pytest.mark.parametrize("name,seed", [("ViT-Test/tiny", 0), ("SigLIP-Test/tiny", 1)])
def test_sharded_embed_f32_matches_jax_and_single(name, seed):
    params = _vit_params(name, seed)
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    canvases, crop_params = _example_batch(16, 128, tcfg.image_size, seed=3)
    ref = np.asarray(jemb.ShardedEmbedder(params, jcfg, jmesh.get_mesh(),
                                          compute_dtype=jnp.float32).embed(canvases, crop_params))
    emb = ShardedEmbedder(params, tcfg, cpu_mesh(), compute_dtype=torch.float32)
    got = emb.embed(canvases, crop_params).numpy()
    assert got.shape == (16, 4, tcfg.embed_dim)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    single = _single_embed(module_from_params(params, tcfg), canvases, crop_params, tcfg,
                           torch.float32)
    np.testing.assert_allclose(got, single, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        emb.embed(canvases[:6], crop_params[:6])


def test_sharded_embed_with_stats():
    params = _vit_params("ViT-Test/tiny", 0)
    tcfg = tvit.resolve_config("ViT-Test/tiny")
    canvases, crop_params = _example_batch(8, 128, tcfg.image_size, seed=4)
    stat_params = np.stack([make_stat_params(100 + 3 * i, 90, 128) for i in range(8)])
    emb, stats = ShardedEmbedder(params, tcfg, cpu_mesh(4)).embed(canvases, crop_params,
                                                                   stat_params)
    assert emb.shape == (8, 4, tcfg.embed_dim) and stats.shape == (8, 22)
    single = image_stats_batch(torch.from_numpy(canvases), torch.from_numpy(stat_params))
    assert torch.equal(stats, single)
    _, jstats = jemb.ShardedEmbedder(params, jvit.resolve_config("ViT-Test/tiny"),
                                     jmesh.get_mesh()).embed(canvases, crop_params, stat_params)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=1e-3, atol=1e-3)


def test_sharded_static_calibration_matches_jax(tmp_path):
    """int8_static on a 1-D mesh: the per-shard amax reduced by the
    elementwise max equals the calibration over the whole batch (within
    1e-2 of the JAX reduction over its sharded batch), the file carries the
    JAX format, and the embeddings stay within the int8_static budget."""
    name = "ViT-Test/tiny"
    qparams = jax.tree.map(np.asarray, jax_quantize(_vit_params(name, 1)))
    jcfg, tcfg = jvit.resolve_config(name), tvit.resolve_config(name)
    canvases, crop_params = _example_batch(8, 128, tcfg.image_size, seed=9)
    jpath, tpath = str(tmp_path / "j.calib.npz"), str(tmp_path / "t.calib.npz")
    jse = jemb.ShardedEmbedder(qparams, jcfg, jmesh.get_mesh(), calibration_path=jpath,
                               model_name=name)
    jse.calibrate_static(canvases, crop_params)
    ref = np.asarray(jse.embed(canvases, crop_params))
    tse = ShardedEmbedder(qparams, tcfg, cpu_mesh(), calibration_path=tpath, model_name=name)
    tse.calibrate_static(canvases, crop_params)
    assert tse.replicas[0].calibrated
    got = tse.embed(canvases, crop_params).numpy()
    jamax, tamax = load_calibration(jpath), load_calibration(tpath)
    assert str(tamax["_model_name"]) == name
    np.testing.assert_allclose(tamax["act_amax"], jamax["act_amax"], rtol=1e-2)
    # the int8_static budget in cosine: on these random weights the jitted
    # JAX forward and the same forward op by op differ by 2.2e-2 absolute
    # in bf16, so an absolute bound says nothing about the port
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3
    # the whole batch on one device calibrates to the same scales, and with
    # them embeds as the shards do
    single = module_from_params(qparams, tcfg)
    crops = fused_crop_resize_normalize(
        torch.from_numpy(canvases), torch.from_numpy(crop_params), out_size=tcfg.image_size,
        parity=False, dtype=torch.bfloat16)
    flat = crops.reshape((-1,) + crops.shape[2:])
    whole = tvit.vit_act_amax(single, flat, torch.bfloat16)
    np.testing.assert_array_equal(tamax["act_amax"], whole["act_amax"])
    tvit.attach_act_amax(single, whole)
    one = tvit.vit_encode_image(single, flat, torch.bfloat16).reshape(8, 4, -1).numpy()
    np.testing.assert_allclose(got, one, atol=1e-6)
    # a second embedder loads the file instead of calibrating
    again = ShardedEmbedder(qparams, tcfg, cpu_mesh(2), calibration_path=tpath, model_name=name)
    again.calibrate_static(canvases, crop_params)
    assert torch.equal(again.embed(canvases, crop_params), torch.from_numpy(got))
    with pytest.raises(ValueError, match="model_name"):
        ShardedEmbedder(qparams, tcfg, cpu_mesh(2), calibration_path=tpath)


@pytest.mark.parametrize("family", ["resnet", "convnext"])
def test_sharded_conv_towers_int8_static_match_jax(family):
    """The modified ResNet and ConvNeXt test towers, W8A8 with every 1x1
    (or pointwise) product quantized, calibrated over the shards and
    embedded data-parallel: within the int8_static budget of the JAX
    ShardedEmbedder on the same weights."""
    mod, cfg = (jrn, jrn.RN_TEST_TINY) if family == "resnet" else (jcnx, jcnx.CNX_TEST_TINY)
    init = jrn.init_rn_params if family == "resnet" else jcnx.init_cnx_params
    p = jax.tree.map(np.asarray, jax.jit(lambda k: init(cfg, k))(jax.random.key(0)))
    q = jrn.quantize_rn_params(p, min_mid=0) if family == "resnet" else jcnx.quantize_cnx_params(p)
    q = jax.tree.map(np.asarray, q)
    canvases, crop_params = _example_batch(8, 128, cfg.image_size, seed=1)
    jse = jemb.ShardedEmbedder(q, cfg, jmesh.get_mesh())
    jse.calibrate_static(canvases, crop_params)
    ref = np.asarray(jse.embed(canvases, crop_params))
    tcfg = tvit.resolve_config("RN-Test/openai" if family == "resnet" else "CNX-Test/x")
    tse = ShardedEmbedder(q, tcfg, cpu_mesh(4))
    tse.calibrate_static(canvases, crop_params)
    assert tse.replicas[0].calibrated
    got = tse.embed(canvases, crop_params).numpy()
    assert got.shape == ref.shape
    assert 1.0 - np.min(np.sum(got * ref, axis=-1)) <= 2e-3
    # a 2-D mesh runs a conv tower data-parallel over its data axis
    two_d = ShardedEmbedder(q, tcfg, tmesh.get_mesh_2d(2, 2, devices=[CPU] * 4))
    two_d.calibrate_static(canvases, crop_params)
    assert two_d.n_devices == 2
    np.testing.assert_allclose(two_d.embed(canvases, crop_params).numpy(), got, atol=1e-6)


# ---- the ring dedup -----------------------------------------------------------------

def _planted(rng, n, d, n_dupes, noise=0.01):
    emb = jsim.normalize_rows(rng.normal(0, 1, (n, d)).astype(np.float32))
    for _ in range(n_dupes):
        i = int(rng.integers(0, n - 1))
        j = int(rng.integers(i + 1, n))
        emb[j] = jsim.normalize_rows((emb[i] + rng.normal(0, noise, d))[None])[0]
    return emb


def _case(name):
    """(embeddings, kwargs, devices on the port's mesh) of each case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "cosine":  # N not a multiple of the mesh
        return _planted(rng, 203, 36, 12), dict(threshold=0.97), 8
    if name == "cosine_tiles":  # 3 x 3 tiles of 128 a ring step
        return _planted(rng, 600, 24, 20), dict(threshold=0.97, row_block=128), 2
    if name == "euclidean":  # metric > threshold: the most DISSIMILAR pairs
        return _planted(rng, 160, 32, 8), dict(threshold=1.62, sim_type="euclidean"), 3
    if name == "overflow":  # 40 copies of a row: 39 matches > max_per_row = 4
        emb = _planted(rng, 130, 16, 4)
        emb[50:90] = emb[49]
        return emb, dict(threshold=0.99, max_per_row=4), 8
    raise KeyError(name)


def _sorted(res):
    return sorted(zip(res.rows.tolist(), res.cols.tolist()))


def _assert_same(got, ref):
    assert _sorted(got) == _sorted(ref)
    np.testing.assert_array_equal(got.overflow_rows, ref.overflow_rows)
    order_g, order_r = np.lexsort((got.cols, got.rows)), np.lexsort((ref.cols, ref.rows))
    np.testing.assert_allclose(got.metrics[order_g], ref.metrics[order_r], atol=1e-6)


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("name", ["cosine", "cosine_tiles", "euclidean", "overflow"])
def test_sharded_dedup_matches_jax_and_single(name, wire):
    emb, kw, n_dev = _case(name)
    got = find_duplicate_pairs_sharded(emb, wire=wire, mesh=cpu_mesh(n_dev), **kw)
    assert len(got.rows) > 0
    jkw = {k: v for k, v in kw.items() if k != "row_block"}
    _assert_same(got, jax_sharded_pairs(emb, wire=wire, mesh=jmesh.get_mesh(), **jkw))
    _assert_same(got, tsim.find_duplicate_pairs(emb, wire=wire, device="cpu", **kw))
    if name == "overflow":
        assert len(got.overflow_rows) > 0  # k escalated, every pair recovered


@pytest.mark.parametrize("wire", ["int8", "fp16"])
def test_sharded_dedup_chunked_extraction_and_small_n(monkeypatch, wire):
    base = np.random.default_rng(7).normal(0, 1, (1, 24)).astype(np.float32)
    emb = base + np.random.default_rng(8).normal(0, 0.08, (150, 24)).astype(np.float32)
    whole = find_duplicate_pairs_sharded(emb, threshold=0.985, wire=wire, mesh=cpu_mesh(4))
    monkeypatch.setattr(tsim, "EXTRACT_BUDGET_ELEMS", 128 * 64)
    from clip_assisted_data_labeling_tpu_torch.parallel import dedup_sharded

    monkeypatch.setattr(dedup_sharded, "extract_chunk_size",
                        lambda tile, k: tsim.extract_chunk_size(64, k))
    chunked = find_duplicate_pairs_sharded(emb, threshold=0.985, wire=wire, mesh=cpu_mesh(4))
    assert len(np.unique(chunked.rows)) > 128  # more than one chunk
    _assert_same(chunked, whole)
    _assert_same(whole, jax_sharded_pairs(emb, threshold=0.985, wire=wire,
                                          mesh=jmesh.get_mesh()))
    for n in (0, 1):
        res = find_duplicate_pairs_sharded(emb[:n], wire=wire, mesh=cpu_mesh(2))
        assert res.rows.size == 0 and res.overflow_rows.size == 0
    with pytest.raises(ValueError, match="wire"):
        find_duplicate_pairs_sharded(emb, wire="bf16", mesh=cpu_mesh(2))
