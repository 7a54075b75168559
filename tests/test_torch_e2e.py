"""End to end: the port's embed CLI on the CPU (ViT-Test/tiny, weights from
a JAX-written .npz, int8_static), its outputs read by the JAX package's
train and predict stages, and its store rows against a JAX embed of the same
files with the same weights and the same calibration file; and the CLI in
dynamic int8, whose outputs (no calibration file) the JAX stages read too."""
import os
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

from clip_assisted_data_labeling_tpu.config import EmbedConfig, TrainConfig
from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.pipeline.embed import embed_dataset as jax_embed
from clip_assisted_data_labeling_tpu.pipeline.predict import predict_labels
from clip_assisted_data_labeling_tpu.pipeline.train import (
    load_training_data,
    save_model,
    train_regressor,
)
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu.store.sidecar import read_sidecar
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main

MODEL = "ViT-Test/tiny"
N = 8


def _dataset(base):
    """N distinguishable JPEGs under base/data/mydata and JAX-initialized
    weights under base/weights; returns (root, weights)."""
    root = base / "data" / "mydata"
    root.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(N):
        w, h = int(rng.integers(60, 240)), int(rng.integers(60, 240))
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        arr[:, : w // 2] = (37 * i) % 255  # distinguishable images
        Image.fromarray(arr).save(root / f"img_{i:02d}.jpg", quality=95)
    weights = base / "weights"
    weights.mkdir()
    params = jvit.init_vit_params(jvit.resolve_config(MODEL), jax.random.key(7))
    jweights.save_params_npz(str(weights / "ViT-Test-tiny.npz"), params)
    return root, weights


def _port_embed(root, weights, *extra):
    port_embed_main(["--root_dir", str(root), "--models_to_use", MODEL, "--device", "cpu",
                     "--model_path", str(weights), "--batch_size", "4",
                     "--num_workers", "2", "--canvas_size", "256", *extra])


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_e2e")
    root, weights = _dataset(base)
    # a clean copy of the images for the JAX embed (before the port writes)
    jroot = base / "jax_data" / "mydata"
    shutil.copytree(root, jroot)
    _port_embed(root, weights)
    return base, root, jroot, weights


def test_port_cli_outputs(embedded):
    _base, root, _jroot, _w = embedded
    pts = sorted(f for f in os.listdir(root) if f.endswith(".pt"))
    assert len(pts) == N
    assert os.path.exists(root / "ViT-Test-tiny.calib.npz")
    d = read_sidecar(str(root / pts[0]))[MODEL]
    assert d["centre_crop"].shape == (1, 16) and "img_stat_laplacian_variance" in d
    store = JaxStore.open(str(root), MODEL)
    emb = np.asarray(store.embeddings, np.float32)
    assert emb.shape == (N, 4, 16) and np.asarray(store.valid).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=2e-3)
    row = store.index_of(pts[0][:-3])
    np.testing.assert_allclose(emb[row, 0], d["centre_crop"].reshape(-1), atol=2e-3)


def test_store_rows_match_jax_embed(embedded):
    _base, root, jroot, weights = embedded
    # the JAX embed reads the port's calibration file (same act_amax)
    shutil.copy(root / "ViT-Test-tiny.calib.npz", jroot / "ViT-Test-tiny.calib.npz")
    cfg = EmbedConfig(models_to_use=(MODEL,), batch_size=4, num_workers=2,
                      canvas_size=256, model_path=str(weights),
                      compute_dtype="int8_static", shuffle_filenames=False)
    jstore = jax_embed(str(jroot), cfg)[MODEL]
    pstore = JaxStore.open(str(root), MODEL)
    pe = np.asarray(pstore.embeddings, np.float32)
    je = np.asarray(jstore.embeddings, np.float32)
    for i, u in enumerate(pstore.uuids):
        cos = np.sum(pe[i] * je[jstore.index_of(u)], axis=-1)
        # both packages run the generic block with static scales at width 64
        # (worst error 7.0e-4 over these rows; 1.35e-3 while the port ran K2
        # there); the rest is the CPU JAX run's XLA attention against K1's
        assert np.all(cos >= 1 - 1e-3), f"{u}: cosine {cos}"
        np.testing.assert_allclose(pstore.img_stats[i], jstore.img_stats[jstore.index_of(u)],
                                   atol=3e-3)


def _jax_train_and_predict(base, root):
    db = LabelDatabase.load_or_create(str(root))
    uuids = sorted(f[:-4] for f in os.listdir(root) if f.endswith(".jpg"))
    for i, u in enumerate(uuids[:6]):
        db.relabel(u, (i % 4) / 4.0)
    db.save()
    crops = ["centre_crop", "subcrop2_0.1"]
    feats, labels, models = load_training_data(str(base / "data"), ["mydata"], ["all"],
                                               crops, False)
    assert models == [MODEL] and feats.shape == (6, 32)
    cfg = TrainConfig(crop_names=tuple(crops), n_epochs=3, batch_size=2,
                      test_fraction=0.25, hidden_sizes=(8,), dropout_prob=0.0)
    model, history = train_regressor(feats, labels, cfg, models, plot_dir=str(base),
                                     verbose=False)
    assert np.isfinite(history["train"]).all()
    path = save_model(model, history, cfg, out_dir=str(base / "models"))
    assert predict_labels(str(root), path, batch_size=4, copy_imgs_fraction=0.0) == N
    preds = LabelDatabase.load_or_create(str(root)).df["predicted_label"].astype(float)
    assert preds.notna().sum() == N and np.isfinite(preds).all()


def test_jax_train_and_predict_read_port_output(embedded):
    base, root, _jroot, _w = embedded
    _jax_train_and_predict(base, root)


def test_port_cli_dynamic_int8_read_by_jax_train_and_predict(tmp_path):
    """--compute_dtype int8 (dynamic W8A8: no calibration, so no .calib.npz)
    writes sidecars and a store of finite unit vectors that the JAX
    package's train and predict stages read."""
    root, weights = _dataset(tmp_path)
    _port_embed(root, weights, "--compute_dtype", "int8")
    assert not any(f.endswith(".calib.npz") for f in os.listdir(root))
    pts = sorted(f for f in os.listdir(root) if f.endswith(".pt"))
    assert len(pts) == N
    d = read_sidecar(str(root / pts[0]))[MODEL]
    store = JaxStore.open(str(root), MODEL)
    emb = np.asarray(store.embeddings, np.float32)
    assert emb.shape == (N, 4, 16) and np.asarray(store.valid).all()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=2e-3)
    np.testing.assert_allclose(emb[store.index_of(pts[0][:-3]), 0],
                               d["centre_crop"].reshape(-1), atol=2e-3)
    _jax_train_and_predict(tmp_path, root)
