"""Stages 4-6 of the port end to end on the CPU, held against the JAX
package's: a checkpoint trained by either package's train CLI scores the
same through both predict CLIs (within 1e-6 on the float32 wire, and within
1e-6 of each other on float16), with the same ``.json`` writeback and the
same preview picks; the single-image scorer on ViT-Test/tiny with weights
from a JAX-written ``.npz``; subset's copied set; and each of the port's
CLIs in a process of its own, which imports neither jax, optax nor pandas.

The dataset is a ViT-Test/tiny columnar store (4 crops of 16, float16, as
the embed stage writes it, with the 22 stats), a gray baseline JPEG of a
seeded size a row (no CLI here decodes one; subset reads their headers),
``.json`` files for every third row and a CSV with human labels on most
rows, which carry a planted linear signal."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.config import SubsetConfig as JaxSubsetConfig
from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.models.aesthetic import AestheticRegressor as JaxScorer
from clip_assisted_data_labeling_tpu.models.regressor import RegressorMeta as JaxMeta
from clip_assisted_data_labeling_tpu.models.regressor import SimpleFCRegressor as JaxRegressor
from clip_assisted_data_labeling_tpu.pipeline import predict as jpredict
from clip_assisted_data_labeling_tpu.pipeline import subset as jsubset
from clip_assisted_data_labeling_tpu.pipeline import train as jtrain
from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS, SubsetConfig
from clip_assisted_data_labeling_tpu_torch.data.imsize import gray_jpeg_bytes
from clip_assisted_data_labeling_tpu_torch.models.aesthetic import AestheticRegressor
from clip_assisted_data_labeling_tpu_torch.pipeline import predict as tpredict
from clip_assisted_data_labeling_tpu_torch.pipeline import predict_simple as tpredict_simple
from clip_assisted_data_labeling_tpu_torch.pipeline import subset as tsubset
from clip_assisted_data_labeling_tpu_torch.pipeline import train as ttrain
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase

MODEL = "ViT-Test/tiny"
N = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGS = ["--n_epochs", "6", "--batch_size", "8", "--hidden_sizes", "12", "6",
              "--dropout_prob", "0.2"]


def _dataset(base, seed=0):
    """The dataset under base/data/mydata; returns the root."""
    root = base / "data" / "mydata"
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    uuids = [f"{rng.integers(1 << 62):032x}" for _ in range(N)]
    emb = rng.normal(0, 1, (N, 4, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    store = EmbeddingStore.create(str(root), MODEL, list(ALL_CROPS), 16, uuids)
    store.write_rows(0, emb, rng.normal(0, 1, (N, 22)).astype(np.float32))
    store.flush()
    direction = rng.normal(0, 1, 16)
    db = LabelDatabase.load_or_create(str(root))
    for i, u in enumerate(uuids):
        w, h = (int(v) for v in rng.integers(20, 120, 2))
        (root / f"{u}.jpg").write_bytes(gray_jpeg_bytes(w, h))
        if i % 3 == 0:
            (root / f"{u}.json").write_text(json.dumps({"uuid": u, "prompt": f"p{i}"}))
        if i % 4 == 1:
            (root / f"{u}.txt").write_text(f"caption {i}")
        if i < 48:
            signal = 4.5 + 12 * float(emb[i, 0] @ direction) / np.linalg.norm(direction)
            db.relabel(u, float(np.clip(np.round(signal + rng.normal(0, 0.3)), 0, 9)))
    db.save()
    return root


def _copy(base, name):
    """A copy of base/data (the dataset and its CSV) under base/<name>;
    returns the copy's dataset root."""
    shutil.copytree(base / "data", base / name)
    return base / name / "mydata"


def _predictions(root):
    db = LabelDatabase.load_or_create(str(root))
    return dict(zip(db.column("uuid"), db.column("predicted_label"))), db


def _json_files(root):
    return {f: json.loads((root / f).read_text()) for f in sorted(os.listdir(root))
            if f.endswith(".json")}


def _previews(root):
    out = str(root) + "_predicted_scores"
    return {f.split("_", 1)[1] for f in os.listdir(out)} if os.path.isdir(out) else set()


def _both_predicts(base, model_path, wire, tag):
    """The JAX and the port's predict CLIs on copies of the dataset, wire
    ``wire``; returns both roots."""
    jroot, troot = _copy(base, f"jax_{tag}_{wire}"), _copy(base, f"port_{tag}_{wire}")
    common = ["--model_file", model_path, "--wire", wire, "--copy_imgs_fraction", "0.25"]
    jpredict.main(["--root_dir", str(jroot), *common])
    tpredict.main(["--root_dir", str(troot), *common, "--device", "cpu"])
    return jroot, troot


def _assert_same_predictions(jroot, troot, atol=1e-6):
    jp, jdb = _predictions(jroot)
    tp, tdb = _predictions(troot)
    assert set(jp) == set(tp) and len(tp) == N
    diff = max(abs(jp[u] - tp[u]) for u in jp)
    assert diff <= atol, diff
    np.testing.assert_array_equal(
        [jdb.get_label(u) for u in sorted(jp)], [tdb.get_label(u) for u in sorted(jp)])
    jj, tj = _json_files(jroot), _json_files(troot)
    assert set(jj) == set(tj) and len(tj) == (N + 2) // 3
    for f in jj:
        assert set(jj[f]) == set(tj[f]) == {"uuid", "prompt", "predicted_label"}
        assert abs(jj[f]["predicted_label"] - tj[f]["predicted_label"]) <= atol
        assert tj[f]["predicted_label"] == pytest.approx(tp[tj[f]["uuid"]], abs=1e-7)
    assert _previews(troot) == _previews(jroot) and _previews(troot)
    return tp


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_stages")
    _dataset(base)
    return base


def test_port_trained_checkpoint_scores_the_same_in_both_packages(base, monkeypatch):
    """The port's train CLI writes the checkpoint; the JAX and the port's
    predict CLIs score copies of the dataset with it, on the float32 and on
    the float16 wire."""
    monkeypatch.chdir(base)
    _model, history, path = ttrain.main(["--train_data_dir", str(base / "data"),
                                         "--train_data_names", "mydata", *TRAIN_ARGS,
                                         "--model_name", "port_trained", "--device", "cpu"])
    assert history["test"][-1] < history["test"][0]
    scores = {}
    for wire in ("float32", "float16"):
        scores[wire] = _assert_same_predictions(*_both_predicts(base, path, wire, "port"))
    # the store holds float16, which the float16 wire carries exactly
    assert scores["float32"] == scores["float16"]


def test_jax_trained_checkpoint_scores_the_same_in_both_packages(base, monkeypatch):
    """The JAX train CLI writes the checkpoint (and its .pth); the port's
    predict CLI scores as the JAX one does, from the .npz and the .pth."""
    monkeypatch.chdir(base)
    jtrain.main(["--train_data_dir", str(base / "data"), "--train_data_names", "mydata",
                 *TRAIN_ARGS, "--model_name", "jax_trained", "--export_torch"])
    (path,) = [os.path.join("models", f) for f in os.listdir("models")
               if f.startswith("jax_trained") and f.endswith(".npz")]
    jroot, _troot = _both_predicts(base, path, "float32", "jax")
    _assert_same_predictions(jroot, _troot)
    troot = _copy(base, "port_pth")
    tpredict.main(["--root_dir", str(troot), "--model_file", path[:-4] + ".pth",
                   "--wire", "float32", "--copy_imgs_fraction", "0.25", "--device", "cpu"])
    _assert_same_predictions(jroot, troot)


def test_scorer_matches_jax_on_tiny_tower(tmp_path):
    """AestheticRegressor on ViT-Test/tiny (bfloat16, both packages' default)
    with weights from a JAX-written .npz, a checkpoint that asks for the
    image stats, and an image larger than the canvas: the features of each
    crop within bf16's cosine limit (1e-3) of the JAX scorer's, the stats
    within 3e-3 (the embed stage's test), the score within one bf16 step."""
    weights = tmp_path / "weights"
    weights.mkdir()
    cfg = jvit.resolve_config(MODEL)
    jweights.save_params_npz(str(weights / "ViT-Test-tiny.npz"),
                             jvit.init_vit_params(cfg, jax.random.key(7)))
    crops = ("centre_crop", "subcrop2_0.1")
    meta = JaxMeta(clip_models=(MODEL,), crop_names=crops, input_size=2 * 16 + 22,
                   hidden_sizes=(12,), use_img_stat_features=True)
    ckpt = str(tmp_path / "scorer.npz")
    JaxRegressor.create(jax.random.key(1), meta).save(ckpt)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (180, 300, 3)).astype(np.uint8)
    img[:, :150] = 90

    jscore, jfeat = JaxScorer(ckpt, model_weights_dir=str(weights), canvas_size=256,
                              verbose=0).predict_score(Image.fromarray(img))
    scorer = AestheticRegressor(ckpt, model_weights_dir=str(weights), canvas_size=256,
                                verbose=0, device="cpu")
    tscore, tfeat = scorer.predict_score(img)
    pscore, _ = scorer.predict_score(Image.fromarray(img))
    assert tfeat.shape == jfeat.shape == (1, 54) and pscore == tscore
    for lo in (0, 16):
        a, b = tfeat[0, lo:lo + 16], jfeat[0, lo:lo + 16]
        assert 1 - a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) <= 1e-3
    np.testing.assert_allclose(tfeat[0, 32:], jfeat[0, 32:], atol=3e-3)
    assert abs(tscore - jscore) <= 2.0 ** -8, (tscore, jscore)


@pytest.mark.parametrize("test_mode", [False, True])
def test_subset_copies_what_jax_copies(base, test_mode):
    """Human labels rescaled by the largest, predictions elsewhere, the
    aspect and pixel gates on each JPEG's header, the existing extensions'
    counters, and the folder named with the count: the same copied set as
    the JAX stage on copies of one dataset with seeded predictions."""
    tag = "test" if test_mode else "copy"
    jroot, troot = _copy(base, f"subset_jax_{tag}"), _copy(base, f"subset_port_{tag}")
    for root in (jroot, troot):
        db = LabelDatabase.load_or_create(str(root))
        uuids = db.column("uuid")
        db.merge_predictions(uuids, np.random.default_rng(8).random(len(uuids)))
        db.save()
    kw = dict(min_score=0.3, max_score=0.8, min_n_pixels=50 * 50, min_aspect_ratio=0.5,
              max_aspect_ratio=2.0, extensions=(".jpg", ".txt", ".pt", ".json"),
              test=test_mode)
    jout = jsubset.copy_subset(str(jroot), JaxSubsetConfig(**kw))
    tout = tsubset.copy_subset(str(troot), SubsetConfig(**kw))
    if test_mode:
        assert jout is tout is None
        assert not any("_subset" in d for d in os.listdir(troot.parent))
        return
    assert os.path.basename(jout) == os.path.basename(tout)
    copied = sorted(os.listdir(tout))
    assert copied == sorted(os.listdir(jout))
    n_imgs = sum(f.endswith(".jpg") for f in copied)
    assert tout.endswith(f"_0.30_to_0.80_subset_{n_imgs}_imgs") and 0 < n_imgs < N
    assert any(f.endswith(".txt") for f in copied) and any(f.endswith(".json") for f in copied)


def test_subset_scores_match_jax():
    labels = np.array([np.nan, 2.0, 8.0, np.nan, 0.0])
    preds = np.array([0.4, 0.9, np.nan, np.nan, 0.2])
    np.testing.assert_array_equal(tsubset.final_scores(labels, preds),
                                  [0.4, 0.25, 1.0, np.nan, 0.0])
    # all labels 0: the labels as they are; no label at all: the predictions
    np.testing.assert_array_equal(tsubset.final_scores(np.zeros(2), preds[:2]), [0.0, 0.0])
    np.testing.assert_array_equal(tsubset.final_scores(np.full(2, np.nan), preds[:2]),
                                  preds[:2])


def _imported(stderr: str) -> set:
    return {ln.split("|")[-1].strip().split(".")[0] for ln in stderr.splitlines()
            if ln.startswith("import time:")}


def test_each_cli_runs_alone_without_jax_optax_or_pandas(tmp_path):
    """train → predict → predict_simple → subset, each ``python -m`` in a
    process of its own on the CPU (``-X importtime`` lists its imports)."""
    _dataset(tmp_path)
    root = str(tmp_path / "data" / "mydata")
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        Image.fromarray(np.full((40 + 20 * i, 50, 3), 60 * i, np.uint8)).save(imgs / f"{i}.png")
    pkg = "clip_assisted_data_labeling_tpu_torch.pipeline"
    runs = [
        ("train", ["--train_data_dir", str(tmp_path / "data"), "--train_data_names", "mydata",
                   "--n_epochs", "2", "--device", "cpu"]),
        ("predict", ["--root_dir", root, "--model_file", "regressor", "--device", "cpu"]),
        ("predict_simple", ["--input_img_dir", str(imgs), "--model_path", "MODEL",
                            "--device", "cpu"]),
        ("subset", ["--input_dir", root, "--min_score", "0.2", "--min_n_pixels", "100"]),
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    for stage, args in runs:
        if stage == "predict_simple":
            (ckpt,) = os.listdir(tmp_path / "models")
            args[args.index("MODEL")] = str(tmp_path / "models" / ckpt)
        proc = subprocess.run([sys.executable, "-X", "importtime", "-m", f"{pkg}.{stage}",
                               *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (stage, proc.stderr[-3000:])
        imported = _imported(proc.stderr)
        assert "torch" in imported or stage == "subset"
        assert not imported & {"jax", "optax", "pandas", "clip_assisted_data_labeling_tpu"}, \
            (stage, sorted(imported & {"jax", "optax", "pandas"}))
    assert len(os.listdir(str(imgs) + "_aesthetic_scores")) == 2
    assert all(f.split("_", 1)[0].replace(".", "").isdigit()
               for f in os.listdir(str(imgs) + "_aesthetic_scores"))
    assert any(d.startswith("mydata_0.20_to_1.00_subset_") for d in
               os.listdir(tmp_path / "data"))


def test_entry_points_default_to_the_card(tmp_path):
    """Without --device each stage asks for the card, and where there is
    none it raises instead of running on the CPU; so does predict
    --sharded, whose mesh takes every card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        tpredict.main(["--root_dir", str(tmp_path), "--model_file", "x"])
    with pytest.raises(RuntimeError, match="cuda"):
        tpredict_simple.main(["--input_img_dir", str(tmp_path), "--model_path", "x.npz"])
    with pytest.raises(RuntimeError, match="cuda"):
        AestheticRegressor("x.npz")
    with pytest.raises(RuntimeError, match="cuda"):
        tpredict.main(["--root_dir", str(tmp_path), "--model_file", "x", "--sharded"])
    from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        get_mesh()  # the mesh of --sharded: every local card
