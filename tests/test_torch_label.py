"""Stage 3 of the port (``pipeline/label.py``, ``ui/``) against the JAX
package's, on the CPU: every sort strategy and alias gives the JAX order on
the same CSV (the predictions are built so no two sort keys lie within an
ulp: pandas may parse a value an ulp off); the diversity sort from a store
and from sidecars; headless and oracle sessions on identical datasets write
the same CSV in every column but ``timestamp`` and show the same frames
(bit for bit, with cv2 installed here); and without cv2 and PIL the port
still loads PNG content under ``.jpg`` names (``data/loader.decode_rgb``)."""
import io
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.pipeline import label as jlabel
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu.store.database import LabelDatabase as JaxDatabase
from clip_assisted_data_labeling_tpu.ui import backend as jbackend
from clip_assisted_data_labeling_tpu.ui import sorting as jsorting
from clip_assisted_data_labeling_tpu_torch.data import loader
from clip_assisted_data_labeling_tpu_torch.data.png import write_png
from clip_assisted_data_labeling_tpu_torch.ops.diversity import farthest_point_order
from clip_assisted_data_labeling_tpu_torch.pipeline import label as tlabel
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar
from clip_assisted_data_labeling_tpu_torch.ui import backend as tbackend
from clip_assisted_data_labeling_tpu_torch.ui import sorting as tsorting
from clip_assisted_data_labeling_tpu_torch.utils.naming import natural_sort

N_IMAGES = 14
CANVAS_SHAPE = (960, 1706, 3)


def _dataset(base, seed=0):
    """A labelling dataset under base/ds: N_IMAGES JPEGs (one in a
    subdirectory, one unloadable), prompts in .txt and .json files, and a
    CSV with labels, predictions, NaN predictions, a row without an image
    and images without a row. Returns the root."""
    rng = np.random.default_rng(seed)
    root = base / "ds"
    (root / "sub").mkdir(parents=True)
    uuids = [f"img{i:02d}" for i in range(N_IMAGES)]
    for i, u in enumerate(uuids):
        path = root / ("sub" if i == 3 else "") / f"{u}.jpg"
        if i == 5:
            path.write_bytes(b"not an image")
            continue
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(path, quality=90)
    (root / "img01.txt").write_text("first line\nlast caption\n")
    (root / "img02.json").write_text('{"text_input": "json prompt"}')
    (root / "img04.json").write_text("{not json")
    # distinct predictions far apart, each a multiple of 2^-8, which every
    # parser reads exactly (pandas' may read other values an ulp off)
    preds = (rng.permutation(np.arange(1, 12)) * 21 + rng.integers(0, 4, 11)) / 256.0
    db_uuids = uuids[:11] + ["gone"]  # img11-img13 have no row; 'gone' no image
    labels = np.full(12, np.nan)
    labels[[0, 2, 7]] = [0.3, 0.9, 0.1]
    pred = np.append(preds, 0.5)
    pred[[4, 8]] = np.nan
    LabelDatabase({"uuid": db_uuids, "label": labels, "timestamp": np.full(12, 1.7e9),
                   "predicted_label": pred}, str(base / "ds.csv")).save()
    return root


def _files(root):
    return natural_sort([os.path.join(dp, f) for dp, _, fs in os.walk(root)
                         for f in fs if f.endswith(".jpg")])


def _copy(base, name):
    (base / name).mkdir()
    shutil.copytree(base / "ds", base / name / "ds")
    shutil.copy(base / "ds.csv", base / name / "ds.csv")
    return base / name / "ds"


def _csv(root):
    db = LabelDatabase.load_or_create(str(root))
    return db.column("uuid"), db.column("label"), db.column("predicted_label")


def _assert_same_csv(jroot, troot):
    ju, jl, jp = _csv(jroot)
    tu, tl, tp = _csv(troot)
    assert ju == tu
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jp, tp)


@pytest.mark.parametrize("sort", ["uuid", "bad_first", "good_first", "middle", "review",
                                  "Predicted bad first", "Predicted good first",
                                  "middle first"])
def test_sort_strategies_match_jax(tmp_path, sort):
    root = _dataset(tmp_path)
    files = _files(root)
    want = jsorting.re_order_images(files, JaxDatabase.load_or_create(str(root)), str(root),
                                    sort)
    got = tsorting.re_order_images(files, LabelDatabase.load_or_create(str(root)), str(root),
                                   sort, device="cpu")
    assert got == want
    if sort == "review":  # only rows with a label and a prediction
        assert sorted(os.path.basename(f) for f in got) == ["img00.jpg", "img02.jpg",
                                                            "img07.jpg"]
    else:
        assert sorted(got) == sorted(files)
        assert any(os.sep + "sub" + os.sep in f for f in got)


@pytest.mark.parametrize("sort", ["bad_first", "good_first", "middle", "review"])
def test_all_nan_first_lap_matches_jax(tmp_path, sort):
    """The first lap: rows without a prediction (and an empty database)."""
    root = _dataset(tmp_path)
    files = _files(root)
    db = LabelDatabase.load_or_create(str(root))
    n = len(db)
    LabelDatabase({"uuid": db.column("uuid"), "label": np.full(n, np.nan),
                   "timestamp": np.full(n, np.nan), "predicted_label": np.full(n, np.nan)},
                  db.path).save()
    by_uuid = {os.path.splitext(os.path.basename(f))[0]: f for f in files}
    head = [by_uuid[u] for u in db.column("uuid") if u in by_uuid]
    want = jsorting.re_order_images(files, JaxDatabase.load_or_create(str(root)), str(root),
                                    sort)
    got = tsorting.re_order_images(files, LabelDatabase.load_or_create(str(root)), str(root),
                                   sort, device="cpu")
    assert got == want
    # database order, then the images without a row
    assert got == ([] if sort == "review" else head + [f for f in files if f not in head])
    os.remove(db.path)  # then no database at all: natural order
    got = tsorting.re_order_images(files, LabelDatabase.load_or_create(str(root)), str(root),
                                   sort, device="cpu")
    if sort == "review":
        # the JAX package's empty DataFrame has object columns, which
        # np.isnan refuses; the port's float columns give an empty review
        with pytest.raises(TypeError):
            jsorting.re_order_images(files, JaxDatabase.load_or_create(str(root)), str(root),
                                     sort)
        assert got == []
    else:
        assert got == files == jsorting.re_order_images(
            files, JaxDatabase.load_or_create(str(root)), str(root), sort)


def test_unknown_sort_raises(tmp_path):
    root = _dataset(tmp_path)
    with pytest.raises(ValueError, match="unknown sort"):
        tsorting.re_order_images(_files(root), LabelDatabase.load_or_create(str(root)),
                                 str(root), "nonsense", device="cpu")
    assert tsorting.SORT_OPTIONS == jsorting.SORT_OPTIONS
    assert tsorting.SORT_ALIASES == jsorting.SORT_ALIASES


def _spread_embeddings(n, d, seed):
    """Embeddings whose farthest-point picks are far from ties: rows near
    well-separated directions."""
    rng = np.random.default_rng(seed)
    centres = np.linalg.qr(rng.normal(size=(d, d)))[0][:n]
    return (centres + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("source", ["store", "sidecars"])
def test_diversity_order_matches_jax(tmp_path, source):
    """The store path (one gather; an invalid row and a uuid the store
    lacks tail the order) and the sidecar fallback (an image without a
    sidecar tails it)."""
    root = _dataset(tmp_path)
    files = _files(root)
    uuids = [os.path.splitext(os.path.basename(f))[0] for f in files]
    emb = _spread_embeddings(len(uuids), 16, 1)
    if source == "store":
        for cls in (JaxStore, EmbeddingStore):  # each package's writer, the same files
            shutil.rmtree(root / ".ctpu_store", ignore_errors=True)
            store = cls.create(str(root), "m/x", ["centre_crop", "square_padded_crop"], 16,
                               uuids[:-1], with_stats=False)
            store.write_rows(0, np.stack([emb[:-1] * 0, emb[:-1]], 1))
            store.valid[4] = False
            store.flush()
            want = jsorting._diversity_order(files, str(root))
            got = tsorting._diversity_order(files, str(root), device="cpu")
            assert got == want
            assert got[-2:] == [files[4], files[-1]]
    else:
        for i, u in enumerate(uuids):
            if u != "img01":
                write_sidecar(os.path.join(os.path.dirname(files[i]), u + ".pt"), "m/x",
                              {"square_padded_crop": emb[i]})
        # sidecars are read in the root: the nested image's is not found
        want = jsorting._diversity_order(files, str(root))
        got = tsorting._diversity_order(files, str(root), device="cpu")
        assert got == want
        assert got[-2:] == [files[1], files[-1]]
    n_kept = len(files) - 2
    kept = [f for f in files if f not in got[-2:]]
    order = farthest_point_order(np.stack([emb[files.index(f)] for f in kept]), device="cpu")
    assert got[:n_kept] == [kept[i] for i in order]
    sampled = tsorting.re_order_images(files, None, str(root), "diversity_sampled",
                                       device="cpu")
    assert sorted(sampled) == sorted(files)


def test_diversity_with_under_two_embeddings_keeps_order(tmp_path, capsys):
    root = _dataset(tmp_path)
    files = _files(root)
    write_sidecar(str(root / "img00.pt"), "m/x", {"square_padded_crop": np.ones(8)})
    assert jsorting._diversity_order(files, str(root)) == files
    jout = capsys.readouterr().out
    assert tsorting.re_order_images(files, None, str(root), "diversity", device="cpu") == files
    tout = capsys.readouterr().out
    assert "WARNING" in tout and tout == jout


@pytest.mark.parametrize("stdin, want", [("", "uuid"), ("middle\n", "middle"), ("\n", "uuid")])
def test_prompt_sort_option_matches_jax(monkeypatch, capsys, stdin, want):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert jsorting.prompt_sort_option() == want
    jout = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert tsorting.prompt_sort_option() == want
    assert capsys.readouterr().out == jout


class Recorder:
    """A scripted backend that keeps each frame, its progress, the uuid
    the session announced, and how many labels the CSV on disk held at that
    moment (the autosave)."""

    def __init__(self, keys, csv_path):
        self.keys, self.csv_path = list(keys), csv_path
        self.frames, self.progress, self.uuids, self.on_disk = [], [], [], []

    def on_image(self, uuid):
        self.uuids.append(uuid)

    def show(self, image, progress):
        self.frames.append(image.copy())
        self.progress.append(progress)
        db = LabelDatabase.load_or_create(self.csv_path[:-len(".csv")])
        self.on_disk.append(db.n_labeled())
        return self.keys.pop(0) if self.keys else "quit"

    def close(self):
        pass


SESSIONS = {
    # name: (keys, sort, skip_labeled_files)
    "labels_and_autosave": (["3", "7", "1", "0", "9", "5", "2"], "uuid", True),
    "navigation": (["right", "4", "left", "left", "8", "right", "noop", "6", "quit"],
                   "middle", False),
    "wraps_past_the_end": (["right"] * 16 + ["2", "quit"], "bad_first", True),
    "skip_off_shows_labelled": (["1", "2", "3"], "uuid", False),
    "review": (["9", "right", "9", "9"], "review", False),
}


@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_headless_session_matches_jax(tmp_path, session):
    keys, sort, skip = SESSIONS[session]
    _dataset(tmp_path)
    jroot, troot = _copy(tmp_path, "jax"), _copy(tmp_path, "port")
    jrec = Recorder(keys, str(jroot) + ".csv")
    trec = Recorder(keys, str(troot) + ".csv")
    jdb = jlabel.label_dataset(str(jroot), jrec, sort=sort, skip_labeled_files=skip)
    tdb = tlabel.label_dataset(str(troot), trec, sort=sort, skip_labeled_files=skip,
                               device="cpu")
    assert tdb.n_labeled() == jdb.n_labeled() and len(tdb) == len(jdb)
    _assert_same_csv(jroot, troot)
    assert trec.uuids == jrec.uuids and trec.progress == jrec.progress
    assert trec.on_disk == jrec.on_disk
    assert len(trec.frames) == len(jrec.frames) > 0
    for a, b in zip(jrec.frames, trec.frames):
        assert a.shape == CANVAS_SHAPE and np.array_equal(a, b)
    assert "img05" not in trec.uuids  # unloadable: skipped
    for root in (jroot, troot):  # the session's backup of the database
        assert any("_db_backup_" in f for f in os.listdir(root.parent))
    if session == "labels_and_autosave":  # saved after the fifth label, mid-session
        assert trec.on_disk[:5] == [3] * 5 and trec.on_disk[5] > 3


def test_headless_backend_matches_jax(tmp_path):
    keys = ["2", "right", "5", "left", "quit"]
    _dataset(tmp_path)
    jroot, troot = _copy(tmp_path, "jax"), _copy(tmp_path, "port")
    jb, tb = jbackend.HeadlessBackend(keys), tbackend.HeadlessBackend(keys)
    jlabel.label_dataset(str(jroot), jb, sort="good_first")
    tlabel.label_dataset(str(troot), tb, sort="good_first", device="cpu")
    assert tb.shown == jb.shown and len(tb.shown_uuids) == len(tb.shown) == 5
    _assert_same_csv(jroot, troot)


def test_oracle_sessions_label_the_same_uuids(tmp_path):
    _dataset(tmp_path)
    truth = {f"img{i:02d}": (i % 10) / 10 for i in range(N_IMAGES)}
    for budget, skip in ((4, None), (30, {"img01", "img06"})):
        jroot, troot = _copy(tmp_path, f"jax{budget}"), _copy(tmp_path, f"port{budget}")
        jo = jbackend.OracleBackend(truth, budget, skip)
        to = tbackend.OracleBackend(truth, budget, skip)
        jlabel.label_dataset(str(jroot), jo, sort="middle")
        tlabel.label_dataset(str(troot), to, sort="middle", device="cpu")
        assert to.labeled == jo.labeled and len(to.labeled) >= min(budget, 8)
        _assert_same_csv(jroot, troot)


def test_label_cli_headless_prints_the_shown_uuids(tmp_path, capsys):
    root = _dataset(tmp_path)
    tlabel.main(["--root_dir", str(root), "--sort", "uuid", "--backend", "headless",
                 "--keys", "4,right,6,esc", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("headless")]
    assert line == ["headless session: 4 frames shown: img00,img01,img02,img04"]
    db = LabelDatabase.load_or_create(str(root))
    assert db.get_label("img00") == 0.4 and db.get_label("img02") == 0.6


def test_frames_without_cv2_or_pil(tmp_path, monkeypatch):
    """PNG streams under .jpg names load through the port's PNG reader:
    the frames keep the canvas shape, the image within ±1 of cv2's resize,
    the progress bar exactly cv2's, and no text."""
    root = tmp_path / "pngs"
    root.mkdir()
    rng = np.random.default_rng(3)
    images = {}
    for i in range(3):
        images[f"p{i}"] = rng.integers(0, 256, (30 + 11 * i, 50, 3)).astype(np.uint8)
        write_png(str(root / f"p{i}.jpg"), images[f"p{i}"])
    (root / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    with_cv2 = Recorder(["1", "2", "3"], str(root) + ".csv")
    tlabel.label_dataset(str(root), with_cv2, device="cpu")
    os.remove(str(root) + ".csv")
    monkeypatch.setattr(loader, "cv2", None)
    monkeypatch.setattr(loader, "Image", None)
    bare = Recorder(["1", "2", "3"], str(root) + ".csv")
    tlabel.label_dataset(str(root), bare, device="cpu")
    assert bare.uuids == with_cv2.uuids == ["p0", "p1", "p2", "p0"]  # wraps, then quits
    assert bare.progress == with_cv2.progress
    for u, frame, ref in zip(bare.uuids, bare.frames, with_cv2.frames):
        assert frame.shape == CANVAS_SHAPE
        box = tlabel.letterbox(images[u][:, :, ::-1].copy())
        monkeypatch.setattr(loader, "cv2", cv2)
        want = tlabel.letterbox(images[u][:, :, ::-1].copy())
        monkeypatch.setattr(loader, "cv2", None)
        assert np.abs(box.astype(int) - want.astype(int)).max() <= 1
        x0, x1 = int(1706 * 0.1), int(1706 * 0.1) + int(1706 * 0.8) + 1
        np.testing.assert_array_equal(frame[-10:, x0:x1], ref[-10:, x0:x1])  # the bar
        np.testing.assert_array_equal(frame[:-10], box[:-10])  # no text drawn
    assert LabelDatabase.load_or_create(str(root)).n_labeled() == 3


def test_decode_rgb_reads_png_content_by_signature(tmp_path, monkeypatch):
    rgb = np.random.default_rng(4).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    write_png(str(tmp_path / "a.jpg"), rgb)
    (tmp_path / "b.png").write_bytes(b"plain text")
    monkeypatch.setattr(loader, "cv2", None)
    monkeypatch.setattr(loader, "Image", None)
    np.testing.assert_array_equal(loader.decode_rgb(str(tmp_path / "a.jpg")), rgb)
    with pytest.raises(ValueError, match="not a PNG"):
        loader.decode_rgb(str(tmp_path / "b.png"))
    monkeypatch.setattr(loader, "cv2", cv2)
    np.testing.assert_array_equal(loader.decode_rgb(str(tmp_path / "a.jpg")), rgb)


def test_thumbnail_cache_and_prompts_match_jax(tmp_path):
    root = _dataset(tmp_path)
    for u in ("img01", "img02", "img04", "img05", "img09"):
        jimg, jprompt = jlabel.load_image_and_prompt(u, str(root))
        timg, tprompt = tlabel.load_image_and_prompt(u, str(root))
        assert tprompt == jprompt
        assert (timg is None) == (jimg is None) and (jimg is None or np.array_equal(timg, jimg))
    cache = tlabel.ThumbnailCache(capacity=2)
    for u in ("img00", "img01", "img00", "img02", "img01", "img05", "img05"):
        frame, _ = cache.get(u, str(root))
        assert frame is None if u == "img05" else frame.shape == CANVAS_SHAPE
    assert (cache.hits, cache.misses) == (2, 5)


def test_label_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    root = _dataset(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        tlabel.label_dataset(str(root), tbackend.HeadlessBackend(["quit"]))
    with pytest.raises(RuntimeError, match="cuda"):
        tlabel.main(["--root_dir", str(root), "--sort", "uuid", "--backend", "headless"])
