"""On-disk interop between the port and the JAX package, both directions:
sidecars, the columnar store and its readers, the label CSV, .calib.npz and
.npz weights; the naming helpers; and the port's PNG reader against PIL."""
import os
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.store import columnar as jcol
from clip_assisted_data_labeling_tpu.store import database as jdb
from clip_assisted_data_labeling_tpu.store import sidecar as jside
from clip_assisted_data_labeling_tpu.utils import naming as jnaming
from clip_assisted_data_labeling_tpu_torch.data.png import png_size, read_png, write_png
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
from clip_assisted_data_labeling_tpu_torch.store import columnar as tcol
from clip_assisted_data_labeling_tpu_torch.store import database as tdb
from clip_assisted_data_labeling_tpu_torch.store import sidecar as tside
from clip_assisted_data_labeling_tpu_torch.utils import naming as tnaming

CROPS = ["centre_crop", "square_padded_crop", "subcrop1_0.15", "subcrop2_0.1"]
WRITERS = {"port": (tside, tcol), "jax": (jside, jcol)}
BOTH = [("port", "jax"), ("jax", "port")]


def _features(rng):
    emb = {c: rng.normal(0, 1, 16).astype(np.float32) for c in CROPS}
    stats = {f"img_stat_{i}": float(rng.random()) for i in range(3)}
    return emb, stats


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_sidecar_interop(rng, tmp_path, writer, reader):
    w, r = WRITERS[writer][0], WRITERS[reader][0]
    path = str(tmp_path / "a.pt")
    emb_a, stats_a = _features(rng)
    emb_b, _ = _features(rng)
    w.write_sidecar(path, "model-a", emb_a, stats_a)
    r.write_sidecar(path, "model-b", emb_b)  # merge keeps the other model's key
    d = r.read_sidecar(path)
    assert set(d) == {"model-a", "model-b"}
    for c in CROPS:
        np.testing.assert_array_equal(d["model-a"][c], emb_a[c].reshape(1, -1))
        np.testing.assert_array_equal(w.read_sidecar(path)["model-b"][c], emb_b[c].reshape(1, -1))
    for k, v in stats_a.items():
        assert float(d["model-a"][k]) == np.float32(v)
    assert w.has_model_key(path, "model-b") and r.has_model_key(path, "model-a")
    assert w.resolve_crop_key({"subcrop1": 1}, "subcrop1_0.15") == "subcrop1"


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_store_interop(rng, tmp_path, writer, reader):
    w, r = WRITERS[writer][1], WRITERS[reader][1]
    uuids = [f"u{i}" for i in range(5)]
    emb = rng.normal(0, 1, (5, 4, 16)).astype(np.float32)
    stats = rng.random((5, 22)).astype(np.float32)
    s = w.EmbeddingStore.create(str(tmp_path), "ViT-Test/tiny", CROPS, 16, uuids,
                                rel_paths=[f"sub/{u}.png" for u in uuids])
    for i in range(5):
        s.write_rows(i, emb[i:i + 1], stats[i:i + 1])
    s.valid[3] = False
    s.flush()
    o = r.EmbeddingStore.open(str(tmp_path), "ViT-Test/tiny")
    assert o.meta == s.meta and o.uuids == uuids and o.index_of("u2") == 2
    np.testing.assert_array_equal(o.embeddings, emb.astype(np.float16))
    np.testing.assert_array_equal(o.img_stats, stats)
    np.testing.assert_array_equal(o.valid, [True, True, True, False, True])
    assert o.crop_index("subcrop2") == 3
    assert r.EmbeddingStore.exists(str(tmp_path), "ViT-Test/tiny")


def test_store_paths_readable_by_jax(tmp_path):
    s = tcol.EmbeddingStore.create(str(tmp_path), "m/x", CROPS, 8, ["a", "b"],
                                   rel_paths=["d/a.png", "b.jpg"])
    s.flush()
    assert jcol.EmbeddingStore.open(str(tmp_path), "m/x").rel_paths() == ["d/a.png", "b.jpg"]
    assert jcol.list_models(str(tmp_path)) == ["m/x"]


def _store_with_rows(col, root, rng, model="ViT-Test/tiny", with_stats=True, paths=True):
    """A 6-row store written by ``col``; rows 2 and 5 invalid."""
    uuids = [f"{i:032d}" if i == 0 else f"u{i}" for i in range(6)]
    emb = rng.normal(0, 1, (6, 4, 16)).astype(np.float32)
    stats = rng.random((6, 22)).astype(np.float32)
    s = col.EmbeddingStore.create(str(root), model, CROPS, 16, uuids, with_stats=with_stats,
                                  rel_paths=[f"sub/{u}.png" for u in uuids] if paths else None)
    for i in range(6):
        s.write_rows(i, emb[i:i + 1], stats[i:i + 1] if with_stats else None)
    s.valid[2] = s.valid[5] = False
    s.flush()
    return uuids


@pytest.mark.parametrize("writer,reader", BOTH)
def test_store_readers_interop(rng, tmp_path, writer, reader):
    """list_models, rel_paths (with and without paths.txt) and both
    assemble_* readers read the same arrays from a store written by either
    package; the stats recipe against a store without stats raises in both."""
    w, r = WRITERS[writer][1], WRITERS[reader][1]
    uuids = _store_with_rows(w, tmp_path, rng)
    _store_with_rows(w, tmp_path, rng, model="m/b", with_stats=False, paths=False)
    assert r.list_models(str(tmp_path)) == jcol.list_models(str(tmp_path)) == [
        "ViT-Test/tiny", "m/b"]
    assert tcol.list_models(str(tmp_path / "nothing")) == []
    models = ["ViT-Test/tiny", "m/b"]
    stores = {m: r.EmbeddingStore.open(str(tmp_path), m) for m in models}
    refs = {m: jcol.EmbeddingStore.open(str(tmp_path), m) for m in models}
    assert stores["ViT-Test/tiny"].rel_paths() == [f"sub/{u}.png" for u in uuids]
    os.remove(os.path.join(stores["m/b"].directory, "paths.txt"))
    assert stores["m/b"].rel_paths() == refs["m/b"].rel_paths() == [u + ".jpg" for u in uuids]
    crops = ["subcrop2", "centre_crop"]
    ask = [uuids[4], "absent", uuids[0], uuids[2], uuids[1]]
    for mods, stats in ((models[:1], True), (models, False)):
        kept, feats = r.assemble_batch_from_stores(stores, mods, crops, stats, ask)
        kept_j, feats_j = jcol.assemble_batch_from_stores(refs, mods, crops, stats, ask)
        np.testing.assert_array_equal(kept, kept_j)
        np.testing.assert_array_equal(kept, [True, False, True, False, True])
        np.testing.assert_array_equal(feats, feats_j)
        for u, row in zip([u for u, k in zip(ask, kept) if k], feats):
            one = r.assemble_from_stores(stores, mods, crops, stats, u)
            np.testing.assert_array_equal(one, row)
            np.testing.assert_array_equal(one, jcol.assemble_from_stores(refs, mods, crops,
                                                                         stats, u))
        for u in ("absent", uuids[2]):
            with pytest.raises(KeyError):
                r.assemble_from_stores(stores, mods, crops, stats, u)
    for fn in (lambda: r.assemble_batch_from_stores(stores, models, crops, True, ask),
               lambda: r.assemble_from_stores(stores, models, crops, True, uuids[0])):
        with pytest.raises(KeyError, match="no img stats"):
            fn()


@pytest.mark.parametrize("writer,reader", BOTH)
def test_from_sidecars_interop(rng, tmp_path, writer, reader):
    """A store built from sidecars written by either package holds the same
    rows, paths and validity as the JAX package's import of the same files."""
    ws, wc = WRITERS[writer]
    rc = WRITERS[reader][1]
    uuid_paths = {}
    for i, u in enumerate(["b1", "a0", "0099", "c2"]):
        sub = tmp_path / "data" / ("x" if i % 2 else "y")
        sub.mkdir(parents=True, exist_ok=True)
        path = str(sub / f"{u}.pt")
        emb, _ = _features(rng)
        stats = {k: float(rng.random()) for k in IMG_STAT_KEYS}  # the store's 22
        if u == "c2":
            ws.write_sidecar(path, "other-model", emb, stats)  # lacks the model: invalid
        else:
            ws.write_sidecar(path, "ViT-Test/tiny", emb, stats)
        uuid_paths[u] = path
    root, ref_root = str(tmp_path / "data"), str(tmp_path / "ref")
    shutil.copytree(root, ref_root)
    got = rc.EmbeddingStore.from_sidecars(root, "auto", uuid_paths)
    ref = jcol.EmbeddingStore.from_sidecars(
        ref_root, "auto", {u: p.replace(root, ref_root) for u, p in uuid_paths.items()})
    for r in (root, ref_root):
        s = jcol.EmbeddingStore.open(r, "ViT-Test/tiny")
        assert s.uuids == ["0099", "a0", "b1", "c2"]
        np.testing.assert_array_equal(s.valid, [True, True, True, False])
    assert got.rel_paths() == ref.rel_paths() == ["y/0099.jpg", "x/a0.jpg", "y/b1.jpg",
                                                  "x/c2.jpg"]
    assert got.meta == ref.meta
    np.testing.assert_array_equal(got.embeddings, ref.embeddings)
    np.testing.assert_array_equal(got.img_stats, ref.img_stats)
    with pytest.raises(ValueError, match="no sidecar"):
        rc.EmbeddingStore.from_sidecars(root, "missing-model", uuid_paths)


def _labels(rng, n=12):
    """uuids (an all-digit one with leading zeros among them), labels with
    NaNs, and scores."""
    uuids = [tnaming.new_uuid() for _ in range(n - 2)] + ["0012345678901234", "000"]
    labels = np.round(rng.random(n) * 10) / 10
    labels[[1, 4, n - 1]] = np.nan
    return uuids, labels, rng.random(n)


def _fill(db_mod, root, uuids, labels, scores):
    db = db_mod.LabelDatabase.load_or_create(str(root))
    for u, lab in zip(uuids[:8], labels[:8]):
        db.relabel(u, lab)
    db.ensure_rows(uuids[6:10])
    merged = np.r_[scores[4:], 0.25]
    merged[3] = np.nan  # uuids[7], labeled: a NaN score keeps its (missing) prediction
    db.merge_predictions(uuids[4:] + ["new-one"], merged)
    db.relabel(uuids[0], 0.7)
    db.fix_database()
    db.save()
    return db


def _frame_of(db, module):
    """{column: values} of a loaded database of either package."""
    if module is jdb:
        return {c: (db.df[c].tolist() if c == "uuid" else db.df[c].to_numpy(np.float64))
                for c in db.df.columns}
    return {c: (list(db.column(c)) if c == "uuid" else np.asarray(db.column(c)))
            for c in db.column_names}


@pytest.mark.parametrize("writer,reader", BOTH)
def test_label_csv_interop(rng, tmp_path, writer, reader):
    """A label CSV written by either package loads the same frame in the
    other: the columns in order, the uuids as text (leading zeros kept), the
    same NaN cells, the same values (pandas' default float parser may be
    off by an ulp from the exact value the file holds: rtol 1e-15), and the
    same labels and predictions through the query methods."""
    mods = {"port": tdb, "jax": jdb}
    root = tmp_path / "data" / "mydata"
    root.mkdir(parents=True)
    uuids, labels, scores = _labels(rng)
    written = _fill(mods[writer], root, uuids, labels, scores)
    path = tdb.database_path_for(str(root))
    assert path == jdb.database_path_for(str(root) + "/") and os.path.exists(path)
    got = mods[reader].LabelDatabase.load_or_create(str(root))
    want = _frame_of(written, mods[writer])
    have = _frame_of(got, mods[reader])
    assert list(have) == list(want) == ["uuid", "label", "timestamp", "predicted_label"]
    assert have["uuid"] == want["uuid"] == uuids + ["new-one"]
    for c in ("label", "timestamp", "predicted_label"):
        np.testing.assert_array_equal(np.isnan(have[c]), np.isnan(want[c]), err_msg=c)
        np.testing.assert_allclose(have[c], want[c], rtol=1e-15, atol=0, err_msg=c)
    assert len(got) == len(written) == 13 and got.n_labeled() == written.n_labeled() == 6
    for u in uuids + ["new-one", "absent"]:
        for q in ("get_label", "get_predicted_label"):
            a, b = getattr(got, q)(u), getattr(written, q)(u)
            assert (a is None) == (b is None) and (a is None or np.isclose(a, b, rtol=1e-15)
                                                   or (np.isnan(a) and np.isnan(b))), (u, q)
    # the NaN score kept uuids[7]'s prediction; fix_database then gave it its label
    assert np.isclose(got.get_predicted_label(uuids[7]), labels[7], rtol=1e-15)


def test_label_database_updates_match_jax(tmp_path):
    """The same updates on both packages' databases give the same frame: a
    NaN score keeps the old prediction, new uuids get rows (duplicates in a
    call too), human labels are untouched by predictions."""
    dbs = [m.LabelDatabase.load_or_create(str(tmp_path / "d")) for m in (tdb, jdb)]
    for db in dbs:
        db.relabel("a", 0.5)
        db.relabel("b", 0.1)
        db.merge_predictions(["a", "c"], np.array([0.3, 0.6]))
        db.merge_predictions(["a", "c", "d"], np.array([np.nan, 0.9, np.nan]))
        assert db.ensure_rows(["e", "a", "e"]) == 2
        db.relabel("b", 0.2)
    port, ref = (_frame_of(db, m) for db, m in zip(dbs, (tdb, jdb)))
    assert port["uuid"] == ref["uuid"] == ["a", "b", "c", "d", "e", "e"]
    for c in ("label", "predicted_label"):
        np.testing.assert_array_equal(port[c], ref[c], err_msg=c)
    np.testing.assert_array_equal(np.isnan(port["timestamp"]), np.isnan(ref["timestamp"]))
    assert dbs[0].get_predicted_label("a") == 0.3 and dbs[0].get_label("b") == 0.2


def test_label_database_backup_and_empty(tmp_path):
    root = tmp_path / "d"
    root.mkdir()
    db = tdb.LabelDatabase.load_or_create(str(root))
    assert len(db) == 0 and db.create_backup() is None
    db.save()
    assert jdb.LabelDatabase.load_or_create(str(root)).df.shape == (0, 4)
    (tmp_path / "old_db_backup_1.csv").write_text("x")
    backup = db.create_backup()
    assert os.path.basename(backup).startswith("d_db_backup_")
    assert sorted(os.listdir(tmp_path)) == sorted(["d", "d.csv", os.path.basename(backup)])


def test_naming_matches_jax():
    names = ["img10.jpg", "Img2.jpg", "img1.jpg", "b", "A", "x²1", "img02.jpg", "10", "9"]
    assert tnaming.natural_sort(names) == jnaming.natural_sort(names)
    u = tnaming.new_uuid()
    assert len(u) == len(jnaming.new_uuid()) == 32 and int(u, 16) >= 0 and u == u.lower()
    assert u[12] == "4" and u != tnaming.new_uuid()  # uuid4


@pytest.mark.parametrize("writer,reader", [(tenc, jenc), (jenc, tenc)])
def test_calibration_interop(rng, tmp_path, writer, reader):
    name = "ViT-Test/tiny"
    cfg = (tvit if reader is tenc else jvit).resolve_config(name)
    amax = {"act_amax": rng.random((2, 4)).astype(np.float32),
            "qkv_amax": rng.random((2, 192)).astype(np.float32)}
    path = writer.calibration_file(name, str(tmp_path))
    assert path == reader.calibration_file(name, str(tmp_path))
    writer.save_calibration(path, amax, name)
    got = reader.load_calibration(path)
    reader.check_calibration(got, cfg, path, name)
    for k, v in amax.items():
        np.testing.assert_array_equal(got[k], v)
    assert str(got["_model_name"]) == name
    with pytest.raises(ValueError, match="calibrated for"):
        reader.check_calibration(got, cfg, path, "ViT-B-32/openai")


def test_weights_npz_interop(tmp_path):
    cfg = jvit.resolve_config("ViT-Test/tiny")
    params = jax.tree.map(np.asarray, jvit.init_vit_params(cfg, jax.random.key(0)))
    jpath = str(tmp_path / "j.npz")
    jweights.save_params_npz(jpath, params)
    model = tweights.module_from_params(tweights.load_params_npz(jpath),
                                        tvit.resolve_config("ViT-Test/tiny"))
    tpath = str(tmp_path / "t.npz")
    tweights.save_params_npz(tpath, tweights.params_from_module(model))
    back = jweights.load_params_npz(tpath)
    flat = tweights.flatten_params(params)
    assert set(tweights.flatten_params(back)) == set(flat)
    for k, v in tweights.flatten_params(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_reader_matches_pil(rng, tmp_path, mode, optimize):
    arr = rng.integers(0, 256, (23, 37, 4)).astype(np.uint8)
    arr[5:15, 4:30] = arr[5, 4]  # flat patches exercise every filter type
    img = Image.fromarray(arr, "RGBA").convert(mode)
    path = str(tmp_path / "x.png")
    img.save(path, optimize=optimize)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_png(path), ref)
    assert png_size(path) == (37, 23)


def test_png_writer_read_by_pil(rng, tmp_path):
    arr = rng.integers(0, 256, (19, 41, 3)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, arr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    np.testing.assert_array_equal(read_png(path), arr)
