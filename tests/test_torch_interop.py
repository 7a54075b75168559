"""On-disk interop between the port and the JAX package, both directions:
sidecars, the columnar store, .calib.npz and .npz weights; and the port's
PNG reader against PIL."""
import jax
import numpy as np
import pytest
from PIL import Image

from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import encoders as jenc
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.store import columnar as jcol
from clip_assisted_data_labeling_tpu.store import sidecar as jside
from clip_assisted_data_labeling_tpu_torch.data.png import png_size, read_png, write_png
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models import encoders as tenc
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.store import columnar as tcol
from clip_assisted_data_labeling_tpu_torch.store import sidecar as tside

CROPS = ["centre_crop", "square_padded_crop", "subcrop1_0.15", "subcrop2_0.1"]
WRITERS = {"port": (tside, tcol), "jax": (jside, jcol)}


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
