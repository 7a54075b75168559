"""The port's embed flags and host decoders against the JAX package:
``--exact_stats`` (the host cv2 stats from each file at its original
resolution, against the JAX ``image_stats_reference``), ``--aspect native``
(the fifth pseudo-crop through the naflex masked path, against a JAX embed
of the same files and ``.npz`` weights), ``--debug_nans`` (the first block
with a NaN named in a ``FloatingPointError``; nothing changes when off),
``--profile_dir`` (a Chrome trace of the run), and the native JPEG decoder
(built with g++ and libjpeg where both exist, else the loader's cv2/PIL
path with a warning)."""
import json
import logging
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from clip_assisted_data_labeling_tpu.config import EmbedConfig
from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops.image_stats import (
    image_stats_reference as jax_image_stats_reference,
)
from clip_assisted_data_labeling_tpu.pipeline.embed import embed_dataset as jax_embed
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu_torch.data import loader as tloader
from clip_assisted_data_labeling_tpu_torch.data import native_loader
from clip_assisted_data_labeling_tpu_torch.models import clip_weights as tweights
from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import (
    IMG_STAT_KEYS,
    image_stats_reference,
)
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main
from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar
from tests.test_torch_pe import _np_params


def _write_images(directory, rng, sizes, ext=".jpg"):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 60.0 + 30 * i)],
                               -1) + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        p = os.path.join(directory, f"img_{i:02d}{ext}")
        Image.fromarray(img).save(p, **({"quality": 92} if ext == ".jpg" else {}))
        paths.append(p)
    return paths


def jax_tree_copy(params: dict) -> dict:
    """A writable copy of a (nested) dict of arrays."""
    return {k: jax_tree_copy(v) if isinstance(v, dict) else np.array(v)
            for k, v in params.items()}


def _embed(root, *extra, model="ViT-Test/tiny", dtype="float32"):
    return port_embed_main(["--root_dir", str(root), "--models_to_use", model, "--device",
                            "cpu", "--compute_dtype", dtype, "--batch_size", "4",
                            "--num_workers", "2", "--canvas_size", "256", *extra])[model]


@pytest.mark.parametrize("shape", [(90, 130), (600, 200), (40, 40), (1000, 800)])
def test_image_stats_reference_equals_jax(rng, shape):
    img = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    assert image_stats_reference(img) == jax_image_stats_reference(img)


def test_exact_stats_from_original_resolution(tmp_path, rng):
    """--exact_stats re-decodes each file at its original resolution (one is
    larger than the 256 canvas, so the canvas copy would be downscaled): the
    store's stats within 1e-5 of the JAX reference on each file; without the
    flag the device stats (the canvas) differ for the large image."""
    paths = _write_images(tmp_path / "d", rng, [(120, 90), (700, 300), (64, 200)])
    store = _embed(tmp_path / "d", "--exact_stats")
    stats = np.array(store.img_stats, np.float32)  # a copy: the next run rewrites the file
    for i, rel in enumerate(store.rel_paths()):
        want = jax_image_stats_reference(np.asarray(Image.open(tmp_path / "d" / rel).convert("RGB")))
        np.testing.assert_allclose(stats[i], [want[k] for k in IMG_STAT_KEYS], atol=1e-5,
                                   err_msg=rel)
    assert len(paths) == len(store.rel_paths())
    exact_big = stats[store.rel_paths().index("img_01.jpg")]
    dstore = _embed(tmp_path / "d", "--force_reencode")  # its own (shuffled) row order
    device_big = np.asarray(dstore.img_stats, np.float32)[dstore.rel_paths().index("img_01.jpg")]
    assert np.abs(device_big - exact_big).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_aspect_native_cli_matches_jax_embed(tmp_path, rng, capsys, dtype):
    """--aspect native on the tiny naflex tower: the store and sidecars hold
    the four crops and 'native_aspect', each sidecar row within 1e-5
    (float32; the int8 modes run bfloat16 with the JAX package's message,
    then within the bf16 limit) of a JAX embed's of the same files and .npz
    weights; a fixed-resolution tower refuses the flag."""
    model = "SigLIP2-Naflex-Test/tiny"
    weights = tmp_path / "w"
    weights.mkdir()
    jweights.save_params_npz(str(weights / "SigLIP2-Naflex-Test-tiny.npz"),
                             _np_params(jvit.resolve_config(model), rng, seed=41))
    _write_images(tmp_path / "p" / "d", rng, [(80, 200), (150, 60), (100, 100), (300, 500), (50, 90)])
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    store = _embed(tmp_path / "p" / "d", "--aspect", "native", "--model_path", str(weights),
                   model=model, dtype=dtype)
    if dtype == "int8":
        assert "--aspect native has no int8 formulation; running bfloat16" in capsys.readouterr().out
    assert store.meta["crop_names"][-1] == "native_aspect"
    jcfg = EmbedConfig(models_to_use=(model,), batch_size=4, num_workers=2, canvas_size=256,
                       model_path=str(weights), compute_dtype=dtype, shuffle_filenames=False,
                       aspect="native")
    jax_embed(str(tmp_path / "j" / "d"), jcfg)
    names = list(store.meta["crop_names"])
    assert JaxStore.open(str(tmp_path / "p" / "d"), model).embeddings.shape == (5, 5, 64)
    limit = 1e-5 if dtype == "float32" else 1e-3
    for u in store.uuids:
        got, want = (read_sidecar(str(tmp_path / pkg / "d" / f"{u}.pt"))[model]
                     for pkg in ("p", "j"))
        assert {k for k in got if not k.startswith("img_stat")} == set(names)
        pe, je = (np.stack([np.asarray(d[c], np.float32).reshape(-1) for c in names])
                  for d in (got, want))
        cos = np.sum(pe * je, axis=-1) / np.linalg.norm(pe, axis=-1) / np.linalg.norm(je, axis=-1)
        assert np.all(cos >= 1 - limit), f"{u}: cosine {cos}"
    with pytest.raises(ValueError, match="requires a naflex tower"):
        _embed(tmp_path / "p" / "d", "--aspect", "native", "--force_reencode")


def test_debug_nans_names_the_block(tmp_path, rng):
    """With one NaN in block 1's fc2 weights, --debug_nans raises
    FloatingPointError naming block 1 (the JAX run raises under
    jax_debug_nans); without the flag the NaN runs through to the store.
    On sound weights the flag changes no embedding."""
    model = "ViT-Test-HF/tiny"
    _write_images(tmp_path / "d", rng, [(90, 60), (64, 64)])
    params = jax_tree_copy(_np_params(jvit.resolve_config(model), rng, seed=42))
    good = tmp_path / "good"
    good.mkdir()
    jweights.save_params_npz(str(good / "ViT-Test-HF-tiny.npz"), params)
    params["blocks"]["fc2_kernel"][1, 0, 0] = np.nan
    bad = tmp_path / "bad"
    bad.mkdir()
    jweights.save_params_npz(str(bad / "ViT-Test-HF-tiny.npz"), params)
    with pytest.raises(FloatingPointError, match=r"block 1 \(of 3\)"):
        _embed(tmp_path / "d", "--debug_nans", "--model_path", str(bad), model=model)
    store = _embed(tmp_path / "d", "--model_path", str(bad), "--force_reencode", model=model)
    assert np.isnan(np.asarray(store.embeddings, np.float32)).all()
    runs = []
    for flag in ((), ("--debug_nans",)):  # rows by uuid: each run shuffles the file order
        st = _embed(tmp_path / "d", "--model_path", str(good), "--force_reencode", *flag,
                    model=model)
        runs.append({u: np.array(st.embeddings[i], np.float32) for i, u in enumerate(st.uuids)})
    for u, emb in runs[0].items():
        np.testing.assert_array_equal(runs[1][u], emb)


def test_debug_nans_in_the_naflex_path(rng):
    """encode_variable checks its blocks too."""
    model = "SigLIP2-Naflex-Test/tiny"
    params = jax_tree_copy(tweights.flatten_params(_np_params(jvit.resolve_config(model), rng,
                                                              seed=43)))
    params["blocks/qkv_kernel"][0, 0, :] = np.nan
    enc = CLIPImageEncoder(model, params=params, compute_dtype="float32", device="cpu",
                           debug_nans=True)
    with pytest.raises(FloatingPointError, match=r"block 0 \(of 2\)"):
        enc.encode_variable([rng.integers(0, 256, (40, 90, 3), dtype=np.uint8)])


def test_profile_dir_writes_a_trace(tmp_path, rng):
    _write_images(tmp_path / "d", rng, [(70, 70), (90, 40)])
    _embed(tmp_path / "d", "--profile_dir", str(tmp_path / "prof"))
    trace = tmp_path / "prof" / "embed_trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    # the port's spans and layer ranges are on under --profile_dir
    assert {"ctpu.loader_wait", "ctpu.forward", "ctpu.block"} <= names


needs_toolchain = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists("/usr/include/jpeglib.h"),
    reason="the native decoder needs g++ and libjpeg's header")


@needs_toolchain
def test_native_decoder_matches_the_cv2_path(tmp_path, rng):
    """Where g++ and libjpeg exist the loader takes the native decoder for
    JPEGs (the decoder counter says so) and the cv2/PIL path for the rest
    (a PNG; a corrupt .jpg is skipped by both). The batch's canvases within
    a mean |Δ| < 1 of the cv2 path's, as tests/test_native_loader.py holds
    the JAX package's, and so is each image that fits the canvas (a larger
    one is decoded at a DCT prescale, then area-filtered: another chain)."""
    paths = _write_images(tmp_path, rng, [(120, 90), (600, 900), (64, 200), (300, 300)])
    paths += _write_images(tmp_path / "png", rng, [(80, 50)], ext=".png")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    paths.append(str(bad))
    kw = dict(canvas_size=256, out_size=32, batch_size=8, num_workers=2)
    nat = tloader.BatchedImageLoader(paths, **kw)
    ref = tloader.BatchedImageLoader(paths, use_native=False, **kw)
    nb, rb = next(iter(nat)), next(iter(ref))
    assert native_loader.get_lib() is not None and native_loader.build_error() is None
    assert nat.decoders == {"native": 4, tloader.decoder_name(): 1}
    assert ref.decoders == {tloader.decoder_name(): 5}
    assert nb.paths == rb.paths and nat.skipped == ref.skipped == [str(bad)]
    np.testing.assert_allclose(nb.crop_params, rb.crop_params, atol=1e-5)
    diff = np.abs(nb.canvas.astype(int) - rb.canvas.astype(int))
    assert diff.mean() < 1.0
    for i, p in enumerate(nb.paths):
        if p.endswith(("img_00.jpg", "img_02.jpg")):  # within the 256 canvas
            assert diff[i].mean() < 1.0


def test_native_decoder_build_failure_falls_back(tmp_path, rng, monkeypatch, caplog):
    """A decoder that cannot be built (here: its source missing) is logged
    at warning level with the reason, and the loader decodes with cv2/PIL."""
    monkeypatch.setattr(native_loader, "SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native_loader, "_state", {"lib": None, "tried": False, "error": None})
    paths = _write_images(tmp_path, rng, [(50, 70)])
    with caplog.at_level(logging.WARNING):
        batch = next(iter(tloader.BatchedImageLoader(paths, canvas_size=128, out_size=32,
                                                     batch_size=2, num_workers=1)))
    assert batch.n_valid == 1
    assert "missing.cpp is missing" in native_loader.build_error()
    assert "native JPEG decoder unavailable" in caplog.text
    assert native_loader.decode_batch_native(paths, 128) is None

