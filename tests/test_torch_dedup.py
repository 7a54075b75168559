"""Stage 2 of the port (ops/similarity.py, pipeline/dedup.py) against the JAX
package's, on the CPU: the same seeded numpy embeddings through both
``find_duplicate_pairs`` and a brute-force oracle, then ``run_dedup`` and the
dedup CLI on stores written by either package's embed stage.

What must agree: the int8 wire's int32 sums are exact, so its pairs equal
the JAX package's in order and metric bit for bit (the per-row top-k breaks
ties toward the lower column on both sides); the fp16 wire sums in another
order than XLA, so its pairs agree as a set, with the metrics bit-identical
(both come from the same float32 host recheck); ``overflow_rows`` equal."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.config import DedupConfig as JaxDedupConfig
from clip_assisted_data_labeling_tpu.config import EmbedConfig
from clip_assisted_data_labeling_tpu.models import clip_weights as jweights
from clip_assisted_data_labeling_tpu.models import vit as jvit
from clip_assisted_data_labeling_tpu.ops import similarity as jsim
from clip_assisted_data_labeling_tpu.pipeline import dedup as jdedup
from clip_assisted_data_labeling_tpu.pipeline.embed import embed_dataset as jax_embed
from clip_assisted_data_labeling_tpu_torch import config as tconfig
from clip_assisted_data_labeling_tpu_torch.ops import similarity as tsim
from clip_assisted_data_labeling_tpu_torch.pipeline import dedup as tdedup
from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as port_embed_main


def _planted(rng, n, d, n_dupes, noise=0.01):
    emb = jsim.normalize_rows(rng.normal(0, 1, (n, d)).astype(np.float32))
    for _ in range(n_dupes):
        i = int(rng.integers(0, n - 1))
        j = int(rng.integers(i + 1, n))
        emb[j] = jsim.normalize_rows((emb[i] + rng.normal(0, noise, d))[None])[0]
    return emb


def _case(name):
    """(embeddings, kwargs) of each case, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "cosine":  # width 36 (padded to 40 for the int8 products), 4 panels
        return _planted(rng, 200, 36, 12), dict(threshold=0.97, row_block=64)
    if name == "cosine_one_panel":  # 203 rows: one panel of 208 on the port, 203 on JAX
        return _planted(rng, 203, 32, 12), dict(threshold=0.97)
    if name == "euclidean":  # metric > threshold: the most DISSIMILAR pairs
        return _planted(rng, 160, 32, 8), dict(threshold=1.62, sim_type="euclidean",
                                               row_block=64)
    if name == "euclidean_small":  # t² ≤ 2·slack on both wires: the scan counts every pair
        return _planted(rng, 96, 16, 8), dict(threshold=0.05, sim_type="euclidean",
                                              row_block=32)
    if name == "overflow":  # 40 copies of a row: 39 matches > max_per_row = 4
        emb = _planted(rng, 130, 16, 4)
        emb[50:90] = emb[49]
        return emb, dict(threshold=0.99, row_block=64, max_per_row=4)
    if name == "degenerate":  # a narrow cone: every row hits many others
        base = rng.normal(0, 1, (1, 24)).astype(np.float32)
        emb = base + rng.normal(0, 0.08, (150, 24)).astype(np.float32)
        return emb, dict(threshold=0.985, row_block=64)
    raise KeyError(name)


CASES = ["cosine", "cosine_one_panel", "euclidean", "euclidean_small", "overflow",
         "degenerate"]


def _oracle(emb, threshold, sim_type="cosine", **_):
    """Every pair above the threshold less THRESHOLD_SLACK (the band both
    packages keep, so that a pair at the threshold is never dropped)."""
    normed = jsim.normalize_rows(emb)
    sims = normed @ normed.T
    metric = np.sqrt(np.maximum(2.0 - 2.0 * sims, 0.0)) if sim_type == "euclidean" else sims
    iu, ju = np.triu_indices(len(emb), k=1)
    mask = metric[iu, ju] > threshold - jsim.THRESHOLD_SLACK
    return set(zip(iu[mask].tolist(), ju[mask].tolist()))


def _assert_same(port, ref, wire):
    if wire == "int8":
        assert port.pairs() == ref.pairs()
    else:
        assert set(port.pairs()) == set(ref.pairs())
    np.testing.assert_array_equal(port.overflow_rows, ref.overflow_rows)


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("name", CASES)
def test_find_duplicate_pairs_matches_jax_and_oracle(name, wire):
    emb, kw = _case(name)
    ref = jsim.find_duplicate_pairs(emb, wire=wire, **kw)
    got = tsim.find_duplicate_pairs(emb, wire=wire, device="cpu", **kw)
    _assert_same(got, ref, wire)
    assert set(zip(got.rows.tolist(), got.cols.tolist())) == _oracle(emb, **kw)
    assert len(got.rows) > 0
    if name == "overflow":
        assert len(got.overflow_rows) > 0  # k escalated, every pair recovered
    if name == "degenerate":
        assert len(np.unique(got.rows)) > 100


@pytest.mark.parametrize("wire", ["int8", "fp16"])
def test_chunked_extraction_matches_unchunked(monkeypatch, wire):
    """A budget that cuts the hit rows into chunks of 128 changes nothing."""
    emb, kw = _case("degenerate")
    whole = tsim.find_duplicate_pairs(emb, wire=wire, device="cpu", **kw)
    monkeypatch.setattr(tsim, "EXTRACT_BUDGET_ELEMS", 128 * 64)
    assert tsim.extract_chunk_size(64, 16) == 128
    chunked = tsim.find_duplicate_pairs(emb, wire=wire, device="cpu", **kw)
    assert len(np.unique(chunked.rows)) > 128  # more than one chunk
    assert chunked.pairs() == whole.pairs()
    monkeypatch.setattr(jsim, "EXTRACT_BUDGET_ELEMS", 128 * 64)
    _assert_same(chunked, jsim.find_duplicate_pairs(emb, wire=wire, **kw), wire)


def test_host_side_and_constants_match_jax(capsys):
    for name in ("THRESHOLD_SLACK", "INT8_SLACK", "FP16_SLACK", "EXTRACT_BUDGET_ELEMS"):
        assert getattr(tsim, name) == getattr(jsim, name), name
    for t in (0.05, 0.2, 0.9, 0.96, 1.2, 1.5):
        for euclidean in (False, True):
            for slack in (tsim.INT8_SLACK, tsim.FP16_SLACK):
                assert (tsim.wire_scan_threshold(t, euclidean, slack)
                        == jsim.wire_scan_threshold(t, euclidean, slack))
    counts = np.array([0, 3, 17, 200, 1])
    for m in (4, 16, 300):
        assert tsim._required_k(counts, m) == jsim._required_k(counts, m)
    for tile, k in ((8192, 16), (64, 16), (8192, 1 << 20)):
        assert tsim.extract_chunk_size(tile, k) == jsim.extract_chunk_size(tile, k)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (50, 24)).astype(np.float32)
    x[7] = 0
    n_t, n_j = tsim.normalize_rows(x), jsim.normalize_rows(x)
    np.testing.assert_array_equal(n_t, n_j)
    for a, b in zip(tsim.quantize_rows_int8(n_t), jsim.quantize_rows_int8(n_j)):
        np.testing.assert_array_equal(a, b)
    tsim.warn_if_degenerate(np.full(1000, 2000), 1000, 0.96, 0.94)
    jsim.warn_if_degenerate(np.full(1000, 2000), 1000, 0.96, 0.94)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1] and "WARNING" in out[0]
    dense = tsim.cosine_similarity_matrix(x[:5], x[5:9], device="cpu").numpy()
    np.testing.assert_allclose(dense, np.asarray(jsim.cosine_similarity_matrix(x[:5], x[5:9])),
                               atol=1e-6)


def test_wrong_wire_refused():
    with pytest.raises(ValueError):
        tsim.find_duplicate_pairs(np.ones((4, 8), np.float32), wire="bf16", device="cpu")


# ---- run_dedup and the CLI on embedded datasets -------------------------------------

MODEL = "ViT-Test/tiny"


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    """6 distinguishable JPEGs plus byte-identical copies of two of them,
    embedded by the port's CLI and by the JAX embed (same weights) into two
    datasets; returns {writer: dataset dir}."""
    base = tmp_path_factory.mktemp("torch_dedup")
    src = base / "src"
    src.mkdir()
    rng = np.random.default_rng(11)
    for i in range(6):
        arr = rng.integers(0, 256, (96 + 8 * i, 120, 3)).astype(np.uint8)
        arr[:, :60] = (41 * i) % 255
        Image.fromarray(arr).save(src / f"img_{i:02d}.jpg", quality=95)
    shutil.copy(src / "img_01.jpg", src / "zz_copy_a.jpg")
    shutil.copy(src / "img_04.jpg", src / "zz_copy_b.jpg")
    weights = base / "weights"
    weights.mkdir()
    params = jvit.init_vit_params(jvit.resolve_config(MODEL), jax.random.key(7))
    jweights.save_params_npz(str(weights / "ViT-Test-tiny.npz"), params)
    roots = {}
    for writer in ("port", "jax"):
        root = base / writer / "mydata"
        shutil.copytree(src, root)
        if writer == "port":
            port_embed_main(["--root_dir", str(root), "--models_to_use", MODEL,
                             "--device", "cpu", "--model_path", str(weights),
                             "--batch_size", "4", "--num_workers", "2",
                             "--canvas_size", "256", "--compute_dtype", "bfloat16"])
        else:
            jax_embed(str(root), EmbedConfig(models_to_use=(MODEL,), batch_size=4,
                                             num_workers=2, canvas_size=256,
                                             model_path=str(weights),
                                             compute_dtype="bfloat16"))
        roots[writer] = root
    return roots


def _copy_dataset(root, dest):
    """A fresh copy of an embedded dataset (move mode changes it)."""
    out = dest / "data" / "mydata"
    shutil.copytree(root, out)
    return out


def _outputs(root, threshold):
    d = root.parent / f"near_duplicates_cosine_{threshold}"
    return sorted(os.listdir(d)) if d.exists() else []


@pytest.mark.parametrize("entry", ["run_dedup", "cli"])
@pytest.mark.parametrize("mode", ["copy", "move"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_run_dedup_matches_jax(embedded, tmp_path, writer, mode, entry):
    """The same pairs, in order, and the same copied or moved file names as
    the JAX package's run_dedup (single-device path), on a store written by
    either package; the byte-identical copies are among the pairs."""
    threshold = 0.999
    jroot = _copy_dataset(embedded[writer], tmp_path / "jax")
    proot = _copy_dataset(embedded[writer], tmp_path / "port")
    ref = jdedup.run_dedup(str(jroot), JaxDedupConfig(threshold=threshold, mode=mode),
                           use_mesh=False)
    if entry == "cli":
        got = tdedup.main(["--root_dir", str(proot), "--threshold", str(threshold),
                           "--mode", mode, "--device", "cpu"])
    else:
        got = tdedup.run_dedup(str(proot), tconfig.DedupConfig(threshold=threshold, mode=mode),
                               device="cpu")
    assert got.pairs() == ref.pairs()
    paths, _ = tdedup.load_embeddings(str(embedded[writer]), tconfig.DedupConfig())
    names = {frozenset((os.path.basename(paths[i]), os.path.basename(paths[j])))
             for i, j, _ in got.pairs()}
    assert {frozenset(("img_01.jpg", "zz_copy_a.jpg")),
            frozenset(("img_04.jpg", "zz_copy_b.jpg"))} <= names
    assert _outputs(proot, threshold) == _outputs(jroot, threshold) != []
    assert sorted(os.listdir(proot)) == sorted(os.listdir(jroot))


def test_load_embeddings_matches_jax(embedded, tmp_path):
    """Store first; without a store, the sidecar fallback (a stem with a .jpg
    and a .pt) gives the JAX package's paths and rows."""
    cfg_t, cfg_j = tconfig.DedupConfig(), JaxDedupConfig()
    for writer, root in embedded.items():
        pt, et = tdedup.load_embeddings(str(root), cfg_t)
        pj, ej = jdedup.load_embeddings(str(root), cfg_j)
        assert pt == pj and len(pt) == 8
        np.testing.assert_array_equal(et, ej)
    root = _copy_dataset(embedded["port"], tmp_path)
    shutil.rmtree(root / ".ctpu_store")
    pt, et = tdedup.load_embeddings(str(root), cfg_t)
    pj, ej = jdedup.load_embeddings(str(root), cfg_j)
    assert pt == pj and len(pt) == 8
    np.testing.assert_array_equal(et, ej)


def test_cli_refuses_distributed_and_a_missing_card(tmp_path, monkeypatch, capsys):
    """--distributed is accepted: without a coordinator the process group is
    (0, 1) and the run is the one-process run; without --device the CLI asks
    for the card and raises where there is none."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    res = tdedup.main(["--root_dir", str(tmp_path), "--distributed", "--device", "cpu"])
    assert res.rows.size == 0 and not torch.distributed.is_initialized()
    assert "torch.distributed up: process 0/1" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdedup.main(["--root_dir", str(tmp_path)])
