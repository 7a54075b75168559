"""The port's seven tools (``clip_assisted_data_labeling_tpu_torch/tools``)
against the JAX package's on the CPU, on the same inputs made from a numpy
seed: the sidecar dump's stdout, the seeded subset's stems and tree, the
quarantine's verdicts (with PIL, and with the port's own check where PIL is
hidden), the merge's CSVs and moved trees, the similarity search's results
and copies (store-backed and sidecar walk, both measures), the SVM's margins
(the port's float64 Newton solver against sklearn's LinearSVC), the latent
loader and the latent regressor's checkpoint; then the device tools'
refusal without a card and the tools' imports."""
import contextlib
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.models.regressor import SimpleFCRegressor as JaxRegressor
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu.store.sidecar import write_sidecar as jax_write_sidecar
from clip_assisted_data_labeling_tpu.tools import find_similar_imgs as jfind
from clip_assisted_data_labeling_tpu.tools import fix_img_dir as jfix
from clip_assisted_data_labeling_tpu.tools import investigate_embedding as jinv
from clip_assisted_data_labeling_tpu.tools import merge_datasets as jmerge
from clip_assisted_data_labeling_tpu.tools import move_subset_of_files as jmove
from clip_assisted_data_labeling_tpu.tools import svm_similarity as jsvm
from clip_assisted_data_labeling_tpu.tools import train_latent_regressor as jlat
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar
from clip_assisted_data_labeling_tpu_torch.tools import find_similar_imgs as tfind
from clip_assisted_data_labeling_tpu_torch.tools import fix_img_dir as tfix
from clip_assisted_data_labeling_tpu_torch.tools import investigate_embedding as tinv
from clip_assisted_data_labeling_tpu_torch.tools import merge_datasets as tmerge
from clip_assisted_data_labeling_tpu_torch.tools import move_subset_of_files as tmove
from clip_assisted_data_labeling_tpu_torch.tools import svm_similarity as tsvm
from clip_assisted_data_labeling_tpu_torch.tools import train_latent_regressor as tlat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("ViT-B-32/openai", "ViT-L-14/openai")
CROP = "square_padded_crop"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the suite's
    other workers, so these tests run on one (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _tree(root) -> dict:
    """Relative path → bytes of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ---- investigate_embedding -------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_investigate_embedding_prints_what_the_jax_tool_prints(writer, tmp_path, rng):
    path = str(tmp_path / "u.pt")
    write = jax_write_sidecar if writer == "jax" else write_sidecar
    for m, dim in zip(MODELS, (8, 12)):
        write(path, m, {CROP: rng.normal(0, 1, dim), "centre_crop": rng.normal(0, 1, dim)},
              img_stats={"img_stat_mean": float(rng.uniform()), "img_stat_std": 3.25})
    _, want = _stdout(jinv.main, [path])
    _, got = _stdout(tinv.main, [path])
    assert got == want and "scalar 3.250000" in got and "dtype=float32" in got
    nested = {"a": {"b": np.float32(1.5), "c": np.zeros((2, 3), np.float16)}, "d": 2.0}
    assert _stdout(tinv.print_structure, nested)[1] == _stdout(jinv.print_structure, nested)[1]
    # the JAX tool's scalars may be floats, the port's sidecar reader gives 0-d arrays
    assert tinv._describe(0.125) == tinv._describe(np.float32(0.125)) == "scalar 0.125000"


# ---- move_subset_of_files ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fraction", [0.3, 1.0])
def test_move_subset_same_stems_and_tree(seed, fraction, tmp_path, rng):
    root = tmp_path / "root"
    for i in range(40):
        sub = root / ("a" if i % 3 else "b/c")
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"s{i:02d}.jpg").write_bytes(rng.bytes(8))
        if i % 2:
            (sub / f"s{i:02d}.pt").write_bytes(rng.bytes(4))
        (sub / f"s{i:02d}.txt").write_bytes(b"other extension")
    exts = [".jpg", ".pt"]
    groups = tmove.group_by_stem(str(root), exts)
    assert groups == jmove.group_by_stem(str(root), exts)
    assert tmove.sample_groups(groups, fraction, seed) == jmove.sample_groups(
        groups, fraction, seed)
    outs = {}
    for name, mod in (("jax", jmove), ("torch", tmove)):
        out = tmp_path / name
        outs[name] = _stdout(mod.main, ["--root_dir", str(root), "--out_dir", str(out),
                                        "--fraction_f", str(fraction), "--seed", str(seed),
                                        "--file_extensions", *exts])[1].replace(str(out), "OUT")
    assert outs["torch"] == outs["jax"]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert (len(_tree(tmp_path / "torch")) == 60) == (fraction == 1.0)


# ---- fix_img_dir --------------------------------------------------------------------

def _png(rng, size=(9, 7)) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, size + (3,)).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _jpeg(rng, size=(16, 24)) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, size + (3,)).astype(np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def _end_of_segment(data: bytes, marker: int) -> int:
    """The offset just past the first ``marker`` segment of a JPEG."""
    pos = data.index(bytes([0xFF, marker]), 2)
    (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
    return pos + 2 + n


def crafted_images(rng) -> dict[str, bytes]:
    """Readable and unreadable files of the image extensions: PNG and JPEG,
    a PNG named .jpg, a zero-byte file, junk, a PNG with a broken CRC, one
    cut before IEND, a JPEG cut after its SOF and one cut inside its scan
    data, an IHDR of a bit depth PIL does not open; and a .txt, which the
    tool ignores."""
    png, jpg = _png(rng), _jpeg(rng)
    bad_crc = bytearray(png)
    bad_crc[29] ^= 0xFF  # inside IHDR's CRC
    ihdr = struct.pack(">IIBBBBB", 3, 3, 3, 2, 0, 0, 0)  # 3-bit RGB
    odd_depth = png[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr + struct.pack(
        ">I", zlib.crc32(b"IHDR" + ihdr)) + png[33:]
    return {
        "a_ok.png": png, "b_ok.jpg": jpg, "c_png_named.jpg": _png(rng), "d_zero.png": b"",
        "e_junk.jpeg": rng.bytes(64), "f_bad_crc.png": bytes(bad_crc),
        "g_no_iend.PNG": png[:-12 - 5], "h_cut_after_sof.jpg": jpg[:_end_of_segment(jpg, 0xC0)],
        "i_cut_in_scan.jpg": jpg[:_end_of_segment(jpg, 0xDA) + 20],
        "j_odd_depth.png": odd_depth, "k_notes.txt": b"not an image",
    }


def _quarantine(mod, src, tmp) -> tuple[list, str]:
    return _stdout(mod.quarantine_unreadable, str(src), str(tmp))


@pytest.mark.parametrize("pil", ["with PIL", "without PIL"])
def test_fix_img_dir_quarantines_what_the_jax_tool_does(pil, tmp_path, rng, monkeypatch):
    files = crafted_images(rng)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        for name, data in files.items():
            (tmp_path / side / name).write_bytes(data)
    if pil == "without PIL":
        monkeypatch.setattr(tfix, "Image", None)
    want, want_out = _quarantine(jfix, tmp_path / "jax", tmp_path / "jax_q")
    got, got_out = _quarantine(tfix, tmp_path / "torch", tmp_path / "torch_q")
    assert got == want == ["d_zero.png", "e_junk.jpeg", "f_bad_crc.png", "g_no_iend.PNG",
                           "h_cut_after_sof.jpg", "j_odd_depth.png"]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert _tree(tmp_path / "torch_q") == _tree(tmp_path / "jax_q")
    if pil == "with PIL":  # PIL's messages name the path
        assert got_out.replace(str(tmp_path / "torch"), "SRC") == \
            want_out.replace(str(tmp_path / "jax"), "SRC")
    else:  # the same lines, the error messages the port's own
        assert [ln for ln in got_out.splitlines() if ln.startswith("Moved")] == \
            [ln for ln in want_out.splitlines() if ln.startswith("Moved")]


def _pil_verdict(path) -> bool:
    try:
        with Image.open(path) as img:
            img.verify()
        return True
    except Exception:
        return False


def test_verify_image_agrees_with_pil_on_cut_and_flipped_files(tmp_path, rng):
    """Every prefix of a PNG and of a baseline and a progressive JPEG, and
    files with one to three bytes changed near their headers: the port's
    check says readable exactly where PIL's open + verify does."""
    bases = [_png(rng, (5, 6)), _jpeg(rng, (8, 8))]
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)).save(
        buf, "JPEG", progressive=True)
    bases.append(buf.getvalue())
    cases = [b[:k] for b in bases for k in range(0, len(b) + 1, 3)]
    for b in bases:
        for _ in range(150):
            m = bytearray(b)
            for _k in range(int(rng.integers(1, 4))):
                m[int(rng.integers(0, min(len(m), 300)))] = int(rng.integers(0, 256))
            cases.append(bytes(m))
    path = str(tmp_path / "x.bin")
    disagree = []
    for c in cases:
        with open(path, "wb") as f:
            f.write(c)
        try:
            tfix.verify_image(path)
            ours = True
        except (OSError, ValueError):
            ours = False
        if ours != _pil_verdict(path):
            disagree.append(c[:48])
    assert not disagree


def test_fix_img_dir_known_difference_other_formats(tmp_path, rng, monkeypatch):
    """Pinned (ROADMAP.md, Known differences): without PIL the port reads
    PNG and JPEG content only, so a BMP named .jpg, which PIL opens, is
    quarantined; with PIL both tools keep it."""
    src = tmp_path / "imgs"
    src.mkdir()
    Image.fromarray(rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)).save(src / "bmp.jpg", "BMP")
    assert _quarantine(tfix, src, tmp_path / "q")[0] == []
    monkeypatch.setattr(tfix, "Image", None)
    assert _quarantine(tfix, src, tmp_path / "q")[0] == ["bmp.jpg"]


# ---- merge_datasets -----------------------------------------------------------------

def _write_dataset(data, name: str, rows: list[dict], rng) -> None:
    (data / name).mkdir(parents=True)
    pd.DataFrame(rows).to_csv(data / f"{name}.csv", index=False)
    for r in rows:
        for ext in (".jpg", ".pt"):
            (data / name / f"{r['uuid']}{ext}").write_bytes(rng.bytes(6))


def _datasets(data, rng) -> None:
    """Three datasets: labelled/unlabelled halves, all-integer timestamps
    in two of them and a gap in the third, an extra column only one has,
    an all-digit uuid with a leading zero, and one uuid in two datasets."""
    for k, name in enumerate(("ds_a", "ds_b", "ds_c")):
        rows = []
        for i in range(8):
            rows.append({
                "uuid": "0042" if (k, i) in ((0, 1), (2, 3)) else f"{name}_{i:03d}",
                "label": float(np.round(rng.uniform(0, 9), 1)) if i % 2 else np.nan,
                "timestamp": (np.nan if (k == 2 and i == 5) else 1700000000 + 1000 * k + i),
                "predicted_label": float(np.round(rng.uniform(), 6)),
            })
            if k == 1:
                rows[-1]["note"] = "x,y" if i % 3 else ""
        _write_dataset(data, name, rows, rng)


@pytest.mark.parametrize("move", [True, False])
def test_merge_datasets_same_csvs_and_trees(move, tmp_path, rng):
    for side in ("jax", "torch"):
        _datasets(tmp_path / side / "data", np.random.default_rng(3))
    runs = {}
    for side, mod in (("jax", jmerge), ("torch", tmerge)):
        base = tmp_path / side
        args = ["--data_dir", str(base / "data"), "--output_dir", str(base / "out")]
        runs[side] = _stdout(mod.main, args + ([] if move else ["--copy"]))[1].replace(
            str(base), "BASE")
    assert runs["torch"] == runs["jax"] and "WARNING: 2 files shared a uuid" in runs["torch"]
    for csv_name in ("labeled.csv", "unlabeled.csv"):
        j = pd.read_csv(tmp_path / "jax" / "out" / csv_name, dtype={"uuid": str})
        t = pd.read_csv(tmp_path / "torch" / "out" / csv_name, dtype={"uuid": str})
        assert list(t.columns) == list(j.columns)
        assert t["uuid"].tolist() == j["uuid"].tolist()
        assert ("0042" in t["uuid"].tolist()) == (csv_name == "labeled.csv")
        for col in j.columns:
            assert t[col].isna().tolist() == j[col].isna().tolist(), col
        pd.testing.assert_frame_equal(t, j)
        assert (tmp_path / "torch" / "out" / csv_name).read_bytes() == \
            (tmp_path / "jax" / "out" / csv_name).read_bytes()
    for side in ("out", "data"):
        assert _tree(tmp_path / "torch" / side) == _tree(tmp_path / "jax" / side)
    assert "ds_c_0042.jpg" in os.listdir(tmp_path / "torch" / "out" / "labeled")


def test_merge_datasets_integer_timestamps_byte_equal(tmp_path, rng):
    """All-integer columns stay integers (``1700000000``, not ``1.0``),
    exactly as pandas writes them; the return values carry the split."""
    outs = {}
    for side, mod in (("jax", jmerge), ("torch", tmerge)):
        data = tmp_path / side / "data"
        rows = [{"uuid": f"u{i}", "label": (i if i % 2 else np.nan), "timestamp": 1700000000 + i}
                for i in range(6)]
        _write_dataset(data, "only", rows, np.random.default_rng(0))
        labeled, unlabeled = _stdout(mod.merge_datasets, str(data), str(tmp_path / side / "o"))[0]
        outs[side] = (len(labeled), len(unlabeled))
    assert outs["torch"] == outs["jax"] == (3, 3)
    for name in ("labeled.csv", "unlabeled.csv"):
        t = (tmp_path / "torch" / "o" / name).read_bytes()
        assert t == (tmp_path / "jax" / "o" / name).read_bytes()
        assert b",1700000001," in t or b",1700000000," in t


def test_merge_datasets_without_csvs(tmp_path):
    (tmp_path / "data" / "empty").mkdir(parents=True)
    want = _stdout(jmerge.merge_datasets, str(tmp_path / "data"), str(tmp_path / "j"))
    got = _stdout(tmerge.merge_datasets, str(tmp_path / "data"), str(tmp_path / "t"))
    assert got[0] == want[0] == (None, None) and got[1] == want[1]


# ---- find_similar_imgs --------------------------------------------------------------

def _search_set(root, source: str, rng, base: np.ndarray) -> None:
    """20 search rows (two models, CROP of 8 and 12), the first 4 near the
    context direction; with ``source="store"`` the columnar stores only,
    row 3 (the nearest of all) invalid, else one sidecar a row; one .jpg a
    row except row 19."""
    root.mkdir(parents=True)
    n = 20
    uuids = [f"s{i:02d}" for i in range(n)]
    embs = {}
    for m, dim in zip(MODELS, (8, 12)):
        e = rng.normal(0, 1, (n, dim)).astype(np.float32)
        e[:4] += 3 * base[:dim]
        e[3] = base[:dim]
        embs[m] = e
    if source == "store":
        for m, e in embs.items():
            st = JaxStore.create(str(root), m, [CROP, "centre_crop"], e.shape[1], uuids,
                                 dtype="float32", with_stats=False)
            st.write_rows(0, np.stack([e, e], axis=1),
                          valid=np.arange(n) != 3)
            st.flush()
    else:
        for i, u in enumerate(uuids):
            for m, e in embs.items():
                write_sidecar(str(root / f"{u}.pt"), m, {CROP: e[i]})
    for u in uuids[:-1]:
        (root / f"{u}.jpg").write_bytes(u.encode())


def _context(root, rng, base, n: int = 3) -> None:
    root.mkdir(parents=True)
    for i in range(n):
        for m, dim in zip(MODELS, (8, 12)):
            jax_write_sidecar(str(root / f"c{i}.pt"), m,
                              {CROP: base[:dim] + rng.normal(0, 0.1, dim)})


@pytest.mark.parametrize("source", ["store", "sidecars"])
@pytest.mark.parametrize("measure", ["cosine", "l2"])
@pytest.mark.parametrize("models", [["all"], [MODELS[1]]])
def test_find_similar_imgs_same_results_and_copies(source, measure, models, tmp_path, rng):
    base = rng.normal(0, 1, 12).astype(np.float32)
    _context(tmp_path / "ctx", rng, base)
    _search_set(tmp_path / "search", source, rng, base)
    runs = {}
    for name, fn, kw in (("jax", jfind.find_similar_imgs, {}),
                         ("torch", tfind.find_similar_imgs, {"device": "cpu"})):
        out = tmp_path / f"out_{name}"
        res, printed = _stdout(fn, str(tmp_path / "ctx"), str(tmp_path / "search"), str(out),
                               models, CROP, measure, 6, **kw)
        runs[name] = (res, printed.replace(str(out), "OUT"), sorted(os.listdir(out)))
    (jres, jout, jfiles), (tres, tout, tfiles) = runs["jax"], runs["torch"]
    assert [p for _, p in tres] == [p for _, p in jres]
    np.testing.assert_allclose([d for d, _ in tres], [d for d, _ in jres], rtol=0, atol=1e-6)
    assert tfiles == jfiles and tout == jout
    names = [os.path.basename(p) for _, p in tres]
    assert ("s03.jpg" in names) == (source == "sidecars") and "s19.jpg" not in names


def test_find_similar_imgs_cli_one_context_a_subdir(tmp_path, rng):
    base = rng.normal(0, 1, 12).astype(np.float32)
    for sub in ("p", "q"):
        _context(tmp_path / "ctx" / sub, rng, base if sub == "p" else -base, n=2)
    _search_set(tmp_path / "search", "sidecars", rng, base)
    for name, mod, extra in (("jax", jfind, []), ("torch", tfind, ["--device", "cpu"])):
        _stdout(mod.main, ["--context_dir", str(tmp_path / "ctx"), "--search_dir",
                           str(tmp_path / "search"), "--top_n", "3",
                           "--output_dir", str(tmp_path / name)] + extra)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    ctx = np.stack([base, 2 * base])
    emb = rng.normal(0, 1, (50, 12)).astype(np.float32)
    for measure in ("cosine", "l2"):
        np.testing.assert_allclose(tfind.compute_distances(ctx[0], emb, measure, "cpu"),
                                   jfind.compute_distances(ctx[0], emb, measure),
                                   rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tfind.compute_distances(ctx[0], emb, "dot", "cpu")


def test_existing_is_os_path_exists(tmp_path):
    """The listing-based check gives ``os.path.exists``'s answer for files,
    directories, missing names, valid and broken symlinks, and paths under a
    directory that does not exist."""
    d = tmp_path / "d"
    (d / "sub.jpg").mkdir(parents=True)
    (d / "a.jpg").write_bytes(b"x")
    (d / "ok_link.jpg").symlink_to(d / "a.jpg")
    (d / "broken.jpg").symlink_to(d / "gone.jpg")
    paths = [str(d / n) for n in ("a.jpg", "sub.jpg", "ok_link.jpg", "broken.jpg", "none.jpg")]
    paths += [str(tmp_path / "nodir" / "a.jpg"), "relative_missing.jpg"]
    assert tfind.existing(paths) == [os.path.exists(p) for p in paths] == [
        True, True, True, False, False, False, False]


# ---- svm_similarity -------------------------------------------------------------------

@pytest.mark.parametrize("n_ctx, n_search, dim", [(5, 200, 16), (12, 400, 96), (3, 10, 64)])
def test_svm_rank_margins_match_sklearn(n_ctx, n_search, dim, rng):
    """The port's float64 Newton solver of liblinear's problem against the
    JAX tool's ``LinearSVC``: margins within 1e-5 absolute, the same top 30
    (the last shape has fewer rows than features)."""
    base = rng.normal(0, 1, dim)
    ctx = (base + rng.normal(0, 1, (n_ctx, dim))).astype(np.float32)
    search = rng.normal(0, 1, (n_search, dim)).astype(np.float32)
    search[: n_search // 10] += base.astype(np.float32)
    info = {}
    got = tsvm.svm_rank(ctx, search, device="cpu", info=info)
    want = jsvm.svm_rank(ctx, search)
    assert got.dtype == np.float64 and got.shape == (n_search,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top = min(30, n_search)
    assert np.argsort(-got)[:top].tolist() == np.argsort(-want)[:top].tolist()
    assert info["converged"] and info["grad_norm"] <= 1e-8 * info["grad_norm_0"]


def test_svm_rank_says_when_it_stops_short(rng):
    base = rng.normal(0, 1, 16)
    ctx = (base + rng.normal(0, 1, (5, 16))).astype(np.float32)
    search = rng.normal(0, 1, (200, 16)).astype(np.float32)
    search[:20] += base.astype(np.float32)
    info = {}
    scores, printed = _stdout(tsvm.svm_rank, ctx, search, max_iter=1, device="cpu", info=info)
    assert not info["converged"] and info["steps"] == 1
    assert "stopped after 1 steps without converging" in printed and scores.shape == (200,)


def test_find_similar_svm_copies_the_same_files(tmp_path, rng):
    base = rng.normal(0, 1, 12).astype(np.float32)
    _context(tmp_path / "ctx", rng, base)
    _search_set(tmp_path / "search", "store", rng, base)
    got = {}
    for name, mod, extra in (("jax", jsvm, []), ("torch", tsvm, ["--device", "cpu"])):
        _, printed = _stdout(mod.main, ["--context_dir", str(tmp_path / "ctx"), "--search_dir",
                                        str(tmp_path / "search"), "--top_n", "5",
                                        "--output_dir", str(tmp_path / name)] + extra)
        got[name] = (printed.replace(str(tmp_path / name), "OUT"),
                     sorted(os.listdir(tmp_path / name)))
    assert got["torch"] == got["jax"]


# ---- train_latent_regressor -----------------------------------------------------------

def _latent_dataset(root, rng, n: int = 24) -> None:
    """``<root>/lat.csv`` and ``<root>/lat/<uuid>.pth`` [2, 3, 4] latents:
    labels on some rows, only a predicted_label on others, neither on one,
    and one row whose .pth is missing."""
    (root / "lat").mkdir(parents=True)
    rows = []
    for i in range(n):
        u = f"{i:04d}"
        label = float(np.round(rng.uniform(0, 9), 2)) if i % 3 else np.nan
        pred = float(np.round(rng.uniform(0, 9), 3)) if i != 3 else np.nan
        rows.append({"uuid": u, "label": label, "timestamp": 1, "predicted_label": pred})
        if i != 7:
            torch.save(torch.from_numpy(rng.normal(0, 1, (2, 3, 4)).astype(np.float32)),
                       root / "lat" / f"{u}.pth")
    pd.DataFrame(rows).to_csv(root / "lat.csv", index=False)


@pytest.mark.parametrize("seed", [42, 7])
def test_load_latents_bit_for_bit(seed, tmp_path, rng):
    _latent_dataset(tmp_path, rng)
    (jf, jl), jout = _stdout(jlat.load_latents, str(tmp_path), ["lat"], seed=seed)
    (tf, tl), tout = _stdout(tlat.load_latents, str(tmp_path), ["lat"], seed=seed)
    assert tout == jout and "(2 skipped)" in tout
    assert tf.dtype == jf.dtype == np.float32 and tl.dtype == jl.dtype == np.float32
    assert np.array_equal(tf, jf) and np.array_equal(tl, jl)


def test_train_latent_regressor_checkpoint_loads_in_the_jax_package(tmp_path, rng, monkeypatch):
    _latent_dataset(tmp_path / "data", rng, n=40)
    monkeypatch.chdir(tmp_path)
    model, history, path = _stdout(tlat.main, [
        "--train_data_dir", str(tmp_path / "data"), "--train_data_names", "lat",
        "--n_epochs", "3", "--hidden_sizes", "8", "4", "--device", "cpu"])[0]
    assert path.startswith(os.path.join("models", "latent_regressor_")) and path.endswith(".npz")
    loaded = JaxRegressor.load(str(tmp_path / path))
    assert loaded.meta.input_size == 24 and loaded.meta.clip_models == ("prompt_latents",)
    feats, _ = _stdout(tlat.load_latents, str(tmp_path / "data"), ["lat"])[0]
    np.testing.assert_allclose(loaded.predict(feats), model.predict(feats, wire="float32"),
                               rtol=0, atol=1e-6)
    assert len(history["train"]) == 3


# ---- the device, and the imports -------------------------------------------------------

@pytest.mark.parametrize("tool", ["find_similar_imgs", "svm_similarity", "train_latent_regressor"])
def test_device_tools_run_on_cuda_unless_asked(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = {"find_similar_imgs": tfind, "svm_similarity": tsvm,
           "train_latent_regressor": tlat}[tool]
    args = (["--train_data_dir", str(tmp_path), "--train_data_names", "x"]
            if tool == "train_latent_regressor"
            else ["--context_dir", str(tmp_path), "--search_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)


def test_tools_import_no_pandas_sklearn_pil_or_jax():
    mods = ", ".join(f"clip_assisted_data_labeling_tpu_torch.tools.{t}" for t in (
        "find_similar_imgs", "svm_similarity", "train_latent_regressor", "merge_datasets",
        "move_subset_of_files", "fix_img_dir", "investigate_embedding"))
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", f"import {mods}"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = {ln.split("|")[-1].strip().split(".")[0] for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")}
    assert not imported & {"pandas", "sklearn", "PIL", "jax", "clip_assisted_data_labeling_tpu"}
