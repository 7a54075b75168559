"""The rest of the active-learning loop in the port, on the CPU, against the
JAX package: ``pipeline/loop.py`` (laps, the stop, the headless CLI in a
process of its own without jax, a checkpoint of the port's loop scored by
the JAX ``predict_labels``), stage 0 (``pipeline/prep.py``: the same plan
and the same files as the JAX stage, and without PIL the files it only
copies), the store CLI (``pipeline/store.py``: stores rebuilt by either
package read by the other) and the package entry point."""
import builtins
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from benchmarks.bench_al_loop import build_corpus
from clip_assisted_data_labeling_tpu.pipeline import predict as jpredict
from clip_assisted_data_labeling_tpu.pipeline import prep as jprep
from clip_assisted_data_labeling_tpu.pipeline import store as jstore
from clip_assisted_data_labeling_tpu.store.columnar import EmbeddingStore as JaxStore
from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
from clip_assisted_data_labeling_tpu_torch.pipeline import loop as tloop
from clip_assisted_data_labeling_tpu_torch.pipeline import prep as tprep
from clip_assisted_data_labeling_tpu_torch.pipeline import store as tstore
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar
from clip_assisted_data_labeling_tpu_torch.ui.backend import HeadlessBackend, OracleBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TrainConfig(clip_models_to_use=("AL-Synth",), crop_names=("centre_crop",), n_epochs=5,
                  batch_size=8, test_fraction=0.0, hidden_sizes=(8,), dropout_prob=0.0,
                  model_name="loop_t")


def _imported(stderr: str) -> set:
    return {ln.split("|")[-1].strip().split(".")[0] for ln in stderr.splitlines()
            if ln.startswith("import time:")}


# --- the loop -------------------------------------------------------------------------
def test_run_loop_two_laps_then_jax_scores_its_checkpoint(tmp_path):
    root = tmp_path / "loopset"
    truth = build_corpus(str(root), n=60, seed=0)
    oracle = [OracleBackend(truth, 12), OracleBackend(truth, 12)]
    history = tloop.run_loop(str(root), CFG, sort="middle", laps=2,
                             backend_factory=lambda lap: oracle[lap],
                             models_dir=str(tmp_path / "models"), batch_size=64, device="cpu")
    assert [h["lap"] for h in history] == [1, 2]
    assert [h["labels"] for h in history] == [12, 24]
    assert all(h["predicted"] == 60 for h in history)
    assert all(os.path.exists(h["model_path"]) for h in history)
    assert set(oracle[0].labeled).isdisjoint(oracle[1].labeled)
    db = LabelDatabase.load_or_create(str(root))
    assert db.n_labeled() == 24 and np.isfinite(db.column("predicted_label")).all()

    # the last lap's checkpoint, scored by the JAX stage on a copy
    jroot = tmp_path / "jaxcopy" / "loopset"
    shutil.copytree(root, jroot)
    shutil.copy(str(root) + ".csv", str(jroot) + ".csv")
    assert jpredict.predict_labels(str(jroot), history[-1]["model_path"],
                                   copy_imgs_fraction=0.0) == 60
    jdb = LabelDatabase.load_or_create(str(jroot))
    want = dict(zip(jdb.column("uuid"), jdb.column("predicted_label")))
    got = dict(zip(db.column("uuid"), db.column("predicted_label")))
    assert set(want) == set(got)
    assert max(abs(want[u] - got[u]) for u in got) <= 1e-6


def test_loop_stops_without_new_labels(tmp_path):
    root = tmp_path / "loopset2"
    build_corpus(str(root), n=30, seed=1)
    backends = [HeadlessBackend(["5", "3", "8", "1", "9", "quit"]),
                HeadlessBackend(["quit"]), HeadlessBackend(["quit"])]
    history = tloop.run_loop(str(root), CFG, sort="uuid", laps=3,
                             backend_factory=lambda lap: backends[lap],
                             models_dir=str(tmp_path / "models"), batch_size=64, device="cpu")
    assert len(history) == 1 and history[0]["labels"] == 5
    assert backends[2].shown == []  # lap 3 never ran
    assert len(os.listdir(tmp_path / "models")) == 1


def test_loop_cli_headless_alone_without_jax(tmp_path):
    """``python -m ...pipeline.loop`` in a process of its own: ';' between
    laps, ',' between keys, 'q' quits; it prints each lap's timing and the
    uuids each lap showed, and imports neither jax nor pandas."""
    root = tmp_path / "loopset3"
    build_corpus(str(root), n=30, seed=2)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "clip_assisted_data_labeling_tpu_torch.pipeline.loop", "--root_dir", str(root),
         "--laps", "2", "--sort", "middle", "--clip_models", "AL-Synth", "--crop_names", "centre_crop", "--n_epochs", "2", "--test_fraction", "0",
         "--hidden_sizes", "8", "--model_name", "loopcli", "--backend", "headless",
         "--keys", "4,7,2,q;9,right,1", "--device", "cpu"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not _imported(proc.stderr) & {"jax", "pandas", "clip_assisted_data_labeling_tpu"}
    out = proc.stdout.splitlines()
    assert sum(ln.startswith("lap ") and " timing: label " in ln for ln in out) == 2
    shown = [ln for ln in out if ln.startswith("headless lap")]
    # each lap's last frame is the one its exhausted script quits on
    assert [ln.split(":")[1].strip() for ln in shown] == ["4 frames shown", "4 frames shown"]
    lap1, lap2 = (ln.rsplit(": ", 1)[1].split(",") for ln in shown)
    db = LabelDatabase.load_or_create(str(root))
    assert [db.get_label(u) for u in lap1[:3]] == [0.4, 0.7, 0.2]
    assert [db.get_label(u) for u in (lap2[0], lap2[2])] == [0.9, 0.1]
    n = len({*lap1[:3], lap2[0], lap2[2]})
    assert db.n_labeled() == n
    assert sorted(os.listdir(tmp_path / "models"))[0].startswith("loopcli")
    assert out[-1] == f"Loop finished: 2 laps, {n} total labels."


def test_loop_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.run_loop(str(tmp_path), CFG, backend=HeadlessBackend(["quit"]))
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.main(["--root_dir", str(tmp_path), "--backend", "headless"])


# --- stage 0: prep --------------------------------------------------------------------
def _raw_tree(base, rng):
    """A raw dataset: PNGs and JPEGs of several sizes in two directories,
    prompt files sharing image basenames, a non-image file, a broken image,
    names that sort naturally (img2 before img10)."""
    raw = base / "raw"
    (raw / "nested").mkdir(parents=True)
    sizes = {"img2.png": (40, 30), "img10.jpg": (64, 48), "img1.PNG": (90, 70),
             "a.png": (20, 20), "nested/b.jpg": (50, 80), "nested/c10.png": (33, 17),
             "nested/c9.webp": (31, 19)}
    for name, (w, h) in sizes.items():
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        img.save(raw / name, quality=90) if name.endswith(".jpg") else img.save(raw / name)
    (raw / "img2.txt").write_text("prompt two")
    (raw / "img10.json").write_text('{"text_input": "ten"}')
    (raw / "notes.md").write_text("not an image")
    (raw / "nested" / "broken.png").write_bytes(b"\x89PNG broken")
    return raw


class _Counter:
    """Deterministic uuids for both packages: 32 hex digits from a counter."""

    def __init__(self):
        self.i = 0

    def __call__(self):
        self.i += 1
        return f"{(self.i * 2654435761) % (1 << 128):032x}"


def _tree(root):
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("shuffle", [False, True])
def test_plan_renames_matches_jax(tmp_path, monkeypatch, shuffle):
    raw = _raw_tree(tmp_path, np.random.default_rng(0))
    plans = []
    for mod in (jprep, tprep):
        monkeypatch.setattr(mod, "new_uuid", _Counter())
        random.seed(7)
        plans.append(mod.plan_renames(str(raw), str(tmp_path / "out"), shuffle))
    assert plans[0] == plans[1] and len(plans[1]) == 11
    dests = {}
    for src, dst in plans[1]:  # a basename group shares its uuid
        dests.setdefault(os.path.splitext(src)[0], set()).add(os.path.splitext(dst)[0])
    assert all(len(d) == 1 for d in dests.values())


@pytest.mark.parametrize("mode, max_n_pixels, convert", [
    ("copy", 2048 * 2048, False),
    ("rename", 2048 * 2048, False),
    ("copy", 2048 * 2048, True),  # PNGs and the webp to JPEG
    ("copy", 1500, False),  # the larger images downscaled (LANCZOS, sqrt scale)
    ("rename", 1500, True),
])
def test_prep_writes_what_jax_writes(tmp_path, monkeypatch, capsys, mode, max_n_pixels,
                                     convert):
    stats, trees, outs = [], [], []
    for name, mod in (("jax", jprep), ("port", tprep)):
        raw = _raw_tree(tmp_path / name, np.random.default_rng(1))
        out = raw if mode == "rename" else tmp_path / name / "out"
        monkeypatch.setattr(mod, "new_uuid", _Counter())
        stats.append(mod.prep_dataset_directory(str(raw), str(out), mode, max_n_pixels,
                                                convert, False))
        trees.append(_tree(out))
        outs.append(capsys.readouterr().out.replace(str(tmp_path / name), "<base>"))
    assert stats[0] == stats[1]
    assert trees[0] == trees[1]
    assert outs[0] == outs[1]
    assert stats[1]["skipped"] == 1  # the broken PNG
    assert stats[1]["resized"] == (3 if max_n_pixels == 1500 else 0)


def test_prep_without_pil_copies_and_skips(tmp_path, monkeypatch, capsys):
    """Without PIL the files that need no change are copied byte for byte
    (sizes from their headers); a resize, a conversion and a format only PIL
    reads fail inside the per-file try and count as skipped."""
    raw = _raw_tree(tmp_path, np.random.default_rng(2))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(tprep, "new_uuid", _Counter())
    stats = tprep.prep_dataset_directory(str(raw), str(tmp_path / "out"), "copy", 3000,
                                         False, False)
    out = capsys.readouterr().out
    assert stats == {"renamed": 6, "converted": 0, "resized": 0, "skipped": 5}
    assert out.count("Could not process") == 5
    need_pil = ("img10.jpg", "img1.PNG", "nested/b.jpg", "nested/c9.webp", "nested/broken.png")
    assert all(name in out for name in need_pil)
    copied = _tree(tmp_path / "out")
    raw_bytes = _tree(raw)
    assert sorted(copied.values()) == sorted(v for k, v in raw_bytes.items()
                                             if k not in need_pil)


def test_prep_cli_contracts(tmp_path, monkeypatch):
    raw = _raw_tree(tmp_path, np.random.default_rng(3))
    with pytest.raises(ValueError, match="Output directory"):
        tprep.main(["--root_dir", str(raw)])
    monkeypatch.setattr(builtins, "input", lambda _prompt: "no")
    with pytest.raises(ValueError, match="Aborted"):
        tprep.main(["--root_dir", str(raw), "--mode", "rename"])
    stats = tprep.main(["--root_dir", str(raw), "--mode", "rename", "--yes"])
    assert stats["renamed"] == 10 and stats["skipped"] == 1  # the broken PNG
    assert not os.path.exists(raw / "img2.png")
    assert all(len(os.path.splitext(f)[0]) == 32 for f in os.listdir(raw) if f != "nested")


# --- the store CLI --------------------------------------------------------------------
def _sidecar_tree(base, rng, models=("m/one", "m-two"), collide=False, torn=True):
    root = base / "ds"
    (root / "sub").mkdir(parents=True)
    for i in range(7):
        d = root / ("sub" if i % 3 == 0 else "")
        for m in models:
            write_sidecar(str(d / f"u{i}.pt"), m,
                          {"centre_crop": rng.normal(size=8), "subcrop2_0.1": rng.normal(size=8)},
                          {k: float(rng.normal()) for k in IMG_STAT_KEYS})
    if torn:  # unreadable: its row stays invalid
        (root / "u5.pt").write_bytes(b"torn")
    if collide:
        write_sidecar(str(root / "u3.pt"), models[0], {"centre_crop": np.ones(8)})
    return root


def _store_rows(cls, root, model):
    s = cls.open(str(root), model)
    return (s.meta, s.uuids, s.rel_paths(), np.asarray(s.valid), np.asarray(s.embeddings),
            None if s.img_stats is None else np.asarray(s.img_stats))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_rebuilt_by_either_package_reads_in_both(tmp_path, capsys, writer):
    root = _sidecar_tree(tmp_path, np.random.default_rng(4))
    (jstore if writer == "jax" else tstore).rebuild(str(root), ["m/one", "m-two"])
    assert capsys.readouterr().out.startswith(f"Found 7 sidecars under {root}")
    for model in ("m/one", "m-two"):
        a = _store_rows(JaxStore, root, model)
        b = _store_rows(EmbeddingStore, root, model)
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y)
        assert b[1] == [f"u{i}" for i in range(7)] and not b[3][5] and b[3].sum() == 6
    # the other package's rebuild of the same sidecars writes the same rows
    first = [_store_rows(EmbeddingStore, root, m) for m in ("m/one", "m-two")]
    (tstore if writer == "jax" else jstore).rebuild(str(root), ["m/one", "m-two"])
    for m, want in zip(("m/one", "m-two"), first):
        got = _store_rows(EmbeddingStore, root, m)
        assert got[:3] == want[:3]
        for x, y in zip(got[3:], want[3:]):
            np.testing.assert_array_equal(x, y)


def test_store_info_collisions_and_empty_match_jax(tmp_path, capsys):
    root = _sidecar_tree(tmp_path, np.random.default_rng(5), collide=True)
    outs = []
    for mod in (jstore, tstore):
        mod.main(["rebuild", "--root_dir", str(root), "--models_to_use", "m/one"])
        mod.main(["info", "--root_dir", str(root)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "WARNING: basename u3.pt appears in multiple subdirs" in outs[1]
    info = [ln for ln in outs[1].splitlines() if ln.startswith("[m/one] 6 rows")]
    assert info == ["[m/one] 6 rows (5 valid), crops ['centre_crop', 'subcrop2_0.1'], dim 8, "
                    "dtype float16, stats=yes"]
    assert tstore._find_sidecars(str(root)) == jstore._find_sidecars(str(root))
    capsys.readouterr()
    # no --models_to_use: every model of the first sidecar
    clean = _sidecar_tree(tmp_path / "clean", np.random.default_rng(6), torn=False)
    for mod in (jstore, tstore):
        mod.main(["rebuild", "--root_dir", str(clean)])
        outs.append(capsys.readouterr().out)
    assert outs[2] == outs[3] and "Rebuilding every model found in the first sidecar" in outs[3]
    assert outs[3].count("store rebuilt at") == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (jstore, tstore):
        with pytest.raises(SystemExit, match="No .pt sidecars"):
            mod.main(["rebuild", "--root_dir", str(empty)])
        with pytest.raises(SystemExit, match="No store"):
            mod.main(["info", "--root_dir", str(empty)])


# --- the package entry point ----------------------------------------------------------
def test_package_entry_point_prints_the_stage_map_without_jax():
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "clip_assisted_data_labeling_tpu_torch"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for stage in ("prep", "embed", "dedup", "label", "train", "predict", "loop", "subset",
                  "predict_simple", "store"):
        assert f"\n  {stage} " in proc.stdout
    assert "python -m clip_assisted_data_labeling_tpu_torch.pipeline.<stage>" in proc.stdout
    assert "not ported yet" in proc.stdout and "--sharded" in proc.stdout
    assert not _imported(proc.stderr) & {"jax", "torch", "clip_assisted_data_labeling_tpu"}
