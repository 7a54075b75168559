"""The parallel layer wired into the port's stages, on the CPU: embed's host
shards (``--host_count``; the int8_static shards share host 0's calibration),
embed and dedup over a mesh of CPU devices (``devices=[cpu] * n``) against
their one-device runs, predict ``--sharded`` against the single device and
the JAX package's sharded predict, and real multi-process runs over gloo:
two processes run embed ``--distributed`` → ``store rebuild`` → dedup
``--distributed`` and find the planted pair in both (the four-process and
kill-and-resume variants are marked slow, as the JAX package's are). Every
spawned process is joined with a timeout and killed past it."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from clip_assisted_data_labeling_tpu.pipeline import predict as jpredict
from clip_assisted_data_labeling_tpu_torch.config import DedupConfig, EmbedConfig
from clip_assisted_data_labeling_tpu_torch.models import regressor as treg
from clip_assisted_data_labeling_tpu_torch.models.encoders import calibration_file
from clip_assisted_data_labeling_tpu_torch.parallel import mesh as tmesh
from clip_assisted_data_labeling_tpu_torch.pipeline import dedup as tdedup
from clip_assisted_data_labeling_tpu_torch.pipeline import embed as tembed
from clip_assisted_data_labeling_tpu_torch.pipeline import predict as tpredict
from clip_assisted_data_labeling_tpu_torch.pipeline import store as tstore
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar
from tests.test_torch_stages import MODEL, _copy, _dataset, _predictions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BASE = dict(models_to_use=(MODEL,), batch_size=2, num_workers=1, canvas_size=128,
            compute_dtype="float32", shuffle_filenames=False, device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the suite's
    other workers, so these tests run on one (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> tmesh.Mesh:
    return tmesh.get_mesh(devices=[CPU] * n)


def _images(root, rng, n, prefix="u", size=(60, 80)):
    root.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*size, 3)).astype(np.uint8)).save(
            root / f"{prefix}{i}.jpg")


def _sidecar_crops(root) -> dict:
    return {f: np.asarray(read_sidecar(str(root / f))[MODEL]["centre_crop"])
            for f in sorted(os.listdir(root)) if f.endswith(".pt")}


# ---- embed: host shards, calibration sharing, the mesh ------------------------------

def test_host_shards_compose(tmp_path, rng):
    root = tmp_path / "ds"
    _images(root, rng, 7)
    for idx in (0, 1):  # two "hosts" embed disjoint shards, sidecars only
        stores = tembed.embed_dataset(str(root), EmbedConfig(**BASE, host_index=idx,
                                                             host_count=2))
        assert stores == {MODEL: None}
    pts = sorted(f for f in os.listdir(root) if f.endswith(".pt"))
    assert len(pts) == 7 and not EmbeddingStore.exists(str(root), MODEL)
    (merged,) = tstore.rebuild(str(root), [MODEL])
    assert int(np.asarray(merged.valid).sum()) == 7
    # a one-host follow-up sees everything embedded, and backfills the store
    stores = tembed.embed_dataset(str(root), EmbedConfig(**BASE))
    assert np.asarray(stores[MODEL].valid).all()
    with pytest.raises(ValueError, match="requires sidecars"):
        tembed.embed_dataset(str(root), EmbedConfig(**BASE, host_count=2, write_sidecars=False))


def test_incremental_embed_after_new_images(tmp_path, rng):
    root = tmp_path / "grow"
    _images(root, rng, 4, "a", (50, 60))
    tembed.embed_dataset(str(root), EmbedConfig(**BASE))
    first = _sidecar_crops(root)
    _images(root, rng, 2, "b", (50, 60))
    store = tembed.embed_dataset(str(root), EmbedConfig(**BASE))[MODEL]
    assert store.meta["n"] == 6 and np.asarray(store.valid).all()
    now = _sidecar_crops(root)
    for f, emb in first.items():  # the old sidecars were not re-encoded
        np.testing.assert_array_equal(now[f], emb)


def test_int8_static_shards_share_one_calibration(tmp_path, rng, monkeypatch):
    """Host 0 publishes the calibration; a non-zero host with work and no
    published file times out loudly instead of calibrating its own shard,
    and once it exists loads it without rewriting it; a host without work
    never waits, and host 0 republishes from an already-embedded batch."""
    root = tmp_path / "ds"
    _images(root, rng, 4)
    base = dict(BASE, compute_dtype="int8_static")
    monkeypatch.setattr(tembed, "CALIB_WAIT_S", 0.2)
    with pytest.raises(TimeoutError, match="never published"):
        tembed.embed_dataset(str(root), EmbedConfig(**base, host_index=1, host_count=2))
    tembed.embed_dataset(str(root), EmbedConfig(**base, host_index=0, host_count=2))
    calib = calibration_file(MODEL, str(root))
    published = open(calib, "rb").read()
    tembed.embed_dataset(str(root), EmbedConfig(**base, host_index=1, host_count=2))
    assert open(calib, "rb").read() == published
    assert len([f for f in os.listdir(root) if f.endswith(".pt")]) == 4
    os.remove(calib)
    tembed.embed_dataset(str(root), EmbedConfig(**base, host_index=1, host_count=2))
    assert not os.path.exists(calib)
    tembed.embed_dataset(str(root), EmbedConfig(**base, host_index=0, host_count=2))
    assert os.path.exists(calib)


@pytest.mark.parametrize("dtype", ["float32", "int8_static"])
def test_embed_over_a_mesh_matches_one_device(tmp_path, rng, dtype, capsys):
    """``embed_dataset(..., mesh=...)``: the batch rounds up to the mesh, the
    store and the calibration equal a one-device run's."""
    src = tmp_path / "src"
    _images(src, rng, 5)
    roots = {}
    for tag, mesh in (("one", None), ("mesh", cpu_mesh(3))):
        root = tmp_path / tag
        root.mkdir()
        for f in os.listdir(src):
            (root / f).write_bytes((src / f).read_bytes())
        # batch 6 on both: the int8_static calibration takes the first batch
        cfg = EmbedConfig(**dict(BASE, compute_dtype=dtype, batch_size=6 if mesh is None else 5))
        roots[tag] = tembed.embed_dataset(str(root), cfg, mesh=mesh)[MODEL]
    assert "Data-parallel embedding over 3 devices (batch 6)" in capsys.readouterr().out
    one, sharded = roots["one"], roots["mesh"]
    assert one.uuids == sharded.uuids and np.asarray(sharded.valid).all()
    # the store holds float16: equal up to its rounding
    np.testing.assert_allclose(np.asarray(sharded.embeddings, np.float32),
                               np.asarray(one.embeddings, np.float32), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(sharded.img_stats), np.asarray(one.img_stats))
    if dtype == "int8_static":
        a, b = (np.load(calibration_file(MODEL, str(tmp_path / t))) for t in ("one", "mesh"))
        np.testing.assert_allclose(a["act_amax"], b["act_amax"], rtol=1e-6)


# ---- dedup and predict over a mesh ---------------------------------------------------

def _planted_store(root, rng, n=40, d=16):
    root.mkdir(parents=True)
    emb = rng.normal(0, 1, (n, 4, d)).astype(np.float32)
    emb[9] = emb[3]
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    uuids = [f"{i:032x}" for i in range(n)]
    store = EmbeddingStore.create(str(root), MODEL, ["centre_crop", "square_padded_crop",
                                                     "subcrop1_0.15", "subcrop2_0.1"], d, uuids)
    store.write_rows(0, emb)
    store.flush()
    for u in uuids:
        (root / f"{u}.jpg").write_bytes(b"jpg")
        (root / f"{u}.txt").write_text(u)


def test_run_dedup_over_a_mesh(tmp_path, rng, capsys):
    _planted_store(tmp_path / "a" / "ds", rng)
    for wire in ("int8", "fp16"):
        cfg = DedupConfig(threshold=0.99, wire=wire, test=True)
        one = tdedup.run_dedup(str(tmp_path / "a" / "ds"), cfg, device="cpu")
        ring = tdedup.run_dedup(str(tmp_path / "a" / "ds"), cfg, device="cpu", use_mesh=True)
        assert one.pairs() == ring.pairs() == [(3, 9, pytest.approx(1.0, abs=1e-6))]
    # --distributed without a coordinator is the one-process run, files included
    tdedup.main(["--root_dir", str(tmp_path / "a" / "ds"), "--threshold", "0.99",
                 "--distributed", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Found 1 duplicates!" in out and "torch.distributed up: process 0/1" in out
    copied = sorted(os.listdir(tmp_path / "a" / "near_duplicates_cosine_0.99"))
    assert len(copied) == 4 and all("_source_" in f or "_target_" in f for f in copied)


def _checkpoint(root, classification=False) -> str:
    classes = (0.0, 4.0, 9.0) if classification else None
    meta = treg.RegressorMeta(clip_models=(MODEL,), crop_names=("centre_crop", "subcrop2_0.1"),
                              input_size=32, hidden_sizes=(12, 6),
                              output_size=3 if classification else 1, data_min=0.0,
                              data_max=9.0, class_values=classes)
    path = str(root / ("cls.npz" if classification else "reg.npz"))
    treg.SimpleFCRegressor.create(meta, 7, "cpu").save(path)
    return path


@pytest.mark.parametrize("wire", ["float32", "float16", "int8"])
def test_predict_sharded_matches_single_and_jax(tmp_path, wire):
    _dataset(tmp_path)
    for classification in (False, True):
        ckpt = _checkpoint(tmp_path, classification)
        tag = f"{wire}_{classification}"
        one, sharded, jax_root = (_copy(tmp_path, f"{k}_{tag}") for k in ("one", "mesh", "jax"))
        tpredict.predict_labels(str(one), ckpt, wire=wire, device="cpu")
        tpredict.predict_labels(str(sharded), ckpt, wire=wire, device="cpu",
                                sharded=True, mesh=cpu_mesh(3))
        jpredict.predict_labels(str(jax_root), ckpt, wire=wire, sharded=True)
        (p1, _), (p2, _), (pj, _) = (_predictions(r) for r in (one, sharded, jax_root))
        assert set(p1) == set(p2) == set(pj)
        assert max(abs(p1[u] - p2[u]) for u in p1) <= 1e-6
        assert max(abs(pj[u] - p2[u]) for u in p1) <= 1e-6
    # the CLI: --sharded over the one device --device names
    cli = _copy(tmp_path, f"cli_{wire}")
    tpredict.main(["--root_dir", str(cli), "--model_file", ckpt, "--wire", wire, "--sharded",
                   "--device", "cpu"])
    pc, _ = _predictions(cli)
    assert max(abs(pc[u] - p1[u]) for u in p1) <= 1e-6


# ---- processes over gloo ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(pid: int, port: int, module: str, cli_args: list[str], n_procs: int = 2):
    """One process of a --distributed run on the CPU, the coordinator on
    localhost."""
    code = (f"import sys; from clip_assisted_data_labeling_tpu_torch.pipeline import {module} "
            "as m; m.main(sys.argv[1:])")
    args = cli_args + ["--device", "cpu", "--distributed", "--coordinator_address",
                       f"localhost:{port}", "--num_processes", str(n_procs),
                       "--process_id", str(pid)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)


def _join(procs, timeout=180):
    """Every process's output; a process still running at the timeout is
    killed (and the test fails), so none outlives the test."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.poll() is not None for p in procs)
    return outs


def _distributed_run(data, rng, n_images, n_procs, dup_pair):
    for i in range(n_images):
        arr = rng.integers(0, 256, (100, 140, 3)).astype(np.uint8)
        arr[:, :70] = (33 * i) % 255
        Image.fromarray(arr).save(data / f"{i:032x}.jpg", quality=95)
    src, dst = (data / f"{i:032x}.jpg" for i in dup_pair)
    dst.write_bytes(src.read_bytes())
    port = _free_port()
    outs = _join([_spawn(i, port, "embed", ["--root_dir", str(data), "--models_to_use", MODEL,
                                            "--batch_size", "4", "--canvas_size", "256",
                                            "--num_workers", "1"], n_procs)
                  for i in range(n_procs)])
    per = n_images // n_procs
    for i in range(n_procs):
        assert any(f"Host shard {i}/{n_procs}: {per} images" in o for o in outs), outs[0][-2000:]
    pts = sorted(data.glob("*.pt"))
    assert len(pts) == n_images
    (merged,) = tstore.rebuild(str(data), [MODEL])
    assert merged.meta["n"] == n_images and int(merged.valid.sum()) == n_images
    # the merged rows equal each sidecar (the store holds float16)
    row, ci = merged.index_of(pts[0].stem), merged.crop_index("centre_crop")
    np.testing.assert_allclose(np.asarray(merged.embeddings[row, ci], np.float32),
                               np.asarray(read_sidecar(str(pts[0]))[MODEL]["centre_crop"],
                                          np.float32).reshape(-1), atol=2e-3)
    port = _free_port()
    outs = _join([_spawn(i, port, "dedup", ["--root_dir", str(data), "--threshold", "0.999",
                                            "--mode", "copy"], n_procs)
                  for i in range(n_procs)])
    for o in outs:  # every process computes, and agrees on, the planted pair
        assert "Found 1 duplicates!" in o, o[-2000:]
    # only rank 0 copies files
    assert sum("copying 1 near duplicates" in o for o in outs) == 1
    assert "copying" in outs[0]
    copied = os.listdir(data.parent / "near_duplicates_cosine_0.999")
    assert len(copied) == 4  # both file groups of the pair: .jpg and .pt each
    return outs


def test_two_process_embed_merge_dedup(tmp_path, rng):
    data = tmp_path / "data"
    data.mkdir()
    _distributed_run(data, rng, 14, 2, (3, 13))


@pytest.mark.slow
def test_four_process_embed_merge_dedup(tmp_path, rng):
    data = tmp_path / "data"
    data.mkdir()
    _distributed_run(data, rng, 16, 4, (3, 15))


@pytest.mark.slow
def test_distributed_kill_and_resume(tmp_path, rng):
    """SIGKILL a two-process embed mid-flight, rerun the same job: the
    per-image incremental skip resumes where the dead run stopped."""
    import signal
    import time

    data = tmp_path / "data"
    data.mkdir()
    for i in range(24):
        arr = rng.integers(0, 256, (300, 420, 3)).astype(np.uint8)
        arr[:, :210] = (11 * i) % 255
        Image.fromarray(arr).save(data / f"{i:032x}.jpg", quality=95)
    cli = ["--root_dir", str(data), "--models_to_use", MODEL, "--batch_size", "2",
           "--num_workers", "1", "--canvas_size", "512"]
    port = _free_port()
    procs = [_spawn(i, port, "embed", cli) for i in range(2)]
    deadline = time.time() + 300
    while time.time() < deadline:
        if len(list(data.glob("*.pt"))) >= 4 or all(p.poll() is not None for p in procs):
            break
        time.sleep(0.02)
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
        p.communicate(timeout=60)
    n_before = len(list(data.glob("*.pt")))
    assert n_before >= 1, "run died before writing anything"
    port = _free_port()
    outs = _join([_spawn(i, port, "embed", cli) for i in range(2)])
    assert len(list(data.glob("*.pt"))) == 24
    skipped = sum(int(o.split(" already embedded)")[0].rsplit("(", 1)[1])
                  for o in outs if " already embedded)" in o)
    assert skipped >= min(n_before, 20) - 2, (n_before, skipped)
    (merged,) = tstore.rebuild(str(data), [MODEL])
    assert merged.meta["n"] == 24 and int(merged.valid.sum()) == 24
