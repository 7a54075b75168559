"""Stage 5 — predict labels for all images with a trained regressor (port of
the JAX package's ``pipeline/predict.py``).

Features stream from the columnar store where every model the regressor
needs has one (else from the ``.pt`` sidecars) in chunks of
``ASSEMBLE_CHUNK`` rows, the next chunk assembled on a thread while the
device scores the current one. Every side effect of the reference is kept:
the merge into the CSV database, the ``predicted_label`` writeback into
per-image ``.json`` files, score-prefixed preview copies, time-throttled CSV
flushes and the label-distribution histogram (where matplotlib is
installed). The run's seconds by part (store gather, forward with its
transfers, side effects) are printed at the end.

Model files: ``.npz`` checkpoints or the reference's ``.pth`` module
pickles; a name that is not a file is looked up as a substring in
``models/``, the newest match winning.

CLI: the JAX stage's flags plus ``--device`` (default ``cuda``; ``cpu`` for
the CPU). ``--sharded`` scores every chunk data-parallel over every local
card (``parallel/predict_sharded.py``; over the one device that ``--device``
names where it names one); a single card runs the same program.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.regressor import WIRES, SimpleFCRegressor
from clip_assisted_data_labeling_tpu_torch.store.columnar import (
    EmbeddingStore,
    assemble_batch_from_stores,
)
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.store.sidecar import assemble_features, read_sidecar
from clip_assisted_data_labeling_tpu_torch.utils import plots
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


def find_model(model_name: str, model_dir: str = "models") -> str | None:
    """An existing path as it is, else the newest file in ``model_dir``
    whose name contains ``model_name`` (the reference took the first
    listing hit, which could be a stale model after retraining)."""
    if os.path.isfile(model_name):
        return model_name
    if not os.path.isdir(model_dir):
        return None
    matches = [
        os.path.join(model_dir, f) for f in os.listdir(model_dir) if model_name in f
    ]
    if not matches:
        return None
    return max(matches, key=os.path.getmtime)


def load_model(path: str, device: str | torch.device = "cuda") -> SimpleFCRegressor:
    if path.endswith(".npz"):
        return SimpleFCRegressor.load(path, device)
    return SimpleFCRegressor.load_torch_pickle(path, device)


_UNSET = object()


def _open_feature_stores(root_dir: str, model: SimpleFCRegressor):
    """Every columnar store the model needs, opened once (each open builds a
    uuid index), or None when a model has no store (the sidecar fallback).
    Raises at once when the model needs img_stat features that a store
    lacks: skipping each row would end "successfully" with no prediction."""
    clip_models = list(model.meta.clip_models)
    stores = {m: EmbeddingStore.open(root_dir, m) for m in clip_models
              if EmbeddingStore.exists(root_dir, m)}
    if len(stores) != len(clip_models):
        return None
    if model.meta.use_img_stat_features:
        missing = [m for m, s in stores.items() if s.img_stats is None]
        if missing:
            raise ValueError(
                f"model needs img_stat features but store(s) {missing} have "
                "none — re-embed without --no_image_stats"
            )
    return stores


def _gather_features(root_dir: str, uuids: list[str], model: SimpleFCRegressor,
                     stores=_UNSET):
    """(kept uuids, features [N, F] float32) from the stores, else from the
    sidecars; a uuid that has no usable row is reported and skipped."""
    clip_models = list(model.meta.clip_models)
    crop_names = list(model.meta.crop_names)
    if stores is _UNSET:
        stores = _open_feature_stores(root_dir, model)

    if stores is not None:
        keep, feats = assemble_batch_from_stores(
            stores, clip_models, crop_names, model.meta.use_img_stat_features, uuids)
        for uuid, ok in zip(uuids, keep):
            if not ok:
                print(f"WARNING: {uuid} missing or invalid in the store(s), "
                      "skipping this sample..")
        return [u for u, ok in zip(uuids, keep) if ok], feats

    kept, feats = [], []
    for uuid in uuids:
        try:
            sidecar = read_sidecar(os.path.join(root_dir, uuid + ".pt"))
            feats.append(assemble_features(
                sidecar, clip_models, crop_names, model.meta.use_img_stat_features))
            kept.append(uuid)
        except Exception as e:  # a missing or foreign sidecar: report, skip
            print(f"WARNING: {e} for {uuid}, skipping this sample..")
    if not feats:
        return [], np.zeros((0, model.meta.input_size), np.float32)
    return kept, np.stack(feats).astype(np.float32)


# rows per assembly chunk: large enough for the vectorized store gather to run
# at full speed, small enough that the feature matrix never exists whole
# (1M x 1536 float32 is 6 GB; one chunk is ~400 MB)
ASSEMBLE_CHUNK = 65536


def _prefetched_chunks(root_dir, uuids, model, stores, chunk: int, timer: StageTimer):
    """Yield (kept uuids, features) a chunk, the next chunk assembled on a
    thread while the caller scores the current one. A queue of one bounds
    live memory to about three chunks; an error in the thread is raised in
    the caller."""
    q: queue.Queue = queue.Queue(maxsize=1)

    def worker():
        try:
            for s in range(0, len(uuids), chunk):
                part = uuids[s: s + chunk]
                with timer.time("gather", len(part)):
                    item = _gather_features(root_dir, part, model, stores)
                q.put((None, item))
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            q.put((e, None))
        else:
            q.put((None, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        err, item = q.get()
        if err is not None:
            raise err
        if item is None:
            return
        yield item


def _write_json_predictions(root_dir: str, uuids, scores) -> None:
    """``predicted_label`` into each uuid's ``.json`` file where one exists."""
    for uuid, score in zip(uuids, scores):
        jpath = os.path.join(root_dir, uuid + ".json")
        if os.path.exists(jpath):
            try:
                with open(jpath) as f:
                    data = json.load(f)
                data["predicted_label"] = float(score)
                with open(jpath, "w") as f:
                    json.dump(data, f)
            except (OSError, ValueError, TypeError) as e:
                print(f"WARNING: could not update {jpath}: {e}")


def predict_labels(
    root_dir: str,
    model_file: str,
    batch_size: int = 512,
    copy_imgs_fraction: float = 0.01,
    seed: int = 0,
    wire: str = "float16",
    device: str | torch.device = "cuda",
    sharded: bool = False,
    mesh=None,
) -> int:
    """Score every ``<uuid>.jpg`` in ``root_dir`` with its store or sidecar
    features on ``device``; returns the number of images predicted.
    ``sharded``: each chunk scored data-parallel over ``mesh`` (given, or
    every local card where ``device`` is a bare ``cuda``, else the one
    ``device``; a given ``mesh`` implies it)."""
    device = resolve_device(device)
    if sharded and mesh is None:
        from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh, stage_devices

        mesh = get_mesh(devices=stage_devices(device))
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r} (one of {', '.join(WIRES)})")
    model_path = find_model(model_file)
    if model_path is None:
        raise FileNotFoundError(f"could not find model file {model_file}")
    model = load_model(model_path, device)
    print(f"Loaded regression model trained on CLIP models: {list(model.meta.clip_models)}")

    db = LabelDatabase.load_or_create(root_dir)
    uuids = [
        os.path.splitext(f)[0] for f in os.listdir(root_dir) if f.endswith(".jpg")
    ]
    print(f"Predicting labels for up to {len(uuids)} images...")
    if mesh is not None:
        from clip_assisted_data_labeling_tpu_torch.parallel.predict_sharded import predict_sharded

        params = model.params()
        print(f"Sharded prediction over {mesh.size} devices")
    stores = _open_feature_stores(root_dir, model)
    timer = StageTimer()
    chunks = _prefetched_chunks(root_dir, uuids, model, stores,
                                max(batch_size, ASSEMBLE_CHUNK), timer)

    output_dir = root_dir.rstrip("/") + "_predicted_scores"
    rng = np.random.default_rng(seed)
    n_flushed = 0
    batch_no = 0
    last_save = time.monotonic()
    t0 = time.perf_counter()
    for kept, feats in chunks:
        if not kept:
            continue
        with timer.time("side_effects"):
            # rows registered once a chunk: the merges below update in place
            db.ensure_rows(kept)
        chunk_scores = None
        if mesh is not None:  # the whole chunk in one sharded pass
            with timer.time("forward"):
                chunk_scores = predict_sharded(params, feats, mesh, wire=wire,
                                               class_values=model.meta.class_values)
        for start in range(0, len(kept), batch_size):
            batch_uuids = kept[start: start + batch_size]
            with timer.time("forward", len(batch_uuids)):
                if chunk_scores is not None:
                    scores = chunk_scores[start: start + batch_size]
                else:
                    scores = model.predict(feats[start: start + batch_size], wire=wire)
            with timer.time("side_effects", len(batch_uuids)):
                db.merge_predictions(batch_uuids, scores)
                _write_json_predictions(root_dir, batch_uuids, scores)
                if copy_imgs_fraction > 0:  # preview copies
                    os.makedirs(output_dir, exist_ok=True)
                    pick = rng.random(len(batch_uuids)) < copy_imgs_fraction
                    for uuid, score, take in zip(batch_uuids, scores, pick):
                        if take:
                            src = os.path.join(root_dir, uuid + ".jpg")
                            if os.path.exists(src):
                                shutil.copy(src, os.path.join(output_dir,
                                                              f"{score:.3f}_{uuid}.jpg"))
                # crash-safety flush, throttled in time: rewriting the whole
                # CSV every 10 batches would be O(N) each
                if batch_no % 10 == 9 and time.monotonic() - last_save > 30:
                    db.save()
                    last_save = time.monotonic()
            batch_no += 1
            n_flushed += len(batch_uuids)

    if n_flushed == 0:
        return 0
    with timer.time("side_effects"):
        db.save()
    wall = time.perf_counter() - t0
    preds = db.column("predicted_label")
    plots.plot_or_say(plots.plot_label_distribution, preds, root_dir)
    print(f"{n_flushed} of {len(uuids)} imgs predicted.")
    print(f"Average predicted label: {np.nanmean(preds):.3f}")
    print(f"Database saved at {db.path}")
    parts = ", ".join(f"{k} {timer.totals.get(k, 0.0):.3f} s"
                      for k in ("gather", "forward", "side_effects"))
    print(f"predict timing: {n_flushed} rows in {wall:.3f} s ({n_flushed / wall:,.0f} rows/s; "
          f"{parts}; gather overlaps the rest; wire {wire}, {device.type})")
    return n_flushed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--model_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--copy_imgs_fraction", type=float, default=0.01)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="accepted for reference-CLI compatibility")
    parser.add_argument("--wire", default="float16", choices=list(WIRES),
                        help="host->device format for the feature matrix: "
                        "float16 (default) halves the transfer, int8 halves it "
                        "again by per-row quantization, float32 is exact")
    parser.add_argument("--sharded", action="store_true",
                        help="shard inference over all local cards (data-parallel; a "
                        "single card runs unchanged)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # every subdirectory that holds .jpg files, as the reference walks them
    total = 0
    for root, _dirs, files in os.walk(args.root_dir):
        if any(f.endswith(".jpg") for f in files) and "_predicted_scores" not in root:
            print(f"\nPredicting labels for {root}...")
            total += predict_labels(root, args.model_file, args.batch_size,
                                    args.copy_imgs_fraction, wire=args.wire, device=device,
                                    sharded=args.sharded)
    return total


if __name__ == "__main__":
    main()
