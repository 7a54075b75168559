"""Similarity search: learn a context embedding from one directory, find the
top-N most similar images in another (port of the JAX package's
``tools/find_similar_imgs.py``).

    python -m clip_assisted_data_labeling_tpu_torch.tools.find_similar_imgs \\
        --context_dir <dir> --search_dir <dir> [--similarity_measure cosine] [--device cpu]

The embeddings come from the columnar store (``store/columnar``) where every
requested model has one, else from a walk over the ``.pt`` sidecars. The
distances of the whole search set to the context mean run on the device in
float32 (``cuda`` unless ``--device cpu``; no fall back to the CPU), as the
JAX tool writes them: cosine ``(1 − ê·ĉ)/2``, l2 ``sqrt(Σ(e − c)² + 1e-12)``;
the host's ``np.argsort`` orders them, and the top N images are copied as
``<distance>_<stem>.jpg``. Which rows have their image is read from one
listing a directory (:func:`existing`).
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar, resolve_crop_key
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device


def _collect_from_stores(directory: str, clip_models: list[str], crop_name: str):
    """Store-backed sibling of the sidecar walk below: one vectorized gather
    per model instead of a torch.load per image. Returns None when the
    store(s) can't serve the request (absent, missing a model, or missing
    the crop) — callers fall back."""
    from clip_assisted_data_labeling_tpu_torch.store.columnar import (
        EmbeddingStore,
        list_models,
    )

    available = list_models(directory)
    if not available:
        return None
    # sorted, matching the sidecar path's sorted(d.keys()) "all" resolution
    resolved = sorted(available) if clip_models[0] == "all" else list(clip_models)
    stores = {}
    for m in resolved:
        if not EmbeddingStore.exists(directory, m):
            return None
        s = EmbeddingStore.open(directory, m)
        try:
            s.crop_index(crop_name)
        except KeyError:
            return None
        stores[m] = s
    base = stores[resolved[0]]
    uuids = base.uuids
    n = len(uuids)
    ok = np.ones(n, bool)
    rows_per_model = []
    for m in resolved:
        s = stores[m]
        pos = s.uuid_index()
        rows = np.fromiter((pos.get(u, -1) for u in uuids), np.int64, count=n)
        present = rows >= 0
        ok &= present
        valid_here = np.zeros(n, bool)
        if present.any():
            valid_here[present] = np.asarray(s.valid[rows[present]], bool)
        ok &= valid_here
        rows_per_model.append((s, rows))
    if not ok.any():
        return [], [], np.zeros((0, 1), np.float32)
    emb = np.concatenate(
        [np.asarray(s.embeddings[rows[ok], s.crop_index(crop_name)], np.float32)
         for s, rows in rows_per_model],
        axis=1,
    )
    rels = base.rel_paths()
    names, paths = [], []
    for u, rel, k in zip(uuids, rels, ok):
        if not k:
            continue
        names.append(u + ".pt")
        paths.append(os.path.join(directory, os.path.splitext(rel)[0] + ".pt"))
    print(f"----> Using columnar store(s) in {directory}: {resolved}")
    return names, paths, emb


def _collect_embeddings(directory: str, clip_models: list[str], crop_name: str):
    """(names, paths, embeddings) — columnar store first, .pt walk fallback."""
    from_store = _collect_from_stores(directory, clip_models, crop_name)
    if from_store is not None:
        return from_store
    names, paths, embs = [], [], []
    resolved = list(clip_models)
    for root, _dirs, files in os.walk(directory):
        for f in sorted(files):
            if not f.endswith(".pt"):
                continue
            full = os.path.join(root, f)
            try:
                d = read_sidecar(full)
                if resolved[0] == "all":
                    # sorted: context and search dirs may have been embedded
                    # with different sidecar key orders; same-dim models would
                    # otherwise concatenate in swapped halves with no error
                    resolved = sorted(d.keys())
                    print(f"----> Using all found clip models: {resolved}")
                parts = []
                for m in resolved:
                    feats = d[m]
                    key = resolve_crop_key(feats, crop_name)
                    parts.append(np.asarray(feats[key], np.float32).reshape(-1))
                embs.append(np.concatenate(parts))
                names.append(f)
                paths.append(full)
            except Exception as e:  # a foreign or partial sidecar: say why, skip it
                print(e)
                continue
    return names, paths, (np.stack(embs) if embs else np.zeros((0, 1), np.float32))


def existing(paths: list[str]) -> list[bool]:
    """``os.path.exists`` of each path, with one listing a directory in place
    of a ``stat`` a file (on a GPU host's file system the ``stat`` calls of a
    large search set can outweigh the rest of the search). A listed name
    that is not a symlink exists; a symlink, a name the listing lacks (a
    case-insensitive file system may still find it) and every path of a
    directory that cannot be listed go to ``os.path.exists``."""
    listings: dict[str, dict | None] = {}
    out = []
    for p in paths:
        d, name = os.path.split(p)
        if d not in listings:
            try:
                with os.scandir(d or ".") as it:
                    listings[d] = {e.name: e for e in it}
            except OSError:
                listings[d] = None
        entry = (listings[d] or {}).get(name)
        out.append(True if entry is not None and not entry.is_symlink() else os.path.exists(p))
    return out


def compute_distances(context: np.ndarray, embeddings: np.ndarray, measure: str,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """[N] float32 distances of ``embeddings`` [N, D] to ``context`` [D],
    computed on ``device`` in float32."""
    if measure not in ("cosine", "l2"):
        raise NotImplementedError(f"Similarity measure {measure} not implemented!")
    dev = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(context, np.float32)).to(dev)
    e = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32)).to(dev)
    if measure == "cosine":
        cn = c / torch.linalg.vector_norm(c)
        en = e / torch.linalg.vector_norm(e, dim=1, keepdim=True)
        return ((1.0 - en @ cn) / 2.0).cpu().numpy()
    return torch.sqrt(torch.sum((e - c) ** 2, dim=1) + 1e-12).cpu().numpy()


def find_similar_imgs(context_dir: str, search_dir: str, output_dir: str,
                      clip_models: list[str], crop_name: str, measure: str,
                      top_n: int, device: str | torch.device = "cuda",
                      timings: dict | None = None) -> list[tuple[float, str]]:
    """The top ``top_n`` search images by distance to the context mean,
    copied into ``output_dir``; returns [(distance, image path)].
    ``timings``, where given, receives the seconds of the embedding
    collection, the device distances and the copies."""
    t0 = time.perf_counter()
    ctx_names, _paths, ctx_emb = _collect_embeddings(context_dir, clip_models, crop_name)
    if not len(ctx_emb):
        print(f"No embeddings in context dir {context_dir}")
        return []
    context = ctx_emb.mean(axis=0)
    print(f"Context embedding from {len(ctx_emb)} samples, shape {context.shape}")

    names, pt_paths, emb = _collect_embeddings(search_dir, clip_models, crop_name)
    ctx_set = set(ctx_names)
    imgs = [p[:-3] + ".jpg" for p in pt_paths]
    keep = [(i, img) for i, (img, ok) in enumerate(zip(imgs, existing(imgs)))
            if ok and os.path.basename(img).replace(".jpg", ".pt") not in ctx_set]
    if not keep:
        return []
    idxs = [i for i, _ in keep]
    t1 = time.perf_counter()
    dists = compute_distances(context, emb[idxs], measure, device)
    order = np.argsort(dists)[:top_n]
    t2 = time.perf_counter()

    os.makedirs(output_dir, exist_ok=True)
    results = []
    for rank in order:
        dist = float(dists[rank])
        img_path = keep[rank][1]
        out = os.path.join(output_dir, f"{dist:.3f}_{Path(img_path).stem}.jpg")
        shutil.copy(img_path, out)
        results.append((dist, img_path))
    print(f"Copied {len(results)} similar images to {output_dir}")
    if timings is not None:
        timings.update(collect_s=t1 - t0, device_s=t2 - t1, copy_s=time.perf_counter() - t2)
    return results


def main(argv=None, timings: list | None = None):
    """The CLI; returns each context dir's results, and appends each one's
    seconds to ``timings`` where given."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--context_dir", required=True)
    parser.add_argument("--search_dir", required=True)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--clip_models_to_use", metavar="S", type=str, nargs="+",
                        default=["all"])
    parser.add_argument("--crop_name_to_use", default="square_padded_crop")
    parser.add_argument("--similarity_measure", default="l2", choices=["l2", "cosine"])
    parser.add_argument("--top_n", default=30, type=int)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # context dir without .pt files → treat each subdir as its own context
    if not any(f.endswith(".pt") for f in os.listdir(args.context_dir)):
        context_dirs = [
            os.path.join(args.context_dir, d) for d in sorted(os.listdir(args.context_dir))
            if os.path.isdir(os.path.join(args.context_dir, d))
        ]
    else:
        context_dirs = [args.context_dir]

    runs = []
    for context_dir in context_dirs:
        out = args.output_dir or os.path.join(context_dir, "_similar")
        seconds: dict = {}
        runs.append(find_similar_imgs(
            context_dir, args.search_dir, out, args.clip_models_to_use,
            args.crop_name_to_use, args.similarity_measure, args.top_n, device, seconds,
        ))
        if timings is not None:
            timings.append(seconds)
    return runs


if __name__ == "__main__":
    main()
