"""Active-learning acquisition orderings for the labelling loop (port of the
JAX package's ``ui/sorting.py``: the same strategies, aliases and orders).

Strategies:
  uuid        natural-sort order (no reordering)
  bad_first   ascending predicted_label
  good_first  descending predicted_label
  middle      ascending |predicted_label − median| (max-uncertainty first)
  diversity   exact farthest-point ordering in CLIP space, on the device
  diversity_sampled
              the reference's sampled farthest point, 100 candidates a step
  review      labelled images whose prediction disagrees most with their
              label, descending |label − predicted_label| (unlabelled rows
              are excluded)

Rows without a prediction sort last in every strategy, nested images
resolve through their discovered paths, and images missing from the
database tail the session.

The JAX package sorts pandas columns; the port sorts the label database's
float64 columns (``LabelDatabase.column``) with the same numpy calls:
``fillna`` becomes ``np.where(np.isnan(...), ...)`` and ``Series.median``
(NaN skipped, NaN for an all-NaN column) ``np.nanmedian``.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

SORT_OPTIONS = ("uuid", "bad_first", "good_first", "middle", "diversity",
                "diversity_sampled", "review")
# reference dialog labels → our names, for drop-in familiarity
SORT_ALIASES = {
    "Predicted bad first": "bad_first",
    "Predicted good first": "good_first",
    "middle first": "middle",
    "diversity sorted": "diversity",
}


def _diversity_order(image_files: list[str], root_dir: str,
                     crop: str = "square_padded_crop",
                     candidates: int | None = None,
                     device: str | torch.device = "cuda"):
    """Farthest-point order of the images' ``crop`` embeddings: from the
    first store that holds the crop (one vectorized gather), else from the
    sidecars. Images without an embedding tail the order; below two
    embeddings the order is kept, with a warning."""
    from clip_assisted_data_labeling_tpu_torch.ops.diversity import farthest_point_order
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore, list_models
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import (
        read_sidecar,
        resolve_crop_key,
    )

    uuids = [os.path.splitext(os.path.basename(f))[0] for f in image_files]
    embs = []
    store = None
    for model in list_models(root_dir):
        try:
            cand = EmbeddingStore.open(root_dir, model)
            cand.crop_index(crop)  # must actually hold the diversity crop
            store = cand
            break
        except (OSError, ValueError, KeyError):
            continue  # next store; sidecar fallback if none qualifies
    kept_idx = []
    if store is not None:
        pos = store.uuid_index()
        idx = np.fromiter((pos.get(u, -1) for u in uuids), np.int64, count=len(uuids))
        ok = idx >= 0
        ok[ok] = np.asarray(store.valid[idx[ok]], bool)
        embs = list(np.asarray(store.embeddings[idx[ok], store.crop_index(crop)], np.float32))
        kept_idx = np.nonzero(ok)[0].tolist()
    else:
        for i, u in enumerate(uuids):
            try:
                d = read_sidecar(os.path.join(root_dir, u + ".pt"))
                feats = d[next(iter(d.keys()))]
                key = resolve_crop_key(feats, crop) if isinstance(feats, dict) else None
                if key is None:
                    continue
                embs.append(np.asarray(feats[key], np.float32).reshape(-1))
                kept_idx.append(i)
            except Exception:  # a missing, torn or foreign sidecar: no embedding
                continue
    if len(embs) < 2:
        print("WARNING: diversity sort found <2 usable embeddings "
              "(store/sidecars missing the crop?) — keeping uuid order")
        return image_files
    order = farthest_point_order(np.stack(embs), n_order=min(500, len(embs)),
                                 candidates=candidates, device=device)
    ordered = [image_files[kept_idx[i]] for i in order]
    kept = set(kept_idx)
    missing = [f for i, f in enumerate(image_files) if i not in kept]
    return ordered + missing


def _nanmedian(values: np.ndarray) -> float:
    """pandas' ``Series.median``: NaN skipped, NaN for no value (silently)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmedian(values))


def re_order_images(image_files: list[str], database, root_dir: str, sort: str,
                    device: str | torch.device = "cuda"):
    """Order image files per the chosen acquisition strategy (reference
    _3:180-213); the diversity orders run on ``device``."""
    sort = SORT_ALIASES.get(sort, sort)
    if sort == "uuid":
        return image_files
    if sort == "diversity":
        return _diversity_order(image_files, root_dir, device=device)
    if sort == "diversity_sampled":
        # the reference's candidate count (_3_label_images.py:135)
        return _diversity_order(image_files, root_dir, candidates=100, device=device)

    # uuid → actual discovered path: nested images resolve through their
    # real paths
    by_uuid = {os.path.splitext(os.path.basename(f))[0]: f for f in image_files}
    db_uuids = database.column("uuid")
    pred = database.column("predicted_label")
    # NaN (unpredicted) rows sort LAST for every strategy: each fills NaN
    # with its worst sort key
    if sort == "bad_first":
        sorted_idx = np.argsort(np.where(np.isnan(pred), np.inf, pred), kind="stable")
    elif sort == "good_first":
        sorted_idx = np.argsort(-np.where(np.isnan(pred), -np.inf, pred), kind="stable")
    elif sort == "middle":
        dist = np.abs(pred - _nanmedian(pred))
        sorted_idx = np.argsort(np.where(np.isnan(dist), np.inf, dist), kind="stable")
    elif sort == "review":
        disagreement = np.abs(database.column("label") - pred)
        # rows without both a human label and a prediction are excluded
        valid = ~np.isnan(disagreement)
        # numpy's default sort kind, as the JAX package sorts
        sorted_idx = np.argsort(-np.where(valid, disagreement, -np.inf))
        uuids = [db_uuids[i] for i in sorted_idx if valid[i]]
        return [by_uuid[u] for u in uuids if u in by_uuid]
    else:
        raise ValueError(f"unknown sort option {sort}; choose from {SORT_OPTIONS}")

    candidates = [by_uuid[db_uuids[i]] for i in sorted_idx if db_uuids[i] in by_uuid]
    seen = set(candidates)
    # images not (yet) in the DB tail the session instead of vanishing
    return candidates + [f for f in image_files if f not in seen]


def prompt_sort_option(default: str = "uuid") -> str:
    """Interactive choice of the sort order (the reference's dialog). A
    closed stdin (scripts, CI) gets the default instead of an EOFError."""
    print("Sort options:", ", ".join(SORT_OPTIONS))
    try:
        choice = input(f"Choose sort order [{default}]: ").strip()
    except EOFError:
        print(f"(stdin closed — using '{default}')")
        return default
    return choice or default
