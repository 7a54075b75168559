"""Columnar embedding store: one memory-mapped ``[N, n_crops, D]`` array + index
(port of the JAX package's ``store/columnar.py``, same on-disk layout): the
embed stage's writer, and the readers that dedup, train and predict use
(``list_models``, ``assemble_from_stores``, ``assemble_batch_from_stores``,
``EmbeddingStore.rel_paths``) and the bulk import of reference-format
sidecars (``EmbeddingStore.from_sidecars``).

Layout: ``<root_dir>/.ctpu_store/<model-name-with-slashes-as-dashes>/``
    meta.json        {model_name, crop_names, dim, n, dtype, with_stats, img_stat_keys}
    uuids.txt        one uuid per row
    paths.txt        per-row image path relative to root_dir
    embeddings.npy   [N, n_crops, D]
    img_stats.npy    [N, 22]  (optional)
    valid.npy        [N] bool (rows whose image decoded successfully)
"""
from __future__ import annotations

import json
import os

import numpy as np

from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar, resolve_crop_key


def store_dir_for(root_dir: str, model_name: str) -> str:
    safe = model_name.replace("/", "-")
    return os.path.join(root_dir, ".ctpu_store", safe)


def list_models(root_dir: str) -> list[str]:
    """Model names of every store under ``<root_dir>/.ctpu_store``, in the
    order of their directories' names."""
    base = os.path.join(root_dir, ".ctpu_store")
    names = []
    if os.path.isdir(base):
        for d in sorted(os.listdir(base)):
            meta_p = os.path.join(base, d, "meta.json")
            if os.path.exists(meta_p):
                with open(meta_p) as f:
                    names.append(json.load(f)["model_name"])
    return names


def _stats_or_raise(store: "EmbeddingStore", model: str):
    if store.img_stats is None:
        raise KeyError(
            f"store {model} has no img stats (embedded with "
            "--no_image_stats?) but the feature recipe needs them"
        )
    return store.img_stats


def assemble_from_stores(stores: dict, models, crop_names, use_stats: bool,
                         uuid: str) -> np.ndarray:
    """Per-uuid feature vector from open stores (per model: its crops in
    ``crop_names`` order, then the 22 img stats when ``use_stats``). Raises
    KeyError for an absent uuid, an invalid row, or a stats recipe against a
    store without stats."""
    parts = []
    for m in models:
        s = stores[m]
        i = s.index_of(uuid)
        if not bool(s.valid[i]):
            raise KeyError(f"{uuid} invalid in store {m}")
        idxs = [s.crop_index(c) for c in crop_names]
        feats = np.asarray(s.embeddings[i][idxs], np.float32).reshape(-1)
        if use_stats:
            stats = _stats_or_raise(s, m)
            feats = np.concatenate([feats, np.asarray(stats[i], np.float32)])
        parts.append(feats)
    return np.concatenate(parts)


def assemble_batch_from_stores(
    stores: dict, models, crop_names, use_stats: bool, uuids: list[str]
) -> tuple[np.ndarray, np.ndarray]:
    """:func:`assemble_from_stores` for N uuids at once: ``(kept [N] bool,
    feats [kept.sum(), F] float32)``, the same rows in the same part order. A
    row is dropped exactly where the per-uuid version raises KeyError for it
    (uuid absent from a store, or its row invalid); a stats recipe against a
    store without stats raises up front."""
    n = len(uuids)
    kept = np.ones(n, bool)
    model_rows = []
    for m in models:
        s = stores[m]
        index = s.uuid_index()
        idx = np.fromiter((index.get(u, -1) for u in uuids), np.int64, count=n)
        if use_stats:
            _stats_or_raise(s, m)
        present = idx >= 0
        ok = np.zeros(n, bool)
        if present.any():
            ok[present] = np.asarray(s.valid[idx[present]], bool)
        kept &= ok
        model_rows.append(idx)
    parts = []
    for m, idx in zip(models, model_rows):
        s = stores[m]
        rows = idx[kept]
        crop_idxs = [s.crop_index(c) for c in crop_names]
        emb = s.embeddings[rows]
        if crop_idxs != list(range(emb.shape[1])):
            emb = emb[:, crop_idxs]
        parts.append(np.ascontiguousarray(emb, dtype=np.float32).reshape(
            len(rows), len(crop_idxs) * emb.shape[-1]))
        if use_stats:
            parts.append(np.asarray(s.img_stats[rows], np.float32))
    if not parts:
        return kept, np.zeros((int(kept.sum()), 0), np.float32)
    return kept, np.concatenate(parts, axis=1)


class EmbeddingStore:
    def __init__(self, directory: str, meta: dict, mode: str = "r"):
        self.directory = directory
        self.meta = meta
        writing = mode.startswith("w")
        shape = (meta["n"], len(meta["crop_names"]), meta["dim"])
        self.embeddings = np.lib.format.open_memmap(
            os.path.join(directory, "embeddings.npy"),
            mode=mode,
            dtype=np.dtype(meta["dtype"]),
            shape=shape if writing else None,
        )
        stats_path = os.path.join(directory, "img_stats.npy")
        self.img_stats = None
        if writing:
            if meta.get("with_stats"):
                self.img_stats = np.lib.format.open_memmap(
                    stats_path, mode=mode, dtype=np.float32,
                    shape=(meta["n"], len(IMG_STAT_KEYS)),
                )
            elif os.path.exists(stats_path):
                # a stats file from an earlier with-stats run would serve stale
                # rows against the new uuid order
                os.remove(stats_path)
        elif os.path.exists(stats_path):
            self.img_stats = np.lib.format.open_memmap(stats_path, mode=mode)
        valid_path = os.path.join(directory, "valid.npy")
        if writing:
            self.valid = np.lib.format.open_memmap(
                valid_path, mode=mode, dtype=bool, shape=(meta["n"],)
            )
        else:
            self.valid = (
                np.lib.format.open_memmap(valid_path, mode=mode)
                if os.path.exists(valid_path)
                else np.ones(meta["n"], bool)
            )
        self._uuids: list[str] | None = None
        self._index: dict[str, int] | None = None

    @classmethod
    def create(
        cls,
        root_dir: str,
        model_name: str,
        crop_names: list[str],
        dim: int,
        uuids: list[str],
        dtype: str = "float16",
        with_stats: bool = True,
        rel_paths: list[str] | None = None,
    ) -> "EmbeddingStore":
        directory = store_dir_for(root_dir, model_name)
        os.makedirs(directory, exist_ok=True)
        meta = {
            "model_name": model_name,
            "crop_names": list(crop_names),
            "dim": int(dim),
            "n": len(uuids),
            "dtype": dtype,
            "with_stats": with_stats,
            "img_stat_keys": list(IMG_STAT_KEYS),
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(directory, "uuids.txt"), "w") as f:
            f.write("\n".join(uuids))
        if rel_paths is None:
            rel_paths = [u + ".jpg" for u in uuids]  # flat-dataset default
        if len(rel_paths) != len(uuids):
            raise ValueError("rel_paths must align with uuids")
        with open(os.path.join(directory, "paths.txt"), "w") as f:
            f.write("\n".join(rel_paths))
        store = cls(directory, meta, mode="w+")
        store._uuids = list(uuids)
        return store

    @classmethod
    def open(cls, root_dir: str, model_name: str, mode: str = "r") -> "EmbeddingStore":
        directory = store_dir_for(root_dir, model_name)
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        return cls(directory, meta, mode=mode)

    @staticmethod
    def exists(root_dir: str, model_name: str) -> bool:
        return os.path.exists(os.path.join(store_dir_for(root_dir, model_name), "meta.json"))

    @property
    def uuids(self) -> list[str]:
        if self._uuids is None:
            with open(os.path.join(self.directory, "uuids.txt")) as f:
                self._uuids = f.read().splitlines()
        return self._uuids

    def rel_paths(self) -> list[str]:
        """Per-row image path relative to the dataset root ('<uuid>.jpg' for
        stores written before paths.txt existed)."""
        p = os.path.join(self.directory, "paths.txt")
        if os.path.exists(p):
            with open(p) as f:
                return f.read().splitlines()
        return [u + ".jpg" for u in self.uuids]

    def uuid_index(self) -> dict:
        if self._index is None:
            self._index = {u: i for i, u in enumerate(self.uuids)}
        return self._index

    def index_of(self, uuid: str) -> int:
        return self.uuid_index()[uuid]

    def write_rows(self, start: int, embeddings: np.ndarray, stats: np.ndarray | None = None,
                   valid: np.ndarray | None = None) -> None:
        end = start + len(embeddings)
        self.embeddings[start:end] = embeddings.astype(self.embeddings.dtype)
        if stats is not None and self.img_stats is not None:
            self.img_stats[start:end] = stats
        self.valid[start:end] = True if valid is None else valid

    def flush(self) -> None:
        self.embeddings.flush()
        if self.img_stats is not None:
            self.img_stats.flush()
        self.valid.flush()

    def crop_index(self, crop_name: str) -> int:
        names = self.meta["crop_names"]
        key = resolve_crop_key({n: True for n in names}, crop_name)
        if key is None:
            raise KeyError(f"crop {crop_name} not in store ({names})")
        return names.index(key)

    @classmethod
    def from_sidecars(
        cls, root_dir: str, model_name: str, uuid_paths: dict[str, str]
    ) -> "EmbeddingStore":
        """Build a store from existing ``.pt`` sidecars (e.g. a dataset
        embedded by the reference toolkit). uuid_paths maps uuid → sidecar
        path; ``model_name`` "auto" takes the first sidecar's first model.
        Rows in uuid order; each row's image path is the sidecar's sibling
        .jpg; a sidecar that does not read, or lacks the model, leaves its row
        invalid."""
        uuids = sorted(uuid_paths)
        rel_paths = [
            os.path.relpath(os.path.splitext(uuid_paths[u])[0] + ".jpg", root_dir)
            for u in uuids
        ]
        first = None
        for u in uuids:
            d = read_sidecar(uuid_paths[u])
            if model_name == "auto":
                model_name = next(iter(d.keys()))
            if model_name in d:
                first = d[model_name]
                break
        if first is None:
            raise ValueError(f"no sidecar contains model {model_name}")
        crop_names = [k for k in first if not k.startswith("img_stat_")]
        stat_keys = [k for k in first if k.startswith("img_stat_")]
        dim = int(np.asarray(first[crop_names[0]]).reshape(-1).shape[0])

        store = cls.create(
            root_dir, model_name, crop_names, dim, uuids,
            with_stats=bool(stat_keys), rel_paths=rel_paths,
        )
        for i, u in enumerate(uuids):
            try:
                d = read_sidecar(uuid_paths[u])[model_name]
                emb = np.stack([np.asarray(d[c], np.float32).reshape(-1) for c in crop_names])
                stats = (np.asarray([float(d[k]) for k in stat_keys], np.float32)
                         if stat_keys else None)
                store.write_rows(i, emb[None], None if stats is None else stats[None])
            except Exception:  # unreadable or foreign sidecar: the row stays invalid
                store.valid[i] = False
        store.flush()
        return store
