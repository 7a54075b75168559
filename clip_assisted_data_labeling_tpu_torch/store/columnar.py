"""Columnar embedding store: one memory-mapped ``[N, n_crops, D]`` array + index
(port of the JAX package's ``store/columnar.py``, same on-disk layout).

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
from clip_assisted_data_labeling_tpu_torch.store.sidecar import resolve_crop_key


def store_dir_for(root_dir: str, model_name: str) -> str:
    safe = model_name.replace("/", "-")
    return os.path.join(root_dir, ".ctpu_store", safe)


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
