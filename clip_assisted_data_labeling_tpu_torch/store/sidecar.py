"""Per-image ``<uuid>.pt`` feature sidecars — the reference's on-disk contract
(port of the JAX package's ``store/sidecar.py``; the bytes are the same).

Layout: a torch-pickled dict

    {model_name: {crop_name: float32 tensor [1, D], "img_stat_*": float32 scalar}}

merged incrementally per model (a second model run adds its key without
touching the first). ``assemble_features`` builds the regressor's feature
vector from one sidecar, as train and predict read it.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import CROP_ALIASES

_ALIASES_REVERSED = {v: k for k, v in CROP_ALIASES.items()}


def write_sidecar(
    path: str,
    model_name: str,
    crop_embeddings: Mapping[str, np.ndarray],
    img_stats: Mapping[str, float] | None = None,
    merge: bool = True,
) -> None:
    """Write/merge one model's features into a ``.pt`` sidecar."""
    final: dict = {}
    if merge and os.path.exists(path):
        try:
            final = torch.load(path, map_location="cpu", weights_only=False)
        except Exception:  # a torn or foreign file: start over, as the JAX package does
            final = {}
    model_dict: dict = {}
    if img_stats:
        for k, v in img_stats.items():
            model_dict[k] = torch.tensor(float(v), dtype=torch.float32)
    for crop, emb in crop_embeddings.items():
        arr = np.asarray(emb, dtype=np.float32).reshape(1, -1)
        model_dict[crop] = torch.from_numpy(arr.copy())
    final[model_name] = model_dict
    # atomic replace: a kill mid-save must not truncate the merge base
    tmp = path + ".tmp"
    torch.save(final, tmp)
    os.replace(tmp, path)


def read_sidecar(path: str) -> dict:
    """Load a sidecar as {model: {key: np.ndarray}}."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    out: dict = {}
    for model, d in raw.items():
        if not isinstance(d, dict):  # legacy flat layout
            out[model] = np.asarray(d.float().numpy() if hasattr(d, "numpy") else d)
            continue
        out[model] = {
            k: (np.asarray(v.float().numpy()) if hasattr(v, "numpy") else v)
            for k, v in d.items()
        }
    return out


def has_model_key(path: str, model_name: str) -> bool:
    """Incremental re-embed skip check."""
    if not os.path.exists(path):
        return False
    try:
        return model_name in torch.load(path, map_location="cpu", weights_only=False)
    except Exception:  # unreadable sidecar: embed the image again
        return False


def resolve_crop_key(feature_dict: Mapping, crop_name: str) -> str | None:
    """Find a crop key under canonical or legacy alias naming."""
    if crop_name in feature_dict:
        return crop_name
    alias = CROP_ALIASES.get(crop_name) or _ALIASES_REVERSED.get(crop_name)
    if alias is not None and alias in feature_dict:
        return alias
    return None


def assemble_features(
    sidecar: Mapping[str, Mapping],
    clip_models: list[str],
    crop_names: list[str],
    use_img_stat_features: bool = False,
) -> np.ndarray:
    """One image's feature vector, as the reference trainer builds it: per
    model, the requested crops in ``crop_names`` order (KeyError naming any
    that are missing), then the ``img_stat_*`` scalars in the sidecar's
    order when asked; the models' parts concatenated in ``clip_models``
    order."""
    parts = []
    for model in clip_models:
        d = sidecar[model]
        crop_parts = []
        missing = []
        for crop in crop_names:
            key = resolve_crop_key(d, crop)
            if key is None:
                missing.append(crop)
            else:
                crop_parts.append(np.asarray(d[key], np.float32).reshape(-1))
        if missing:
            raise KeyError(
                f"Missing crops {missing} for model {model}; re-embed the image or "
                "adjust crop_names"
            )
        feats = np.concatenate(crop_parts, axis=0)
        if use_img_stat_features:
            stat_keys = [k for k in d.keys() if k.startswith("img_stat_")]
            stats = np.asarray([float(d[k]) for k in stat_keys], np.float32)
            feats = np.concatenate([feats, stats], axis=0)
        parts.append(feats)
    return np.concatenate(parts, axis=0)
