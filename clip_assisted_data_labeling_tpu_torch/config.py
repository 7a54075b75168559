"""Shared constants and the stage-1 config (port of the JAX package's
``config.py``: the crop names and aliases, CLIP and SigLIP normalization, image
extensions, the label database's columns, ``EmbedConfig`` and
``DedupConfig``)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

# Canonical crop names; readers accept the reference's plain "subcrop1"/
# "subcrop2" as aliases (store.sidecar.resolve_crop_key).
CROP_CENTRE = "centre_crop"
CROP_SQUARE_PADDED = "square_padded_crop"
CROP_SUB1 = "subcrop1_0.15"
CROP_SUB2 = "subcrop2_0.1"
ALL_CROPS = (CROP_CENTRE, CROP_SQUARE_PADDED, CROP_SUB1, CROP_SUB2)
CROP_ALIASES = {"subcrop1": CROP_SUB1, "subcrop2": CROP_SUB2}

# Fractional areas of the two subcrops.
SUBCROP_AREA_FRACTIONS = (0.15, 0.1)

# CLIP preprocessing normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# SigLIP checkpoints normalize with 0.5/0.5 (open_clip's preprocess config).
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".JPEG", ".JPG", ".PNG")

# The label database's columns (store/database.py), in the reference's order.
DB_COLUMNS = ("uuid", "label", "timestamp", "predicted_label")


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Stage-1 embedding configuration (same fields and defaults as the JAX
    package's ``EmbedConfig``, plus the torch ``device``)."""

    models_to_use: Sequence[str] = ("ViT-L-14-336/openai",)
    batch_size: int = 64
    num_workers: int = 8
    force_reencode: bool = False
    model_path: str | None = None  # local weights (.npz or torch checkpoint)
    crop_names: Sequence[str] = ALL_CROPS
    canvas_size: int = 1024  # host canvas; larger images are pre-downscaled
    # int8_static: W8A8 with activation scales calibrated on the first batch
    # and pinned to <root_dir>/<model>.calib.npz; bfloat16/float32 are the
    # strict-parity paths
    compute_dtype: str = "int8_static"
    with_image_stats: bool = True
    shuffle_filenames: bool = True
    write_sidecars: bool = True
    # "auto" = <root_dir>/<model>.calib.npz, "none" = in memory only,
    # anything else = an explicit npz path
    calibration: str = "auto"
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    """Stage-2 near-duplicate removal (same fields and defaults as the JAX
    package's ``DedupConfig``; the device is ``run_dedup``'s argument)."""

    threshold: float = 0.96
    mode: str = "copy"  # copy | move
    sim_type: str = "cosine"  # cosine | euclidean
    clip_model_to_use: str | None = None
    crop_to_use: str = CROP_SQUARE_PADDED
    chunk_size: int = 0  # accepted for the reference CLI; the search is global
    test: bool = False
    max_pairs_per_row: int = 16  # the extract pass's per-row capacity floor
    # on-device embedding format: int8 (half the host-to-device bytes; exact
    # pair set through the float32 host recheck) or fp16 (the reference's)
    wire: str = "int8"
