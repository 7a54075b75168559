"""Shared constants and the stage-1 config (port of the JAX package's
``config.py``: the crop names and aliases, CLIP and SigLIP normalization, image
extensions, the label database's columns and the stage configs
``EmbedConfig``, ``DedupConfig``, ``TrainConfig``, ``PredictConfig`` and
``SubsetConfig``)."""
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
    """Stage-1 embedding configuration (the JAX package's ``EmbedConfig``
    fields and defaults, plus the torch ``device`` and ``debug_nans``)."""

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
    exact_stats: bool = False  # host cv2 img_stat path (reference-exact values)
    shuffle_filenames: bool = True
    # multi-host runs: this host embeds the sorted file list's [i::n] shard
    # (sidecars only; merge with 'pipeline.store rebuild')
    host_index: int = 0
    host_count: int = 1
    write_sidecars: bool = True
    # "auto" = <root_dir>/<model>.calib.npz, "none" = in memory only,
    # anything else = an explicit npz path
    calibration: str = "auto"
    # "native" (naflex towers, bfloat16/float32): also embed each image at its
    # native aspect ratio, stored as a fifth pseudo-crop "native_aspect"
    aspect: str = "square"
    # "native": the most patches of an image's grid (None: the tower's square
    # grid, 256 at patch 16, HF's default)
    max_patches: int | None = None
    device: str = "cuda"
    # the port's counterpart of jax_debug_nans: check each block's output and
    # the readout, and raise FloatingPointError at the first NaN
    debug_nans: bool = False


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Stage-4 regressor training (same fields and defaults as the JAX
    package's ``TrainConfig``; the device is ``train_regressor``'s argument)."""

    clip_models_to_use: Sequence[str] = ("all",)
    crop_names: Sequence[str] = (CROP_CENTRE, CROP_SUB2)
    use_img_stat_features: bool = False
    test_fraction: float = 0.25
    n_epochs: int = 60
    batch_size: int = 16
    lr: float = 2e-4
    min_lr: float = 1e-6
    restart_epochs: int = 10
    weight_decay: float = 6e-4
    dropout_prob: float = 0.5
    hidden_sizes: Sequence[int] = (264, 128, 64)
    random_seed: int = 42
    model_name: str = "regressor"
    dont_save: bool = False
    export_torch: bool = False  # also write a reference-loadable .pth pickle
    print_network_layout: bool = False
    # softmax classes over the distinct label values; predictions are the
    # softmax-expected label value (the CSV contract is unchanged)
    classification: bool = False


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Stage-5 batch prediction (same fields and defaults as the JAX
    package's ``PredictConfig``)."""

    batch_size: int = 512
    copy_imgs_fraction: float = 0.01
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class SubsetConfig:
    """Stage-6 subset export (same fields and defaults as the JAX package's
    ``SubsetConfig``)."""

    min_score: float = 0.0
    max_score: float = 1.0
    extensions: Sequence[str] = (".jpg", ".txt", ".pt", ".pth")
    min_aspect_ratio: float = 0.25
    max_aspect_ratio: float = 4.0
    min_n_pixels: int = 512 * 512
    test: bool = False
