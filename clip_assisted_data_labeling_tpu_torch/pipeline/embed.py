"""Stage 1 — embed every image with CLIP: 4 crops + handcrafted stats
(port of the JAX package's ``pipeline/embed.py``).

The host loader decodes onto fixed canvases; per batch the device runs the
4-crop extraction, resize, normalization, the tower's forward and the 22 image
stats. Outputs go to the reference-compatible ``.pt`` sidecars (incremental
per-model merge, skip-if-already-embedded) and the columnar store that later
stages read.

Towers: every name ``models/vit.resolve_config`` resolves (CLIP,
SigLIP/SigLIP2 with naflex, PE — no pretrained tag, e.g.
``PE-Core-L14-336`` —, EVA, CoCa, CLIPA, the modified ResNets ``RN50`` …
``RN50x64``, ConvNeXt ``convnext_*``); a SigLIP store's ``embed_dim`` is
the tower's width (1152 for ViT-SO400M-14-SigLIP-384).

CLI: the JAX stage's flags plus ``--device`` (default ``cuda``; ``cpu`` for
the CPU). ``--aspect native`` (naflex towers) adds a fifth pseudo-crop
``native_aspect`` (int8 modes run bfloat16 then); ``--exact_stats``
computes the stats on the host with cv2 from each file at its original
resolution; ``--profile_dir`` writes a torch.profiler trace (CPU and CUDA
activity, Chrome trace format) of the run; ``--debug_nans`` checks each
block's output and the readout and raises ``FloatingPointError`` at the
first NaN.

Several cards: with ``--device cuda`` (no index) and more than one card,
every batch is split over all local cards (``parallel/embed_sharded``;
``embed_dataset(..., mesh=...)`` takes any mesh). Several hosts:
``--host_count n --host_index i`` embeds the sorted file list's ``[i::n]``
shard, sidecars only (build the store afterwards with ``pipeline.store
rebuild``); int8_static shards share host 0's ``.calib.npz``, which the
other hosts wait for. ``--distributed`` derives both from the process rank
(``parallel/mesh.multihost_init``: gloo, ``--coordinator_address`` or
``COORDINATOR_ADDRESS``).
"""
from __future__ import annotations

import argparse
import collections
import logging
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS, EmbedConfig
from clip_assisted_data_labeling_tpu_torch.data.loader import (
    BatchedImageLoader,
    decode_rgb,
    find_images,
)
from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder, calibration_file
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    multihost_init,
    multihost_shutdown,
    stage_devices,
)
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import (
    IMG_STAT_KEYS,
    image_stats_batch,
    image_stats_reference,
)
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
from clip_assisted_data_labeling_tpu_torch.store.sidecar import (
    has_model_key,
    read_sidecar,
    resolve_crop_key,
    write_sidecar,
)
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

# how long non-zero hosts wait for host 0's published int8_static
# calibration (shared-filesystem multi-host runs; tests shrink it)
CALIB_WAIT_S = 1800.0

log = logging.getLogger(__name__)


def _uuid_of(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _sidecar_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".pt"


def _host_exact_stats(batch) -> np.ndarray:
    """Reference-exact img stats (host cv2) for --exact_stats runs: each
    image re-decoded from its file at its original resolution (the canvas
    copy may be pre-downscaled, which would skew the width/height/detail
    stats against the reference)."""
    out = np.zeros((batch.n_valid, len(IMG_STAT_KEYS)), np.float32)
    for i, path in enumerate(batch.paths):
        stats = image_stats_reference(decode_rgb(path))
        out[i] = [stats[k] for k in IMG_STAT_KEYS]
    return out


def _default_mesh(device: torch.device) -> Mesh | None:
    """Every local card where the device names no index and there are
    several; else None (one device)."""
    if stage_devices(device) is None and torch.cuda.device_count() > 1:
        return get_mesh()
    return None


def embed_dataset(root_dir: str, cfg: EmbedConfig,
                  mesh: Mesh | None = None) -> dict[str, EmbeddingStore | None]:
    """Run every requested model over the dataset. Returns per-model stores
    (None on a multi-host run, which writes sidecars only). ``mesh``: embed
    data-parallel over its devices (by default every local card where
    ``cfg.device`` is a bare ``cuda`` and there are several)."""
    device = resolve_device(cfg.device)
    mesh = mesh if mesh is not None else _default_mesh(device)
    img_paths = find_images(root_dir)
    if cfg.shuffle_filenames:
        random.shuffle(img_paths)
    else:
        img_paths.sort()
    print(f"---> Found {len(img_paths)} images in {root_dir}")

    # everything is keyed by basename uuid; colliding basenames would
    # cross-contaminate store rows, so drop duplicates loudly
    seen: set[str] = set()
    unique_paths = []
    for p in img_paths:
        u = _uuid_of(p)
        if u in seen:
            log.warning("Duplicate basename %r (%s) — skipping; uuid-rename the "
                        "dataset with the prep stage to embed all copies", u, p)
            continue
        seen.add(u)
        unique_paths.append(p)
    img_paths = unique_paths

    if cfg.host_count > 1:
        if not cfg.write_sidecars:
            raise ValueError(
                "--host_count > 1 requires sidecars (the per-shard results have "
                "no other output); drop --no_sidecars"
            )
        # each host embeds a deterministic disjoint shard of the sorted file
        # list; sidecars are per image, so the shards compose
        img_paths.sort()
        img_paths = img_paths[cfg.host_index:: cfg.host_count]
        print(f"Host shard {cfg.host_index}/{cfg.host_count}: {len(img_paths)} images")

    stores: dict[str, EmbeddingStore | None] = {}
    for model_name in cfg.models_to_use:
        print(f"\n--- Processing model: {model_name} ---")
        stores[model_name] = _embed_one_model(root_dir, img_paths, model_name, cfg, device, mesh)
    return stores


def _wait_for_calibration(path: str, host_index: int) -> None:
    """A non-zero host of a multi-host int8_static run: wait for host 0's
    ``.calib.npz`` on the shared filesystem, up to ``CALIB_WAIT_S``."""
    print(f"Host {host_index}: waiting for host 0's calibration at {path} ...")
    deadline = time.time() + CALIB_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"host 0 never published {path}")
        time.sleep(min(5.0, CALIB_WAIT_S / 10))


def _embed_one_model(root_dir, img_paths, model_name, cfg: EmbedConfig, device,
                     mesh: Mesh | None = None):
    timer = StageTimer()

    # incremental skip: only embed images whose sidecar lacks this model's key
    if cfg.force_reencode:
        todo, skipped = list(img_paths), []
    else:
        with timer.time("skip_check", len(img_paths)):
            with ThreadPoolExecutor(cfg.num_workers) as pool:
                have = list(pool.map(
                    lambda p: has_model_key(_sidecar_path(p), model_name), img_paths))
        todo = [p for p, h in zip(img_paths, have) if not h]
        skipped = [p for p, h in zip(img_paths, have) if h]
    print(f"Embedding {len(todo)} images ({len(skipped)} already embedded)")

    # int8_static scales pinned to one npz next to the dataset, so re-runs,
    # other orders and incremental resumes embed identically
    calibration_path = None
    publish_calib = False  # host 0 with nothing to embed: publish the scales
    if cfg.compute_dtype == "int8_static" and cfg.calibration != "none":
        calibration_path = (calibration_file(model_name, root_dir)
                            if cfg.calibration == "auto" else cfg.calibration)
        if cfg.host_count > 1 and not os.path.exists(calibration_path):
            # every host's shard must embed with ONE set of static scales:
            # host 0 calibrates and atomically publishes the npz (from its
            # first batch, or from an already-embedded image when its own
            # shard has nothing left to embed); a host with work waits for
            # it, a host without work never needs it
            if cfg.host_index == 0:
                publish_calib = bool(img_paths) and not todo
                if not img_paths:
                    print("WARNING: host 0 sees no images, so no calibration will be "
                          "published — other hosts with work will time out; pass "
                          "--calibration")
            elif todo:
                _wait_for_calibration(calibration_path, cfg.host_index)
    compute = cfg.compute_dtype
    if cfg.aspect == "native" and compute.startswith("int8"):
        # the masked variable-patch-grid path has no int8 formulation
        print("--aspect native has no int8 formulation; running bfloat16 "
              "(pass --compute_dtype float32 for the strict-parity path)")
        compute = "bfloat16"
    encoder = CLIPImageEncoder(
        model_name, model_path=cfg.model_path, compute_dtype=compute,
        calibration_path=calibration_path,
        device=device if mesh is None else mesh.devices.flat[0], debug_nans=cfg.debug_nans,
    )
    # --aspect native: one more embedding per image at its native aspect
    # through the naflex masked path, stored as a fifth pseudo-crop
    native_aspect = cfg.aspect == "native"
    if native_aspect and not getattr(encoder.cfg, "naflex", False):
        raise ValueError(f"--aspect native requires a naflex tower; {model_name} is "
                         "fixed-resolution (use a '…-naflex' SigLIP2 model name)")
    crop_names_out = list(cfg.crop_names) + (["native_aspect"] if native_aspect else [])

    # data-parallel: the batch splits over the mesh's devices, so its size
    # rounds up to a multiple of their count
    sharded = None
    batch_size = cfg.batch_size
    if mesh is not None:
        from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder

        sharded = ShardedEmbedder(
            encoder.model, encoder.cfg, mesh, compute_dtype=encoder.compute_dtype,
            parity_preprocess=encoder.parity_preprocess, calibration_path=calibration_path,
            model_name=encoder.model_name, debug_nans=cfg.debug_nans,
        )
        n_dev = sharded.n_devices
        batch_size = -(-cfg.batch_size // n_dev) * n_dev
        print(f"Data-parallel embedding over {n_dev} devices (batch {batch_size})")

    if publish_calib:
        print("Host 0: publishing calibration from an already-embedded batch")
        tiny = BatchedImageLoader(
            img_paths[:batch_size], canvas_size=cfg.canvas_size,
            out_size=encoder.img_resolution, batch_size=batch_size,
            num_workers=cfg.num_workers, crop_names=cfg.crop_names,
        )
        for batch in tiny:
            if sharded is not None:
                sharded.calibrate_static(batch.canvas, batch.crop_params)
            else:
                encoder.embed_crops(batch.canvas, batch.crop_params)
            break

    uuids_all = [_uuid_of(p) for p in img_paths]
    store = None
    if cfg.host_count > 1:
        # the hosts share the filesystem: the per-image sidecars compose
        # across shards, but the store is one file, built once afterwards
        print("Multi-host shard run: writing sidecars only; build the columnar store "
              "afterwards with 'pipeline.store rebuild'.")
    else:
        store = EmbeddingStore.create(
            root_dir, model_name, crop_names_out, encoder.embed_dim, uuids_all,
            with_stats=cfg.with_image_stats,
            rel_paths=[os.path.relpath(p, root_dir) for p in img_paths],
        )
    row_of = {u: i for i, u in enumerate(uuids_all)}

    loader = BatchedImageLoader(
        todo, canvas_size=cfg.canvas_size, out_size=encoder.img_resolution,
        batch_size=batch_size, num_workers=cfg.num_workers,
        crop_names=cfg.crop_names, bucketed=True, sort_by_size=True,
    )

    def write_batch_sidecars(paths, emb_np, stats_arr):
        for bi, path in enumerate(paths):
            crop_embs = {crop: emb_np[bi, ci] for ci, crop in enumerate(crop_names_out)}
            img_stats = (dict(zip(IMG_STAT_KEYS, map(float, stats_arr[bi])))
                         if stats_arr is not None else None)
            write_sidecar(_sidecar_path(path), model_name, crop_embs, img_stats,
                          merge=not cfg.force_reencode)

    device_stats = cfg.with_image_stats and not cfg.exact_stats

    def dispatch(batch):
        """Enqueue the batch's device work; returns device tensors (async on
        the card)."""
        if sharded is not None:
            if encoder.static_quant:
                # one calibration forward on the first batch, then a no-op
                sharded.calibrate_static(batch.canvas, batch.crop_params)
            if device_stats:
                return sharded.embed(batch.canvas, batch.crop_params, batch.stat_params)
            return sharded.embed(batch.canvas, batch.crop_params), None
        canvas = torch.from_numpy(batch.canvas).to(device, non_blocking=True)
        emb_dev = encoder.embed_crops(canvas, batch.crop_params)
        stats_dev = None
        if device_stats:
            with torch.inference_mode():
                stats_dev = image_stats_batch(canvas, torch.from_numpy(batch.stat_params))
        return emb_dev, stats_dev

    n_done = 0
    writer_futures = []
    with ThreadPoolExecutor(max(2, cfg.num_workers // 2)) as writer_pool:

        def consume(batch, emb_dev, stats_dev):
            nonlocal n_done
            with timer.time("device", batch.n_valid):
                emb = emb_dev[: batch.n_valid].cpu().numpy()
                if native_aspect:
                    # each image's pixels back off its centered canvas
                    # (stat_params = [ox, oy, w, h, …]) through the masked path
                    imgs = []
                    for bi in range(batch.n_valid):
                        ox, oy, w, h = (int(v) for v in batch.stat_params[bi, :4])
                        imgs.append(batch.canvas[bi, oy: oy + h, ox: ox + w])
                    nat = encoder.encode_variable(imgs).cpu().numpy()
                    emb = np.concatenate([emb, nat[:, None, :]], axis=1)
                stats_np = None if stats_dev is None else stats_dev[: batch.n_valid].cpu().numpy()
            if cfg.with_image_stats and cfg.exact_stats:
                with timer.time("exact_stats", batch.n_valid):
                    stats_np = _host_exact_stats(batch)
            if store is not None:
                with timer.time("store_write", batch.n_valid):
                    for bi, path in enumerate(batch.paths):
                        store.write_rows(row_of[_uuid_of(path)], emb[bi: bi + 1],
                                         None if stats_np is None else stats_np[bi: bi + 1])
            if cfg.write_sidecars:
                writer_futures.append(
                    writer_pool.submit(write_batch_sidecars, batch.paths, emb, stats_np))
            n_done += batch.n_valid
            if n_done and n_done % 1000 < cfg.batch_size:
                print(f"Processed {n_done}/{len(todo)} images")

        # depth-2 pipeline: dispatch batch i+1 before blocking on batch i's
        # results, so transfer, compute and host-side writes overlap
        pending: collections.deque = collections.deque()
        for batch in loader:
            pending.append((batch, *dispatch(batch)))
            if len(pending) > 1:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())

    # the .pt files are the interop contract: surface any failed write
    write_errors = [f.exception() for f in writer_futures if f.exception() is not None]
    if write_errors:
        raise RuntimeError(f"{len(write_errors)} sidecar write batches failed; "
                           f"first error: {write_errors[0]!r}")

    # backfill store rows for already-embedded images from their sidecars
    for path in skipped if store is not None else []:
        try:
            d = read_sidecar(_sidecar_path(path))[model_name]
            keys = [resolve_crop_key(d, c) for c in store.meta["crop_names"]]
            if any(k is None for k in keys):
                raise KeyError(f"missing crops in {_sidecar_path(path)}")
            emb = np.stack([np.asarray(d[k], np.float32).reshape(-1) for k in keys])
            stats = None
            if cfg.with_image_stats:
                stats = np.asarray([float(d[k]) for k in IMG_STAT_KEYS if k in d], np.float32)
                if len(stats) != len(IMG_STAT_KEYS):
                    stats = None
            store.write_rows(row_of[_uuid_of(path)], emb[None],
                             None if stats is None else stats[None])
        except Exception as e:  # keep going; the row stays invalid
            log.warning("Could not backfill %s: %s", path, e)
            store.valid[row_of[_uuid_of(path)]] = False
    if store is not None:
        for path in loader.skipped:
            store.valid[row_of[_uuid_of(path)]] = False
        store.flush()

    print("\n--- Feature encoding done! ---")
    print(f"Embedded {n_done} images ({len(skipped)} already embedded); model key '{model_name}'")
    print(timer.report())
    return store


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True,
                        help="Root directory of the dataset (can contain subdirectories)")
    parser.add_argument("--models_to_use", type=str, nargs="+",
                        default=["ViT-L-14-336/openai"],
                        help="CLIP or SigLIP (Arch/pretrained) or PE (e.g. "
                        "PE-Core-L14-336) models to use")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--force_reencode", action="store_true")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Local directory with model weights (.npz or torch)")
    parser.add_argument("--canvas_size", type=int, default=1024)
    parser.add_argument("--compute_dtype", type=str, default="int8_static",
                        choices=["bfloat16", "float32", "int8", "int8_static"],
                        help="int8_static (default) = W8A8 with fixed activation "
                        "scales calibrated on the first batch and pinned to "
                        "<root_dir>/<model>.calib.npz; int8 = W8A8 with dynamic "
                        "per-token activation scales (no calibration; "
                        "CTPU_INT8_BLOCK and CTPU_FUSED_QMATMUL pick its block "
                        "form); bfloat16/float32 = strict-parity paths")
    parser.add_argument("--no_sidecars", action="store_true",
                        help="Skip per-image .pt sidecars (columnar store only)")
    parser.add_argument("--no_image_stats", action="store_true")
    parser.add_argument("--exact_stats", action="store_true",
                        help="compute img_stat_* on the host with cv2 from each file at its "
                        "original resolution (reference-exact values; slower)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the run (CPU and CUDA "
                        "activity, Chrome trace format) into this directory")
    parser.add_argument("--host_index", type=int, default=0,
                        help="multi-host runs: this host's index in [0, host_count)")
    parser.add_argument("--host_count", type=int, default=1,
                        help="multi-host runs: total hosts; each embeds a "
                        "deterministic disjoint shard of the file list")
    parser.add_argument("--distributed", action="store_true",
                        help="join a multi-process run (torch.distributed over gloo; "
                        "coordinator from --coordinator_address or $COORDINATOR_ADDRESS) "
                        "and derive --host_index/--host_count from the process rank; "
                        "merge afterwards with 'pipeline.store rebuild'")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 for --distributed")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--debug_nans", action="store_true",
                        help="check each block's output and the readout, and raise "
                        "FloatingPointError naming the first block that produced a NaN")
    parser.add_argument("--aspect", type=str, default="square", choices=["square", "native"],
                        help="'native' (naflex towers, bfloat16/float32 only): also embed "
                        "each image at its native aspect ratio through the masked "
                        "variable-patch-grid path, stored as a fifth pseudo-crop "
                        "'native_aspect'")
    parser.add_argument("--calibration", type=str, default="auto",
                        help="int8_static activation-scale persistence: 'auto' "
                        "(default) pins scales to <root_dir>/<model>.calib.npz; "
                        "'none' keeps them in memory; any other value is an npz path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.distributed:
        args.host_index, args.host_count = multihost_init(
            args.coordinator_address, args.num_processes, args.process_id)
        print(f"torch.distributed up: host {args.host_index}/{args.host_count}")
    cfg = EmbedConfig(
        models_to_use=args.models_to_use,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        force_reencode=args.force_reencode,
        model_path=args.model_path,
        crop_names=ALL_CROPS,
        canvas_size=args.canvas_size,
        compute_dtype=args.compute_dtype,
        with_image_stats=not args.no_image_stats,
        exact_stats=args.exact_stats,
        host_index=args.host_index,
        host_count=args.host_count,
        write_sidecars=not args.no_sidecars,
        calibration=args.calibration,
        aspect=args.aspect,
        device=args.device,
        debug_nans=args.debug_nans,
    )
    try:
        if args.profile_dir is None:
            return embed_dataset(args.root_dir, cfg)
        return _profiled(args.root_dir, cfg, args.profile_dir)
    finally:
        if args.distributed:
            multihost_shutdown()


def _profiled(root_dir: str, cfg: EmbedConfig, profile_dir: str):
    """embed_dataset under torch.profiler (CPU activity, and CUDA activity
    where the run is on the card), the trace written into ``profile_dir`` as
    ``embed_trace.json`` (Chrome trace format; the JAX stage's
    jax.profiler writes TensorBoard's format instead)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = resolve_device(cfg.device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        stores = embed_dataset(root_dir, cfg)
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(profile_dir, "embed_trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
    return stores


if __name__ == "__main__":
    main()
