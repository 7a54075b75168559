"""Stage 2 — near-duplicate removal via all-pairs cosine similarity (port of
the JAX package's ``pipeline/dedup.py``).

Embeddings stream from the columnar store (sidecar fallback), the similarity
runs tiled on the card (``ops/similarity.py``), or over every local card in
a ring (``parallel/dedup_sharded.py``) with ``--device cuda`` and more than
one card, and the whole dataset is searched in one global pass: no chunk
boundaries, no missed cross-chunk pairs.

File handling replicates the reference: above-threshold pairs send the
*target* file group (every file whose basename stem is the image's) to a
sibling ``near_duplicates_{sim}_{thr}`` dir with ``{sim:.3f}_{idx:08d}_``
prefixes; copy mode also copies the source group; ``--test`` dry-runs.

CLI: the JAX stage's flags plus ``--device`` (default ``cuda``; ``cpu`` for
the CPU). ``--distributed`` (launched in every process at once, after
``pipeline.store rebuild`` merged the hosts' shards) rings the search over
every process's devices (``parallel/mesh.multihost_init``: gloo); every
process computes the pairs, and only rank 0 copies or moves files.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import DedupConfig
from clip_assisted_data_labeling_tpu_torch.ops.similarity import (
    DedupResult,
    empty_result,
    find_duplicate_pairs,
)
from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore, list_models
from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar, resolve_crop_key
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import (
    get_global_mesh,
    get_mesh,
    multihost_init,
    multihost_shutdown,
    stage_devices,
)
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


def load_embeddings(root_dir: str, cfg: DedupConfig):
    """(paths, embeddings [N, D]) for the dedup crop. Store first, sidecars
    second."""
    model = cfg.clip_model_to_use
    if model is None:
        names = list_models(root_dir)
        if names:
            model = names[0]
            print(f"----> clip_model_to_use not specified, using store: {model}")
    if model is not None and EmbeddingStore.exists(root_dir, model):
        store = EmbeddingStore.open(root_dir, model)
        ci = store.crop_index(cfg.crop_to_use)
        valid = np.asarray(store.valid)
        emb = np.asarray(store.embeddings[:, ci], np.float32)[valid]
        paths = [
            os.path.join(root_dir, rel)
            for rel, v in zip(store.rel_paths(), valid)
            if v
        ]
        return paths, emb

    # sidecar fallback (reference-embedded datasets): an image is a stem with
    # both a .jpg and a .pt
    paths, embs = [], []
    for sub, _dirs, files in os.walk(root_dir):
        stems = {}
        for f in files:
            stem, ext = os.path.splitext(f)
            stems.setdefault(stem, set()).add(ext)
        for stem, exts in sorted(stems.items()):
            if ".jpg" not in exts or ".pt" not in exts:
                continue
            try:
                d = read_sidecar(os.path.join(sub, stem + ".pt"))
                if model is None:
                    model = next(iter(d.keys()))
                    print(f"----> clip_model_to_use not specified, defaulting to: {model}")
                feats = d[model]
                key = resolve_crop_key(feats, cfg.crop_to_use)
                if key is None:
                    continue
                embs.append(np.asarray(feats[key], np.float32).reshape(-1))
                paths.append(os.path.join(sub, stem + ".jpg"))
            except Exception:  # an unreadable or foreign sidecar: skip the image
                continue
    return paths, (np.stack(embs) if embs else np.zeros((0, 1), np.float32))


def fix_duplicate(index: int, pair_paths, outdir: str, sim_value: float, mode: str,
                  group_lookup=None):
    """Move/copy the file groups of a duplicate pair.

    A file group is the EXACT basename stem (``uuid.ext`` sidecar
    families). ``group_lookup`` (dirname → stem → files, built once by
    run_dedup) replaces a listing per pair; the ``exists`` guard keeps a
    cached listing safe once move-mode renames begin."""
    for role, path in zip(("source", "target"), pair_paths):
        dirname = os.path.dirname(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        if group_lookup is not None:
            group = group_lookup(dirname).get(stem, [])
        else:
            try:
                group = [f for f in os.listdir(dirname)
                         if os.path.splitext(f)[0] == stem]
            except FileNotFoundError:
                continue
        for f in group:
            src = os.path.join(dirname, f)
            dst = os.path.join(outdir, f"{sim_value:.3f}_{index:08d}_{role}_{f}")
            if mode == "copy":
                shutil.copy(src, dst)
            elif mode == "move" and role == "target" and os.path.exists(src):
                os.rename(src, dst)


def run_dedup(root_dir: str, cfg: DedupConfig, device: str | torch.device = "cuda",
              use_mesh: bool | None = None, global_mesh: bool = False) -> DedupResult:
    """Find the near-duplicate pairs and copy or move their file groups.
    ``device`` is the card unless the caller asks for the CPU. ``use_mesh``
    rings the search over a mesh of this process's devices (by default where
    ``device`` is a bare ``cuda`` and there are several cards: every card;
    else the one ``device``); ``global_mesh=True`` over every process's
    (all processes call this at once, after ``multihost_init``), and only
    process 0 then copies or moves files."""
    device = resolve_device(device)
    paths, emb = load_embeddings(root_dir, cfg)
    print(f"Loaded {len(paths)} embeddings, computing similarities..")
    if len(paths) < 2:
        return empty_result()
    devices = stage_devices(device)
    timer = StageTimer()
    if use_mesh is None:
        use_mesh = global_mesh or (devices is None and torch.cuda.device_count() > 1)
    if use_mesh:
        from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
            find_duplicate_pairs_sharded,
        )

        result = find_duplicate_pairs_sharded(
            emb, threshold=cfg.threshold, sim_type=cfg.sim_type,
            mesh=get_global_mesh(devices=devices) if global_mesh else get_mesh(devices=devices),
            max_per_row=cfg.max_pairs_per_row, wire=cfg.wire, timer=timer,
        )
    else:
        result = find_duplicate_pairs(
            emb, threshold=cfg.threshold, sim_type=cfg.sim_type,
            max_per_row=cfg.max_pairs_per_row, wire=cfg.wire, device=device, timer=timer,
        )
    print(timer.report())
    if result.overflow_rows.size:
        print(
            f"Note: {len(result.overflow_rows)} rows had more matches than the "
            f"configured per-row capacity ({cfg.max_pairs_per_row}); extraction "
            "capacity was escalated automatically to fit, all pairs recovered."
        )

    print(f"Found {len(result.rows)} duplicates!")
    if global_mesh and torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
        return result  # every process computed the pairs; rank 0 moves files
    if len(result.rows) and not cfg.test:
        output_dir = os.path.join(
            os.path.dirname(root_dir.rstrip("/")),
            f"near_duplicates_{cfg.sim_type}_{cfg.threshold}",
        )
        os.makedirs(output_dir, exist_ok=True)
        verb = "copying" if cfg.mode == "copy" else "moving"
        print(f"{verb} {len(result.rows)} near duplicates to {output_dir}...")
        listing_cache: dict[str, dict[str, list[str]]] = {}

        def group_lookup(dirname: str) -> dict[str, list[str]]:
            if dirname not in listing_cache:
                groups: dict[str, list[str]] = {}
                try:
                    for f in os.listdir(dirname):
                        groups.setdefault(os.path.splitext(f)[0], []).append(f)
                except FileNotFoundError:
                    pass
                listing_cache[dirname] = groups
            return listing_cache[dirname]

        moved_targets = set()
        for idx, (i, j, sim) in enumerate(result.pairs()):
            if cfg.mode == "move" and j in moved_targets:
                continue  # a target already moved has no files left to move
            fix_duplicate(idx, (paths[i], paths[j]), output_dir, sim, cfg.mode,
                          group_lookup=group_lookup)
            moved_targets.add(j)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=0.96)
    parser.add_argument("--mode", type=str, default="copy", choices=["copy", "move"])
    parser.add_argument("--sim_type", type=str, default="cosine",
                        choices=["cosine", "euclidean"])
    parser.add_argument("--clip_model_to_use", type=str, default=None)
    parser.add_argument("--chunk_size", type=int, default=0,
                        help="accepted for reference-CLI compatibility; the search "
                        "covers the whole dataset globally")
    parser.add_argument("--max_pairs_per_row", type=int, default=16)
    parser.add_argument("--wire", type=str, default="int8", choices=["int8", "fp16"],
                        help="on-device embedding format: int8 halves the "
                        "host->device bytes (pair set stays exact via an f32 "
                        "host recheck); fp16 is the reference-parity format")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--distributed", action="store_true",
                        help="ring the similarity over ALL processes' devices; launch "
                        "this CLI in every process at once (torch.distributed over "
                        "gloo, as embed --distributed); rank 0 handles the file moves")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.distributed:
        rank, count = multihost_init(args.coordinator_address, args.num_processes,
                                     args.process_id)
        print(f"torch.distributed up: process {rank}/{count}")
    cfg = DedupConfig(
        threshold=args.threshold,
        mode=args.mode,
        sim_type=args.sim_type,
        clip_model_to_use=args.clip_model_to_use,
        chunk_size=args.chunk_size,
        test=args.test,
        max_pairs_per_row=args.max_pairs_per_row,
        wire=args.wire,
    )
    try:
        return run_dedup(args.root_dir, cfg, device=args.device, global_mesh=args.distributed)
    finally:
        if args.distributed:
            multihost_shutdown()


if __name__ == "__main__":
    main()
