"""Columnar-store management CLI: rebuild / inspect the embedding store
(port of the JAX package's ``pipeline/store.py``; host only).

``rebuild`` scans the per-image ``.pt`` sidecars under a dataset root and
builds (or refreshes) the columnar ``EmbeddingStore`` from them. This is the
merge step of the multi-host embedding recipe (each host embeds a disjoint
file shard writing per-image sidecars, then one host runs

    python -m clip_assisted_data_labeling_tpu_torch.pipeline.store rebuild \
        --root_dir D [--models_to_use M ...]

and every later stage sees one merged store), and the import path for
datasets embedded by the reference toolkit, which writes the same sidecars.

``info`` prints a store's metadata (model, crops, rows, valid counts).
"""
from __future__ import annotations

import argparse
import os
import sys

from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore, store_dir_for


def _find_sidecars(root_dir: str) -> dict[str, str]:
    """uuid → sidecar path, walking the dataset recursively (sidecars share
    the image basename). Colliding basenames across subdirs are dropped
    LOUDLY: a silent overwrite would cross-contaminate store rows."""
    out: dict[str, str] = {}
    dropped = set()
    for dirpath, dirnames, filenames in os.walk(root_dir):
        dirnames[:] = [d for d in dirnames if d != ".ctpu_store"]
        for f in filenames:
            if f.endswith(".pt"):
                stem = os.path.splitext(f)[0]
                if stem in out:
                    dropped.add(stem)
                else:
                    out[stem] = os.path.join(dirpath, f)
    for stem in dropped:
        del out[stem]
        print(f"WARNING: basename {stem}.pt appears in multiple subdirs — "
              "dropping it from the rebuild (run prep to uuid-rename)")
    return out


def _sidecar_models(path: str) -> list[str]:
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    return list(read_sidecar(path).keys())


def rebuild(root_dir: str, models: list[str] | None) -> list[EmbeddingStore]:
    uuid_paths = _find_sidecars(root_dir)
    if not uuid_paths:
        raise SystemExit(f"No .pt sidecars found under {root_dir}")
    print(f"Found {len(uuid_paths)} sidecars under {root_dir}")
    if not models:
        models = _sidecar_models(next(iter(uuid_paths.values())))
        print(f"Rebuilding every model found in the first sidecar: {models}")
    stores = []
    for model in models:
        store = EmbeddingStore.from_sidecars(root_dir, model, uuid_paths)
        n_valid = int(store.valid.sum())
        print(
            f"[{model}] store rebuilt at {store.directory}: "
            f"{store.meta['n']} rows ({n_valid} valid), "
            f"crops {store.meta['crop_names']}, dim {store.meta['dim']}"
        )
        stores.append(store)
    return stores


def info(root_dir: str, models: list[str] | None) -> None:
    base = os.path.join(root_dir, ".ctpu_store")
    if not os.path.isdir(base):
        raise SystemExit(f"No store at {base}")
    names = models or sorted(os.listdir(base))
    for safe in names:
        model = safe  # stored dirs use '-' for '/', open() handles both
        if not os.path.exists(os.path.join(store_dir_for(root_dir, model), "meta.json")):
            print(f"[{safe}] no meta.json — skipping")
            continue
        s = EmbeddingStore.open(root_dir, model)
        print(
            f"[{s.meta['model_name']}] {s.meta['n']} rows "
            f"({int(s.valid.sum())} valid), crops {s.meta['crop_names']}, "
            f"dim {s.meta['dim']}, dtype {s.meta['dtype']}, "
            f"stats={'yes' if s.img_stats is not None else 'no'}"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("rebuild", "info"):
        p = sub.add_parser(name)
        p.add_argument("--root_dir", type=str, required=True)
        p.add_argument("--models_to_use", type=str, nargs="+", default=None,
                       help="model keys to process (default: every model in "
                            "the first sidecar)")
    args = parser.parse_args(argv)
    if args.command == "rebuild":
        rebuild(args.root_dir, args.models_to_use)
    else:
        info(args.root_dir, args.models_to_use)


if __name__ == "__main__":
    main(sys.argv[1:])
