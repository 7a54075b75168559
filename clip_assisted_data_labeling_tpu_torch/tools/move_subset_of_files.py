"""Sample a fraction of a dataset into a sibling directory (port of the JAX
package's ``tools/move_subset_of_files.py``; host only, stdlib only).

Images travel with their sidecar files, so selection happens per *stem*
(basename without extension): a stem is either fully copied — every matching
extension, with its position under the root preserved — or left behind. The
walk, the per-stem Bernoulli(fraction) draw from ``random.Random(seed)`` and
the copies are the JAX tool's, so the same ``--seed`` picks the same stems
and writes the same tree.

    python -m clip_assisted_data_labeling_tpu_torch.tools.move_subset_of_files \\
        --root_dir <dir> --fraction_f 0.25 --file_extensions .jpg .pt --seed 0
"""
from __future__ import annotations

import argparse
import os
import random
import shutil
from pathlib import Path


def group_by_stem(root_dir: str, extensions) -> dict[str, list[str]]:
    """stem → all files under root_dir (recursive) carrying that stem and one
    of the wanted extensions."""
    groups: dict[str, list[str]] = {}
    for dirpath, _dirs, filenames in os.walk(root_dir):
        for name in filenames:
            stem, ext = os.path.splitext(name)
            if any(name.endswith(e) for e in extensions):
                groups.setdefault(stem, []).append(os.path.join(dirpath, name))
    return groups


def sample_groups(groups: dict[str, list[str]], fraction: float,
                  seed: int | None) -> list[str]:
    """Independent Bernoulli(fraction) draw per stem; deterministic with seed."""
    rng = random.Random(seed)
    return [stem for stem in groups if rng.random() < fraction]


def copy_files(files: dict, root_dir: str, out_dir: str, fraction: float,
               seed: int | None = None) -> int:
    chosen = sample_groups(files, fraction, seed)
    for stem in chosen:
        for src in files[stem]:
            dst = os.path.join(out_dir, os.path.relpath(src, root_dir))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(src, dst)
    print(f"Sampled {len(chosen)}/{len(files)} stems "
          f"(target fraction {fraction:g}) into {out_dir}")
    return len(chosen)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--fraction_f", type=float, default=0.01)
    parser.add_argument("--file_extensions", nargs="+", default=[".jpg"])
    parser.add_argument("--seed", type=int, default=None,
                        help="seed the sampler for reproducible subsets")
    args = parser.parse_args(argv)

    root = str(Path(args.root_dir).resolve())
    out = args.out_dir or root + f"_{args.fraction_f:.3f}_subset"
    copy_files(group_by_stem(root, args.file_extensions), root, out,
               args.fraction_f, args.seed)


if __name__ == "__main__":
    main()
