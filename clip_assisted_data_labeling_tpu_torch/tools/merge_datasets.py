"""Merge multiple labeled datasets into labeled/unlabeled splits (port of the
JAX package's ``tools/merge_datasets.py``; host only, no pandas).

    python -m clip_assisted_data_labeling_tpu_torch.tools.merge_datasets \\
        --data_dir <dir of dataset subfolders + their CSVs> --output_dir <dir> [--copy]

Concatenates every subdir's CSV (tagging rows with ``source_datadir``),
splits on label presence, writes labeled.csv/unlabeled.csv and moves (or
copies) each uuid's file group into labeled/ or unlabeled/, with the JAX
tool's ``<subdir>_`` prefix where a uuid's file clashes.

The JAX tool reads and writes the CSVs with pandas; the port with the
stdlib ``csv`` module, in the port's CSV conventions (``store/database.py``:
the uuid column as text, a missing value as an empty field, pandas'
missing-value strings read as missing) and with pandas' typing of each
column, so the files are pandas' byte for byte: each file's column is an
integer column where every cell is an integer (written ``1``), a float
column where every present cell is a number (a gap makes an integer column
float: ``1.0``), a boolean column of ``True``/``False`` cells, else text (a
file without rows too); the concatenation takes the union of the columns in
first-seen order, and a numeric column that is absent from some file, or
integer in one and float in another, becomes float; any other mix keeps
each cell as its file typed it. Two cases part from pandas (ROADMAP.md,
Known differences): a boolean column mixed with numbers (pandas 3 casts it
to the numbers' type or not, by the files' order), and a float written with
17 significant digits (pandas' own parser may read it one unit in the last
place off; the port reads it with Python's ``float``).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import math
import os
import re
import shutil

from clip_assisted_data_labeling_tpu_torch.store.database import _NA

DEFAULT_EXTENSIONS = [".jpg", ".json", ".txt", ".pt", ".pth"]

_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*(e[+-]?\d+)?|\.\d+(e[+-]?\d+)?|inf|infinity)\Z", re.I)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


@dataclasses.dataclass
class Table:
    """CSV rows as pandas types them: column name → one value a row (int,
    float with NaN for a missing number, bool, str, or None for a missing
    value of a text column), in file order."""

    columns: dict[str, list]

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def take(self, rows: list[int]) -> "Table":
        return Table({name: [vals[i] for i in rows] for name, vals in self.columns.items()})

    def write_csv(self, path: str) -> None:
        """pandas' ``to_csv(index=False)`` of the same table."""
        names = list(self.columns)
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(names)
            for row in zip(*self.columns.values()):
                w.writerow([_cell(v) for v in row])


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _typed(name: str, cells: list[str]) -> tuple[str, list]:
    """(kind, values) of one file's column, as ``pd.read_csv(...,
    dtype={"uuid": str})`` types it: "int", "float", "bool", or "text"."""
    if name == "uuid" or not cells:  # a file without rows gives text columns
        return "text", cells
    present = [c for c in cells if c not in _NA]
    if present and all(_INT.match(c) for c in present):
        if len(present) == len(cells):
            return "int", [int(c) for c in cells]
        return "float", [math.nan if c in _NA else float(c) for c in cells]
    if all(_FLOAT.match(c) for c in present):  # an empty column is float too
        return "float", [math.nan if c in _NA else float(c) for c in cells]
    if all(c in _BOOLS for c in present):
        kind = "bool" if len(present) == len(cells) else "text"
        return kind, [None if c in _NA else _BOOLS[c] for c in cells]
    return "text", [None if c in _NA else c for c in cells]


def read_csv(path: str) -> dict[str, tuple[str, list]]:
    """A dataset CSV → column name → (kind, values) (:func:`_typed`)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = []
        for r in reader:
            if not r:
                continue  # a blank line, as pandas skips it
            if len(r) > len(header):
                raise ValueError(f"{path}: expected {len(header)} fields, saw {len(r)}")
            rows.append(r + [""] * (len(header) - len(r)))
    return {name: _typed(name, [r[i] for r in rows]) for i, name in enumerate(header)}


def concat(frames: list[dict[str, tuple[str, list]]]) -> Table:
    """``pd.concat`` of the typed files: the union of their columns in
    first-seen order, the rows in file order, each column's type as the
    module docstring says."""
    names: list[str] = []
    for frame in frames:
        names += [n for n in frame if n not in names]
    columns = {}
    for name in names:
        kinds = {frame[name][0] if name in frame else None for frame in frames}
        to_float = len(kinds) > 1 and kinds <= {"int", "float", None}
        vals: list = []
        for frame in frames:
            n = len(next(iter(frame.values()))[1]) if frame else 0
            if name not in frame:
                vals += [math.nan if to_float else None] * n
            else:
                vals += [float(v) for v in frame[name][1]] if to_float else frame[name][1]
        columns[name] = vals
    return Table(columns)


def merge_datasets(data_dir: str, output_dir: str,
                   extensions=DEFAULT_EXTENSIONS, move: bool = True):
    labeled_dir = os.path.join(output_dir, "labeled")
    unlabeled_dir = os.path.join(output_dir, "unlabeled")
    os.makedirs(labeled_dir, exist_ok=True)
    os.makedirs(unlabeled_dir, exist_ok=True)

    frames = []
    for subdir in sorted(os.listdir(data_dir)):
        if not os.path.isdir(os.path.join(data_dir, subdir)):
            continue
        csv_path = os.path.join(data_dir, f"{subdir}.csv")
        if os.path.exists(csv_path):
            frame = read_csv(csv_path)
            n = len(next(iter(frame.values()))[1]) if frame else 0
            frame["source_datadir"] = ("text", [subdir] * n)
            frames.append(frame)
    if not frames:
        print(f"No dataset CSVs found in {data_dir}")
        return None, None

    combined = concat(frames)
    has_label = [not _missing(v) for v in combined.columns["label"]]
    labeled = combined.take([i for i, h in enumerate(has_label) if h])
    unlabeled = combined.take([i for i, h in enumerate(has_label) if not h])
    labeled.write_csv(os.path.join(output_dir, "labeled.csv"))
    unlabeled.write_csv(os.path.join(output_dir, "unlabeled.csv"))

    def move_files(table, destination):
        moved, clashes = 0, 0
        for uuid, src_sub in zip(table.columns["uuid"], table.columns["source_datadir"]):
            for ext in extensions:
                src = os.path.join(data_dir, src_sub, f"{uuid}{ext}")
                if os.path.exists(src):
                    dst = os.path.join(destination, f"{uuid}{ext}")
                    if os.path.exists(dst):
                        # the same uuid in two source subdirs: clobbering
                        # would lose a file in move mode — keep both with a
                        # disambiguating source prefix
                        dst = os.path.join(destination, f"{src_sub}_{uuid}{ext}")
                        clashes += 1
                    (shutil.move if move else shutil.copy)(src, dst)
                    moved += 1
        print(f"{'Moved' if move else 'Copied'} {moved} files to {destination}")
        if clashes:
            print(f"WARNING: {clashes} files shared a uuid across source "
                  "subdirs — kept with a '<subdir>_' prefix (re-run prep to "
                  "re-uuid them)")

    move_files(labeled, labeled_dir)
    move_files(unlabeled, unlabeled_dir)
    return labeled, unlabeled


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", required=True,
                        help="directory of dataset subfolders + their CSVs")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--extensions", nargs="+", default=DEFAULT_EXTENSIONS)
    parser.add_argument("--copy", action="store_true", help="copy instead of move")
    args = parser.parse_args(argv)
    merge_datasets(args.data_dir, args.output_dir, args.extensions, move=not args.copy)


if __name__ == "__main__":
    main()
