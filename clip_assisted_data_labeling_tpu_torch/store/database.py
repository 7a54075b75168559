"""The CSV label database: ``<root_dir>.csv`` stored in the parent of root_dir
(port of the JAX package's ``store/database.py``; the file is the same).

Schema and semantics replicate the reference so databases interoperate:
  * columns uuid,label,timestamp,predicted_label
  * location: parent dir, named after root_dir
  * single-slot timestamped backup before a labeling session
  * human-label upsert with unix timestamp
  * batch-prediction merge that never clobbers existing rows' labels and
    fills predicted_label/timestamp (a NaN score keeps the old value)
  * fix_database: copy human labels into predicted_label

The JAX package holds the table in a pandas DataFrame; the port reads and
writes it with the stdlib ``csv`` module (pandas is not a dependency of the
port), with a missing value as an empty field, as pandas writes NaN. The
uuid column stays text (an all-digit uuid keeps its leading zeros), the
three numeric columns are float64 arrays (``column``), and columns the file
has beyond the four are kept as text and written back in their place.
"""
from __future__ import annotations

import csv
import glob
import os
import shutil
import time

import numpy as np

from clip_assisted_data_labeling_tpu_torch.config import DB_COLUMNS

_NUMERIC = DB_COLUMNS[1:]  # label, timestamp, predicted_label
# the strings pandas' read_csv takes as a missing value
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})


def database_path_for(root_dir: str) -> str:
    root_dir = root_dir.rstrip("/")
    return os.path.join(
        os.path.dirname(root_dir), os.path.basename(root_dir) + ".csv"
    )


def _parse(cell: str) -> float:
    return np.nan if cell in _NA else float(cell)


def _format(v: float) -> str:
    return "" if np.isnan(v) else repr(float(v))


class LabelDatabase:
    def __init__(self, columns: dict, path: str):
        """columns: name → values, in file order; the four DB columns are
        added (all missing) where absent."""
        n = len(next(iter(columns.values()), []))
        self._cols: dict[str, object] = {}
        for name, vals in columns.items():
            if name == "uuid":
                self._cols[name] = [str(u) for u in vals]
            elif name in _NUMERIC:
                self._cols[name] = np.asarray(vals, np.float64).reshape(n)
            else:
                self._cols[name] = list(vals)
        for name in DB_COLUMNS:
            if name not in self._cols:
                self._cols[name] = [""] * n if name == "uuid" else np.full(n, np.nan)
        self.path = path
        self._pos: dict[str, int] | None = None

    def _uuid_positions(self) -> dict:
        """uuid → row, built once; every method that adds rows keeps it. On
        duplicate uuids the FIRST occurrence wins, as in the JAX package."""
        if self._pos is None:
            uu = self._cols["uuid"]
            self._pos = {u: i for i, u in zip(range(len(uu) - 1, -1, -1), uu[::-1])}
        return self._pos

    # --- lifecycle --------------------------------------------------------------
    @classmethod
    def load_or_create(cls, root_dir: str) -> "LabelDatabase":
        path = database_path_for(root_dir)
        if not os.path.exists(path):
            return cls({c: [] for c in DB_COLUMNS}, path)
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = [r + [""] * (len(header) - len(r)) for r in reader if r]
        columns = {}
        for i, name in enumerate(header):
            cells = [r[i] for r in rows]
            # the uuid column is text: an all-digit uuid4 hex must not become
            # an int (the JAX package pins dtype={"uuid": str} for the same)
            columns[name] = ([_parse(c) for c in cells] if name in _NUMERIC else cells)
        return cls(columns, path)

    def save(self) -> None:
        names = list(self._cols)
        cols = [self._cols[n] for n in names]
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(names)
            for i in range(len(self)):
                w.writerow([_format(c[i]) if n in _NUMERIC else c[i]
                            for n, c in zip(names, cols)])

    def create_backup(self) -> str | None:
        """Single-slot timestamped backup next to the DB."""
        if not os.path.exists(self.path):
            return None
        folder = os.path.dirname(self.path) or "."
        for f in glob.glob(os.path.join(folder, "*")):
            if "_db_backup_" in os.path.basename(f):
                os.remove(f)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        backup = self.path.replace(".csv", f"_db_backup_{stamp}.csv")
        shutil.copy(self.path, backup)
        return backup

    # --- queries ----------------------------------------------------------------
    def column(self, name: str):
        """A column's values: float64 array for label, timestamp and
        predicted_label; list of str for uuid and any other column."""
        return self._cols[name]

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    def get_label(self, uuid: str):
        pos = self._uuid_positions().get(uuid)
        return None if pos is None else self._cols["label"][pos]

    def get_predicted_label(self, uuid: str):
        pos = self._uuid_positions().get(uuid)
        return None if pos is None else self._cols["predicted_label"][pos]

    def n_labeled(self) -> int:
        return int((~np.isnan(self._cols["label"])).sum())

    def __len__(self) -> int:
        return len(self._cols["uuid"])

    # --- mutations ----------------------------------------------------------------
    def _append(self, uuids: list[str], values: dict[str, np.ndarray]) -> None:
        """Add rows: the uuids, the numeric columns from ``values`` (NaN where
        absent), and empty text in any other column."""
        pos = self._uuid_positions()
        n0, k = len(self), len(uuids)
        for name, col in self._cols.items():
            if name == "uuid":
                col.extend(uuids)
            elif name in _NUMERIC:
                add = values.get(name, np.full(k, np.nan))
                self._cols[name] = np.concatenate([col, np.asarray(add, np.float64)])
            else:
                col.extend([""] * k)
        for i, u in enumerate(uuids):
            pos.setdefault(u, n0 + i)

    def relabel(self, uuid: str, label: float) -> None:
        """Human-label upsert."""
        now = float(int(time.time()))
        pos = self._uuid_positions().get(uuid)
        if pos is None:
            self._append([uuid], {"label": [label], "timestamp": [now]})
        else:
            self._cols["label"][pos] = label
            self._cols["timestamp"][pos] = now

    def ensure_rows(self, uuids: list[str]) -> int:
        """Bulk-register uuids as unlabeled rows. Returns #added."""
        pos = self._uuid_positions()
        missing = [u for u in uuids if u not in pos]
        if missing:
            self._append(missing, {})
        return len(missing)

    def merge_predictions(self, uuids: list[str], scores: np.ndarray) -> None:
        """Merge batch predictions: new uuids get rows; existing rows get
        predicted_label/timestamp updated; human labels are untouched."""
        now = float(int(time.time()))
        scores = np.asarray(scores, np.float64)
        pos = self._uuid_positions()
        rows = np.fromiter((pos.get(u, -1) for u in uuids), np.int64, count=len(uuids))
        hit = rows >= 0
        if hit.any():
            hit_rows, hit_scores = rows[hit], scores[hit]
            ok = ~np.isnan(hit_scores)  # parity: a NaN score keeps the old value
            self._cols["predicted_label"][hit_rows[ok]] = hit_scores[ok]
            self._cols["timestamp"][hit_rows] = now
        if not hit.all():
            miss = ~hit
            self._append([u for u, m in zip(uuids, miss) if m],
                         {"timestamp": np.full(int(miss.sum()), now),
                          "predicted_label": scores[miss]})

    def fix_database(self) -> None:
        """Copy human labels into predicted_label."""
        label = self._cols["label"]
        mask = ~np.isnan(label)
        self._cols["predicted_label"][mask] = label[mask]
