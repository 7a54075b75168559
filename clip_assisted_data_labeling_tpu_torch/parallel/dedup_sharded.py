"""Mesh-sharded all-pairs near-duplicate search (port of the JAX package's
``parallel/dedup_sharded.py``): the embeddings are row-sharded over a 1-D
device mesh, and the search runs in the two passes of the single-device
design (``ops/similarity.py``):

  1. counts — each shard keeps its row panel resident while the column
     panels ride the ring: at step s, shard p holds the panel first owned by
     shard (p − s) mod d, counts its exact above-threshold hits tile by tile
     (``ops/similarity.tile_metric``: ``torch._int_mm`` on the int8 wire,
     whose row scales travel with the panel, or fp16 products with float32
     sums), then hands the panel on (``parallel/mesh.ring_shift``: copies
     between a process's devices, gloo between processes). No top-k here.
  2. extract — the (rare) rows with hits are gathered on the host and
     replicated to every shard; each shard takes their top-k against its OWN
     resident panel, and the host merges the d partial lists.

Both wires scan at a lowered threshold, and every candidate is rechecked in
float32 on the host, so the pair set is exact and the same for both wires
and for any mesh. On a global mesh (``get_global_mesh``) every process
calls this with the same embeddings, feeds its own shards, and fetches the
counts and the partial top-k lists with an all-gather.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.ops.similarity import (
    FP16_SLACK,
    INT8_SLACK,
    DedupResult,
    _extract_chunk,
    _required_k,
    _Wire,
    build_hit_panel,
    build_hit_panel_q,
    empty_result,
    extract_chunk_size,
    filter_and_recheck,
    normalize_rows,
    quantize_rows_int8,
    tile_metric,
    warn_if_degenerate,
    wire_scan_threshold,
)
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import (
    Mesh,
    process_allgather,
    ring_shift,
)
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


def _panel_counts(rows: torch.Tensor, rows_s, cols: torch.Tensor, cols_s, gi0: int, gj0: int,
                  n: int, b: int, scan_threshold: float, euclidean: bool) -> torch.Tensor:
    """Per local row, the count of columns of one panel (global offsets
    ``gi0`` for the rows, ``gj0`` for the columns) later than the row, below
    ``n`` and above ``scan_threshold``, in b × b tiles; tiles with no such
    pair are skipped."""
    dev = rows.device
    m = rows.shape[0]
    lane = torch.arange(b, device=dev)
    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    for r0 in range(0, m, b):
        if gi0 + r0 >= n:
            break  # rows past N are padding
        gi = gi0 + r0 + lane
        rs = None if rows_s is None else rows_s[r0:r0 + b]
        for c0 in range(0, m, b):
            if gj0 + c0 >= n:
                break
            if gj0 + c0 + b - 1 <= gi0 + r0:
                continue  # every column at or before every row
            metric = tile_metric(rows[r0:r0 + b], rs, cols[c0:c0 + b],
                                 None if cols_s is None else cols_s[c0:c0 + b], euclidean)
            gj = gj0 + c0 + lane
            valid = (gj[None, :] > gi[:, None]) & (gj[None, :] < n) & (gi[:, None] < n)
            counts[r0:r0 + b] += (valid & (metric > scan_threshold)).sum(dim=1)
    return counts


def find_duplicate_pairs_sharded(
    embeddings: np.ndarray,
    threshold: float = 0.96,
    sim_type: str = "cosine",
    mesh: Mesh | None = None,
    max_per_row: int = 16,
    axis: str = "data",
    wire: str = "int8",
    row_block: int = 8192,
    timer: StageTimer | None = None,
) -> DedupResult:
    """The pair set of ``ops/similarity.find_duplicate_pairs`` over the
    ``axis`` devices of ``mesh`` (every local card by default). ``timer``,
    where given, takes the seconds of ``prepare`` (within it ``normalize``,
    ``quantize_rows`` and ``upload``, as the single-device path's),
    ``counts`` (the ring) and ``extract`` (within it ``topk``: the panels,
    the shards' top-k and the host merge; ``recheck``)."""
    if wire not in ("int8", "fp16"):
        raise ValueError(f"wire must be 'int8' or 'fp16', got {wire!r}")
    if mesh is None:
        from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh

        mesh = get_mesh(axis=axis)
    timer = timer or StageTimer()
    devs = mesh.local_devices(axis)
    n_local = len(devs)
    n_devices = mesh.shape[axis]
    first = mesh.process_index * n_local  # global index of this process's first shard
    n = len(embeddings)
    euclidean = sim_type == "euclidean"
    int8_wire = wire == "int8"
    if n < 2:  # the single-device path's contract for degenerate input
        return empty_result()
    scan_threshold = wire_scan_threshold(
        threshold, euclidean, INT8_SLACK if int8_wire else FP16_SLACK)

    with timer.time("prepare", n):
        # shards of m rows, m a multiple of the tile b (a multiple of 8, at
        # least 128 rows: torch._int_mm's shapes on the card), the width
        # padded with zero columns to a multiple of 8
        m0 = -(-n // n_devices)
        b = -(-min(row_block, max(128, m0)) // 8) * 8
        m = -(-m0 // b) * b
        n_pad = m * n_devices
        with timer.time("normalize", n):
            normed_f32 = np.pad(normalize_rows(embeddings), ((0, n_pad - n), (0, 0)))
        pad_d = -normed_f32.shape[1] % 8

        def widen(a: np.ndarray) -> np.ndarray:
            return np.pad(a, ((0, 0), (0, pad_d))) if pad_d else a

        with timer.time("quantize_rows", n):
            if int8_wire:
                q8, s_row = quantize_rows_int8(normed_f32)
                wide = widen(q8)
            else:
                normed16 = normed_f32.astype(np.float16)
                wide = widen(normed16)
        with timer.time("upload", n):
            panels = []
            for i, dev in enumerate(devs):
                g = first + i
                x = torch.from_numpy(wide[g * m:(g + 1) * m]).to(dev)
                s = torch.from_numpy(s_row[g * m:(g + 1) * m]).to(dev) if int8_wire else None
                panels.append((x, s) if int8_wire else (x,))
        resident = list(panels)

    with torch.inference_mode():
        with timer.time("counts", n):
            counts_dev = [torch.zeros(m, dtype=torch.int64, device=d) for d in devs]
            for step in range(n_devices):
                for i, (own, col) in enumerate(zip(resident, panels)):
                    src = (first + i - step) % n_devices
                    counts_dev[i] += _panel_counts(
                        own[0], own[1] if int8_wire else None, col[0],
                        col[1] if int8_wire else None, (first + i) * m, src * m, n, b,
                        scan_threshold, euclidean)
                if step < n_devices - 1:
                    panels = ring_shift(mesh, panels)
            counts = process_allgather(mesh, np.concatenate([c.cpu().numpy() for c in counts_dev]))
        hit = np.nonzero(counts > 0)[0]
        if hit.size == 0:
            return empty_result()

        # pass 2: the capacity escalates to fit the worst exact count, and
        # the hit rows go in chunks that bound every buffer (the single-device
        # contract, ops/similarity)
        warn_if_degenerate(counts, n, threshold, scan_threshold)
        k = min(_required_k(counts, max_per_row), n_pad)
        chunk = extract_chunk_size(b, k)
        wires = [_Wire(p[0], p[1] if int8_wire else None, d, euclidean)
                 for p, d in zip(resident, devs)]
        rows_l, cols_l, metrics_l = [], [], []
        with timer.time("extract", len(hit)):
            for c0 in range(0, len(hit), chunk):
                hc = hit[c0:c0 + chunk]
                with timer.time("topk", len(hc)):
                    if int8_wire:
                        panel, hit_s, gidx = build_hit_panel_q(hc, q8, s_row, n_pad)
                    else:
                        panel, gidx = build_hit_panel(hc, normed16, n_pad, dtype=np.float16)
                        hit_s = None
                    panel = widen(panel)
                    parts_v, parts_j = [], []
                    for i, (wired, dev) in enumerate(zip(wires, devs)):
                        v, j = _extract_chunk(
                            wired, torch.from_numpy(panel).to(dev),
                            None if hit_s is None else torch.from_numpy(hit_s).to(dev),
                            torch.from_numpy(gidx).to(dev), b, m // b, n, k,
                            offset=(first + i) * m)
                        parts_v.append(v.cpu().numpy())
                        parts_j.append(j.cpu().numpy())
                    # merge the d per-shard top-k lists: [d, H, k] → [H, d·k]
                    h_pad = len(panel)
                    v = process_allgather(mesh, np.stack(parts_v))
                    j = process_allgather(mesh, np.stack(parts_j))
                    v = v.transpose(1, 0, 2).reshape(h_pad, -1)[: len(hc)]
                    j = j.transpose(1, 0, 2).reshape(h_pad, -1)[: len(hc)]
                    order = np.argsort(-v, axis=1)[:, :k]
                    v = np.take_along_axis(v, order, axis=1)
                    j = np.take_along_axis(j, order, axis=1)
                with timer.time("recheck", len(hc)):
                    r, c, mets = filter_and_recheck(v, j, hc, normed_f32, scan_threshold,
                                                    threshold, euclidean)
                rows_l.append(r)
                cols_l.append(c)
                metrics_l.append(mets)
    return DedupResult(
        rows=np.concatenate(rows_l),
        cols=np.concatenate(cols_l),
        metrics=np.concatenate(metrics_l),
        overflow_rows=np.nonzero(counts > max_per_row)[0].astype(np.int64),
    )
