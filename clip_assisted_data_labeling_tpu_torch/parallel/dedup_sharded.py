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
    DedupResult,
    _extract_chunk,
    _HostPass,
    _Wire,
    empty_result,
    extract_chunk_size,
    tile_metric,
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
    n = len(embeddings)
    host = _HostPass(n, threshold, sim_type, wire, max_per_row, timer)
    timer, int8 = host.timer, host.int8
    if mesh is None:
        from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh

        mesh = get_mesh(axis=axis)
    devs = mesh.local_devices(axis)
    n_local = len(devs)
    n_devices = mesh.shape[axis]
    first = mesh.process_index * n_local  # global index of this process's first shard
    if n < 2:  # the single-device path's contract for degenerate input
        return empty_result()

    with timer.time("prepare", n):
        # shards of m rows, m a multiple of the tile b (a multiple of 8, at
        # least 128 rows: torch._int_mm's shapes on the card)
        m0 = -(-n // n_devices)
        b = -(-min(row_block, max(128, m0)) // 8) * 8
        m = -(-m0 // b) * b
        rows, scales = host.prepare(embeddings, m * n_devices)
        with timer.time("upload", n):
            panels = []
            for i, dev in enumerate(devs):
                g = first + i
                x = torch.from_numpy(rows[g * m:(g + 1) * m]).to(dev)
                s = torch.from_numpy(scales[g * m:(g + 1) * m]).to(dev) if int8 else None
                panels.append((x, s) if int8 else (x,))
        del rows
        resident = list(panels)

    def topk(hc: np.ndarray, k: int):
        """Each shard's top-k against its own resident panel, merged on the
        host: [d, H, k] → [H, d·k] → the k largest."""
        panel, hit_s, gidx = host.hit_panel(hc)
        parts_v, parts_j = [], []
        for i, (wired, dev) in enumerate(zip(wires, devs)):
            v, j = _extract_chunk(
                wired, torch.from_numpy(panel).to(dev),
                None if hit_s is None else torch.from_numpy(hit_s).to(dev),
                torch.from_numpy(gidx).to(dev), b, m // b, n, k, offset=(first + i) * m)
            parts_v.append(v.cpu().numpy())
            parts_j.append(j.cpu().numpy())
        h_pad = len(panel)
        v = process_allgather(mesh, np.stack(parts_v))
        j = process_allgather(mesh, np.stack(parts_j))
        v = v.transpose(1, 0, 2).reshape(h_pad, -1)[: len(hc)]
        j = j.transpose(1, 0, 2).reshape(h_pad, -1)[: len(hc)]
        order = np.argsort(-v, axis=1)[:, :k]
        return np.take_along_axis(v, order, axis=1), np.take_along_axis(j, order, axis=1)

    with torch.inference_mode():
        with timer.time("counts", n):
            counts_dev = [torch.zeros(m, dtype=torch.int64, device=d) for d in devs]
            for step in range(n_devices):
                for i, (own, col) in enumerate(zip(resident, panels)):
                    src = (first + i - step) % n_devices
                    counts_dev[i] += _panel_counts(
                        own[0], own[1] if int8 else None, col[0], col[1] if int8 else None,
                        (first + i) * m, src * m, n, b, host.scan_threshold, host.euclidean)
                if step < n_devices - 1:
                    panels = ring_shift(mesh, panels)
            counts = process_allgather(mesh, np.concatenate([c.cpu().numpy() for c in counts_dev]))
        wires = [_Wire(p[0], p[1] if int8 else None, d, host.euclidean)
                 for p, d in zip(resident, devs)]
        return host.extract(counts, b, topk, extract_chunk_size)
