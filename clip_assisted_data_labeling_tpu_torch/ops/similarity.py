"""All-pairs similarity with on-device pair emission: the dedup compute core
(port of the JAX package's ``ops/similarity.py``).

The N×N matrix is never materialized. The work is tiled into
``[row_block × row_block]`` products in two passes:

1. scan: every tile of the upper triangle runs the product, the metric and a
   per-row count of entries above the (wire-lowered) threshold;
2. extract: the rows with a nonzero count (rare: actual duplicates) are
   gathered into padded panels and get an exact per-row top-k against every
   column panel; the host keeps the candidates above the threshold and
   rechecks each in float32 (``filter_and_recheck``).

The JAX package leaves these products to XLA (no Pallas kernel), so here
they are torch products on the card: the int8 wire ``torch._int_mm`` with
int32 sums, then ``f32(acc) · rs[:, None] · cs[None, :]`` in that order; the
fp16 wire fp16 products summed in float32. The host side (``normalize_rows``,
``quantize_rows_int8``, the recheck) is the JAX package's numpy code, so the
reported pairs and metrics are the JAX package's: for the int8 wire, whose
int32 sums are exact, in the same order (the per-row top-k breaks ties
toward the lower column, as ``lax.top_k``); for the fp16 wire as a set.

``sim_type='euclidean'`` keeps the reference's literal semantics: it
computes distances of the *normalized* embeddings and still selects
``metric > threshold``, i.e. it finds the most DISSIMILAR pairs.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


@dataclasses.dataclass
class DedupResult:
    rows: np.ndarray  # i indices (global)
    cols: np.ndarray  # j indices (global, j > i)
    metrics: np.ndarray  # similarity (cosine) or distance (euclidean)
    # rows whose match count exceeded the configured per-row capacity; their
    # extraction capacity was escalated to fit (informational only)
    overflow_rows: np.ndarray

    def pairs(self) -> list[tuple[int, int, float]]:
        return [
            (int(i), int(j), float(m))
            for i, j, m in zip(self.rows, self.cols, self.metrics)
        ]


def empty_result() -> DedupResult:
    return DedupResult(np.empty(0, np.int64), np.empty(0, np.int64),
                       np.empty(0, np.float32), np.empty(0, np.int64))


# rounding slack between the scan pass and the extract pass; boundary pairs
# are kept, never dropped
THRESHOLD_SLACK = 1e-5

# Wire scan slacks: the device scan runs at a LOWERED threshold
# (wire_scan_threshold) so the candidate set is a superset of the exact
# pass, and every candidate is rechecked in float32 on the host. Both bound
# the COSINE error |s_wire − s|: int8 per-row quantization ~1e-3 at D=768;
# fp16 element rounding 2^-11, near ~1e-3 on a cosine.
INT8_SLACK = 0.02
FP16_SLACK = 2e-3

# Per-buffer f32-element budget for pass 2 (~256 MB): bounds both the
# [h_chunk, b] metric/sort tiles and the [h_chunk, k] running top-k, so
# extraction stays within memory however many rows hit (a narrow embedding
# cone at a tight threshold can make every row a hit).
EXTRACT_BUDGET_ELEMS = 64 * 1024 * 1024


def wire_scan_threshold(threshold: float, euclidean: bool, slack: float) -> float:
    """Device-scan threshold that makes the candidate set a superset of the
    exact pass given a wire whose COSINE error is bounded by ``slack``.

    Cosine: ``threshold − slack``. Euclidean d = sqrt(2 − 2s): the slack is
    converted, d_wire² ≥ d² − 2·slack, so the scan runs at
    sqrt(max(t² − 2·slack, 0)); where t² ≤ 2·slack it counts every pair
    (−1: distances are ≥ 0)."""
    if not euclidean:
        return threshold - slack
    t2 = threshold * threshold - 2.0 * slack
    return float(np.sqrt(t2)) if t2 > 0.0 else -1.0


def normalize_rows(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.where(norms == 0, 1.0, norms)


def quantize_rows_int8(normed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of normalized embeddings: half
    the fp16 wire's host-to-device bytes. Returns (int8 [N, D], f32 per-row
    scale [N])."""
    amax = np.maximum(np.abs(normed).max(axis=1, keepdims=True), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(normed / scale), -127, 127).astype(np.int8)
    return q, scale[:, 0]


def _bucket(n: int, lo: int = 128) -> int:
    """Round up to a power of two (few distinct panel sizes across hit counts)."""
    size = lo
    while size < n:
        size *= 2
    return size


def _required_k(counts: np.ndarray, max_per_row: int) -> int:
    """Per-row extraction capacity that fits the worst pass-1 count:
    ``max_per_row``, or where a row needs more, the next power of two ≥ the
    max count, so every above-threshold pair is extracted in one pass."""
    need = int(counts.max(initial=0))
    if need <= max_per_row:
        return max_per_row
    return _bucket(need, lo=max(128, max_per_row))


def build_hit_panel(hit: np.ndarray, normed: np.ndarray, n_pad: int,
                    dtype=np.float32):
    """Gather hit rows into a padded panel + global-index array (sentinel
    ≥ n_pad disables padding rows in the triangle mask)."""
    h_pad = _bucket(len(hit))
    gidx = np.full(h_pad, n_pad + 1, np.int32)
    gidx[: len(hit)] = hit
    panel = np.zeros((h_pad, normed.shape[1]), dtype)
    panel[: len(hit)] = normed[hit]
    return panel, gidx


def build_hit_panel_q(hit: np.ndarray, q: np.ndarray, s_row: np.ndarray,
                      n_pad: int):
    """int8-wire :func:`build_hit_panel`: the already-quantized rows and
    their scales (quantization is per row, so q[hit] and s_row[hit] are what
    quantizing normed[hit] again would give)."""
    panel, gidx = build_hit_panel(hit, q, n_pad, dtype=np.int8)
    scales = np.zeros(len(panel), np.float32)
    scales[: len(hit)] = s_row[hit]
    return panel, scales, gidx


def _exact_metric_host(normed: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                       euclidean: bool) -> np.ndarray:
    """float32 host metric of candidate pairs, in slices of 2^18 pairs so the
    gathered copies stay ~0.8 GB whatever the candidate count."""
    out = np.empty(len(rows), np.float32)
    step = 1 << 18
    for s in range(0, len(rows), step):
        out[s:s + step] = np.einsum(
            "ij,ij->i", normed[rows[s:s + step]], normed[cols[s:s + step]])
    if euclidean:
        return np.sqrt(np.maximum(2.0 - 2.0 * out, 0.0))
    return out


def filter_and_recheck(v: np.ndarray, j: np.ndarray, hit_global: np.ndarray,
                       normed: np.ndarray, scan_threshold: float,
                       threshold: float, euclidean: bool):
    """Host side of pass 2 for one hit chunk: the slack-banded candidate
    filter, then the exact float32 recheck that makes the reported pair set
    and metrics wire-independent. v/j: [h, k] extracted values / global
    column indices; hit_global: [h] global row indices. Returns (rows, cols,
    metrics)."""
    # the small slack keeps a pair that rounds above the threshold in the
    # scan and below it here
    hit_r, hit_k = np.nonzero(v > scan_threshold - THRESHOLD_SLACK)
    rows = hit_global[hit_r].astype(np.int64)
    cols = j[hit_r, hit_k].astype(np.int64)
    metrics = v[hit_r, hit_k].astype(np.float32)
    if len(rows):
        exact = _exact_metric_host(normed, rows, cols, euclidean)
        keep = exact > threshold - THRESHOLD_SLACK
        rows, cols, metrics = rows[keep], cols[keep], exact[keep]
    return rows, cols, metrics


def extract_chunk_size(tile_elems: int, k: int) -> int:
    """Hit-panel chunk size that keeps every pass-2 device buffer within
    EXTRACT_BUDGET_ELEMS f32 elements."""
    return max(128, min(8192, EXTRACT_BUDGET_ELEMS // max(tile_elems, k, 1)))


def warn_if_degenerate(counts: np.ndarray, n: int, threshold: float,
                       scan_threshold: float) -> None:
    """Loud, non-fatal notice when the device scan marks a large share of
    all pairs as candidates (almost always a threshold too low for the
    embedding distribution): extraction stays memory-bounded and exact, but
    the run degrades to O(N²) work and a large host recheck."""
    total = int(counts.sum())
    if total > max(1_000_000, 32 * n):
        print(
            f"[dedup] WARNING: {total:,} candidate pairs above the device-scan "
            f"threshold {scan_threshold:.4f} (threshold {threshold} minus the "
            f"wire slack) across {n:,} rows — the embedding distribution is "
            f"near-degenerate at this threshold. Extraction is memory-bounded "
            f"and exact but slow; consider a higher --threshold or the fp16 "
            f"wire (10x tighter scan slack).", flush=True,
        )


def tile_metric(rows: torch.Tensor, rows_s: torch.Tensor | None, cols: torch.Tensor,
                cols_s: torch.Tensor | None, euclidean: bool) -> torch.Tensor:
    """[len(rows), len(cols)] float32 metric between a row panel and a
    column panel of one wire: int8 rows (with their float32 scales) or fp16
    rows (scales None)."""
    if rows_s is not None:
        # int32 sums, then (f32(acc) · rs) · cs, each step rounded
        sim = torch._int_mm(rows, cols.t()).float()
        sim.mul_(rows_s[:, None]).mul_(cols_s[None, :])
    elif rows.is_cuda:
        sim = torch.mm(rows, cols.t(), out_dtype=torch.float32)
    else:  # fp16 values are exact in float32: products exact, f32 sums
        sim = torch.mm(rows.float(), cols.float().t())
    if euclidean:
        return sim.mul_(-2.0).add_(2.0).clamp_(min=0.0).sqrt_()
    return sim


class _Wire:
    """The embeddings on the device in one wire format (int8 rows with their
    float32 scales, or fp16 rows), and the tile metric between a row panel
    and a column panel."""

    def __init__(self, x, s_row, device: torch.device, euclidean: bool):
        self.euclidean = euclidean
        self.int8 = s_row is not None
        self.x = torch.as_tensor(x).to(device)
        self.s = torch.as_tensor(s_row).to(device) if self.int8 else None

    def metric(self, rows: torch.Tensor, rows_s: torch.Tensor | None,
               c0: int, c1: int) -> torch.Tensor:
        """[len(rows), c1 − c0] float32 metric of ``rows`` against columns
        c0:c1."""
        return tile_metric(rows, rows_s, self.x[c0:c1],
                           self.s[c0:c1] if self.int8 else None, self.euclidean)


def _scan_counts(wire: _Wire, b: int, n_panels: int, n: int,
                 scan_threshold: float) -> np.ndarray:
    """Pass 1: for each row, the count of later columns whose metric is
    above ``scan_threshold``."""
    dev = wire.x.device
    lane = torch.arange(b, device=dev)
    upper = lane[None, :] > lane[:, None]  # the diagonal tile's triangle
    counts = []
    for bi in range(n_panels):
        r0 = bi * b
        rows = wire.x[r0:r0 + b]
        rows_s = wire.s[r0:r0 + b] if wire.int8 else None
        acc = torch.zeros(b, dtype=torch.int64, device=dev)
        for bj in range(bi, n_panels):
            above = wire.metric(rows, rows_s, bj * b, bj * b + b) > scan_threshold
            if bj == bi:
                above &= upper
            n_cols = min(b, n - bj * b)  # columns past N are padding
            acc += above[:, :n_cols].sum(dim=1)
        acc[max(0, n - r0):] = 0  # rows past N are padding
        counts.append(acc)
    return torch.cat(counts).cpu().numpy()


def _topk_lower_first(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Per row, the k largest values, ties to the lower index (as
    ``lax.top_k``): a stable sort of ``vals``, whose columns are in index
    order."""
    sv, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return sv[:, :k], torch.gather(idx, 1, order[:, :k])


def _extract_chunk(wire: _Wire, hit_rows: torch.Tensor, hit_s: torch.Tensor | None,
                   gidx: torch.Tensor, b: int, n_panels: int, n: int, k: int,
                   offset: int = 0):
    """Pass 2 for one hit panel: the exact top-k (ties to the lower column)
    of every hit row over all later columns → (values, global columns)
    [h, k]. ``offset``: the global index of the wire's first row (a mesh
    shard's panel)."""
    dev = wire.x.device
    h = hit_rows.shape[0]
    k_tile = min(k, b)
    run_v = torch.full((h, k), float("-inf"), device=dev)
    run_i = torch.zeros((h, k), dtype=torch.int64, device=dev)
    lane = torch.arange(b, device=dev)
    for bj in range(n_panels):
        gj = offset + bj * b + lane
        valid = (gj[None, :] > gidx[:, None]) & (gj[None, :] < n)
        masked = wire.metric(hit_rows, hit_s, bj * b, bj * b + b).masked_fill_(
            ~valid, float("-inf"))
        v, i = _topk_lower_first(masked, gj.expand(h, b), k_tile)
        # the running columns are lower than this panel's: listed first, they
        # win ties, as the merge's stable sort keeps them first
        run_v, run_i = _topk_lower_first(torch.cat([run_v, v], 1), torch.cat([run_i, i], 1), k)
    return run_v, run_i


class _HostPass:
    """The host side of a dedup pass, shared by :func:`find_duplicate_pairs`
    and the ring (``parallel/dedup_sharded``): the wire check and the scan
    threshold, the rows to upload (:meth:`prepare`), the hit panels
    (:meth:`hit_panel`), and pass 2's chunks with their host recheck and the
    result (:meth:`extract`)."""

    def __init__(self, n: int, threshold: float, sim_type: str, wire: str, max_per_row: int,
                 timer: StageTimer | None):
        if wire not in ("int8", "fp16"):
            raise ValueError(f"wire must be 'int8' or 'fp16', got {wire!r}")
        self.n, self.threshold, self.max_per_row = n, threshold, max_per_row
        self.euclidean = sim_type == "euclidean"
        self.int8 = wire == "int8"
        self.timer = timer or StageTimer()
        # the scan over-captures by the wire's error bound so the exact recheck
        # can only REMOVE false positives, never miss a pair
        self.scan_threshold = wire_scan_threshold(
            threshold, self.euclidean, INT8_SLACK if self.int8 else FP16_SLACK)

    def prepare(self, embeddings: np.ndarray, n_pad: int):
        """The wire's host rows [n_pad, D'] (int8 or float16; the width padded
        with zero columns to a multiple of 8, torch._int_mm's shapes: zeros
        change no dot product and no row's scale) and the int8 rows' scales
        (None for fp16), timed as ``normalize`` (with the row pad) and
        ``quantize_rows`` (with the width pad). The normalized rows stay for
        the recheck."""
        with self.timer.time("normalize", self.n):
            normed = normalize_rows(embeddings)
            if n_pad != self.n:
                normed = np.pad(normed, ((0, n_pad - self.n), (0, 0)))
        self.normed, self.n_pad = normed, n_pad
        self.pad_d = -normed.shape[1] % 8
        with self.timer.time("quantize_rows", self.n):
            if self.int8:
                self.q, self.s_row = quantize_rows_int8(normed)
                return self.widen(self.q), self.s_row
            return self.widen(normed.astype(np.float16)), None

    def widen(self, a: np.ndarray) -> np.ndarray:
        return np.pad(a, ((0, 0), (0, self.pad_d))) if self.pad_d else a

    def hit_panel(self, hit: np.ndarray):
        """The hit rows' padded panel in the wire's format (width padded),
        their int8 scales (None for fp16) and their global indices."""
        if self.int8:
            panel, hit_s, gidx = build_hit_panel_q(hit, self.q, self.s_row, self.n_pad)
        else:
            panel, gidx = build_hit_panel(hit, self.normed, self.n_pad, dtype=np.float16)
            hit_s = None
        return self.widen(panel), hit_s, gidx

    def extract(self, counts: np.ndarray, b: int, topk, chunk_size=None) -> DedupResult:
        """Pass 2 from pass 1's per-row ``counts`` [n_pad]: the hit rows in
        chunks of ``chunk_size(b, k)`` (:func:`extract_chunk_size` by
        default), ``topk(hit chunk, k)`` → the host's (values, global columns)
        [len(chunk), k] of each (timed as ``topk``), then the host filter and
        float32 recheck (``recheck``); all within ``extract``."""
        hit = np.nonzero(counts > 0)[0]
        if hit.size == 0:
            return empty_result()
        # pass 1's counts bound each row's match count from above, so the
        # capacity escalates itself to fit the worst row; hit rows go in
        # chunks that keep every buffer within EXTRACT_BUDGET_ELEMS; each
        # row's top-k is independent of the chunking
        warn_if_degenerate(counts, self.n, self.threshold, self.scan_threshold)
        k = min(_required_k(counts, self.max_per_row), self.n_pad)
        chunk = (chunk_size or extract_chunk_size)(b, k)
        rows_l, cols_l, metrics_l = [], [], []
        with self.timer.time("extract", len(hit)):
            for c0 in range(0, len(hit), chunk):
                hc = hit[c0:c0 + chunk]
                with self.timer.time("topk", len(hc)):
                    v, j = topk(hc, k)
                with self.timer.time("recheck", len(hc)):
                    r, c, m = filter_and_recheck(v, j, hc, self.normed, self.scan_threshold,
                                                 self.threshold, self.euclidean)
                rows_l.append(r)
                cols_l.append(c)
                metrics_l.append(m)
        return DedupResult(
            rows=np.concatenate(rows_l),
            cols=np.concatenate(cols_l),
            metrics=np.concatenate(metrics_l),
            overflow_rows=np.nonzero(counts > self.max_per_row)[0].astype(np.int64),
        )


def find_duplicate_pairs(
    embeddings: np.ndarray,
    threshold: float = 0.96,
    sim_type: str = "cosine",
    row_block: int = 8192,
    max_per_row: int = 16,
    wire: str = "int8",
    device: str | torch.device = "cuda",
    timer: StageTimer | None = None,
) -> DedupResult:
    """Single-device blocked all-pairs near-duplicate search in two passes
    (scan, then extract for the hit rows; the module docstring).

    ``wire`` selects the on-device embedding format: ``"int8"`` (default,
    per-row-quantized, half the fp16 wire's host-to-device bytes) or
    ``"fp16"`` (the reference's format). Both scan at a lowered threshold and
    every candidate is rechecked in float32 on the host, so the reported pair
    set and metrics are exact and the same for both wires.

    ``timer``, where given, takes the seconds of ``prepare`` (within it
    ``normalize``: the host normalization and the row pad; ``quantize_rows``:
    the int8 quantization or the float16 cast, and the width pad;
    ``upload``), ``scan`` and ``extract`` (within it ``topk``: the hit
    panels, their uploads, the device top-k and its read back; ``recheck``:
    the host float32 recheck). Peak device memory is O(row_block² + N·D).
    """
    n = len(embeddings)
    host = _HostPass(n, threshold, sim_type, wire, max_per_row, timer)
    dev = resolve_device(device)
    if n < 2:
        return empty_result()
    timer = host.timer

    with timer.time("prepare", n):
        # panels of a multiple of 8 rows (torch._int_mm's shapes)
        b = -(-min(row_block, max(128, n)) // 8) * 8
        n_panels = -(-n // b)
        rows, scales = host.prepare(embeddings, n_panels * b)
        with timer.time("upload", n):
            wired = _Wire(rows, scales, dev, host.euclidean)
        del rows  # the host copy of the wire is not needed past the upload

    def topk(hc: np.ndarray, k: int):
        panel, hit_s, gidx = host.hit_panel(hc)
        v, j = _extract_chunk(wired, torch.from_numpy(panel).to(dev),
                              None if hit_s is None else torch.from_numpy(hit_s).to(dev),
                              torch.from_numpy(gidx).to(dev), b, n_panels, n, k)
        return v[: len(hc)].cpu().numpy(), j[: len(hc)].cpu().numpy()

    with torch.inference_mode():
        with timer.time("scan", n):
            counts = _scan_counts(wired, b, n_panels, n, host.scan_threshold)
        return host.extract(counts, b, topk)


def cosine_similarity_matrix(a: np.ndarray, b: np.ndarray,
                             device: str | torch.device = "cuda") -> torch.Tensor:
    """Small-scale dense cosine matrix (labeling-UI / tools use), float32
    on ``device``."""
    dev = resolve_device(device)
    an = torch.from_numpy(normalize_rows(a)).to(dev)
    bn = torch.from_numpy(normalize_rows(b)).to(dev)
    return an @ bn.t()
