"""The generator of the embed mixes: stage 1's per-batch path over a pool of
synthetic PNGs, driven through the port's public functions as
``pipeline/embed._embed_one_model`` drives them: ``BatchedImageLoader``
(size-sorted canvas buckets, threaded decode) → ``CLIPImageEncoder.embed_crops``
→ ``ops.image_stats.image_stats_batch``, with the same depth-2 dispatch, then
the columnar store's rows and the per-image sidecars, written as on a first
embed of new images.

Set-up writes the pool from the seed into a fresh directory under ``TMPDIR``,
makes the tower's weights on the device, builds the encoder (the port
quantizes them) and the store, and runs one batch of each canvas bucket the
pool fills (the first calibrates int8_static and writes its ``.calib.npz``).
The window then runs whole passes over the pool, a new loader each pass, so
every image is decoded again, until ``--seconds`` have passed; the last pass
runs to its end, so every pass's start, drain and sidecar waits are counted
alike.

The mix's parameters (``traffic/<mix>.json``): ``sizes`` ([width, height],
each ``per_size`` images), ``shapes`` (painted over each image's gradient),
``batch_size``, ``canvas_size``, ``decode_workers``, and the check's
``check_per_size`` (images of each size held against the reference) and
``check_batch`` (crops a reference forward takes at once).
"""
from __future__ import annotations

import collections
import os
import random
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import synth, weights
from portbench.pngwrite import write_png
from portbench.reference import crops as ref_crops
from portbench.reference import stats as ref_stats
from portbench.reference import tf32

# the tower's sizes the configuration file states, against the port's own
CONFIG_FIELDS = ("width", "layers", "heads", "patch_size", "image_size", "embed_dim", "mlp_dim",
                 "seq_len", "act", "pool", "ln_eps")


def check_config(cfg: dict) -> None:
    """Refuse a configuration file that the port resolves to other sizes."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    port = resolve_config(cfg["model_name"])
    wrong = {k: (cfg[k], getattr(port, k)) for k in CONFIG_FIELDS if cfg[k] != getattr(port, k)}
    if wrong:
        raise ValueError(f"{cfg['name']}: the port resolves {cfg['model_name']} otherwise: {wrong}")


def launch_counters() -> dict[str, int]:
    """Every kernel wrapper's ``launches`` counter in the port's ops modules."""
    from clip_assisted_data_labeling_tpu_torch.ops import attention, quant_kernel

    out = {}
    for module in (attention, quant_kernel):
        for name, fn in vars(module).items():
            for attr in ("launches", "rope_launches"):
                value = getattr(fn, attr, None)
                if callable(fn) and isinstance(value, int):
                    out[f"{module.__name__.rsplit('.', 1)[-1]}.{name}.{attr}"] = value
    return out


def write_pool(seed: int, mix: dict, root: str, device) -> list[str]:
    """The pool's PNGs, group by group (one group a size), written by a
    thread pool while the next group is made."""
    paths = []
    with ThreadPoolExecutor(mix["decode_workers"]) as pool:
        jobs = []
        for gi, (w, h) in enumerate(mix["sizes"]):
            imgs = synth.image_group(seed, gi, mix["per_size"], w, h, mix["shapes"],
                                     device).cpu().numpy()
            for j in range(mix["per_size"]):
                path = os.path.join(root, f"img_{gi * mix['per_size'] + j:05d}.png")
                paths.append(path)
                jobs.append(pool.submit(write_png, path, imgs[j]))
        for job in jobs:
            job.result()
    return paths


def _uuid(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _sidecar(path: str) -> str:
    return os.path.splitext(path)[0] + ".pt"


class Stage1:
    """The port's stage-1 objects for one run, and one pass over a file list."""

    def __init__(self, run, paths: list[str], root: str):
        from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
        from clip_assisted_data_labeling_tpu_torch.models.encoders import (
            CLIPImageEncoder,
            calibration_file,
        )
        from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

        cfg, mix = run.config, run.traffic
        self.run, self.mix, self.crop_names = run, mix, list(ALL_CROPS)
        self.model_name = cfg["model_name"]
        params = weights.vit_params(cfg, run.seed, run.device)
        self.encoder = CLIPImageEncoder(
            self.model_name, params=params, compute_dtype=cfg["compute_dtype"],
            calibration_path=calibration_file(self.model_name, root), device=run.device)
        del params
        uuids = [_uuid(p) for p in paths]
        self.row_of = {u: i for i, u in enumerate(uuids)}
        self.store = EmbeddingStore.create(
            root, self.model_name, self.crop_names, self.encoder.embed_dim, uuids,
            with_stats=True, rel_paths=[os.path.basename(p) for p in paths])
        self.writer = ThreadPoolExecutor(max(2, mix["decode_workers"] // 2))
        self.skipped: list[str] = []
        self.done: list[tuple[int, list[str]]] = []  # (images, paths) of each batch written

    def close(self) -> None:
        self.writer.shutdown(wait=True)

    def _dispatch(self, batch):
        from clip_assisted_data_labeling_tpu_torch.ops.image_stats import image_stats_batch

        canvas = torch.from_numpy(batch.canvas).to(self.run.device, non_blocking=True)
        emb = self.encoder.embed_crops(canvas, batch.crop_params)
        with torch.inference_mode():
            stats = image_stats_batch(canvas, torch.from_numpy(batch.stat_params))
        return emb, stats

    def _write_sidecars(self, paths, emb, stats) -> None:
        from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
        from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar

        for bi, path in enumerate(paths):
            write_sidecar(_sidecar(path), self.model_name,
                          {c: emb[bi, ci] for ci, c in enumerate(self.crop_names)},
                          dict(zip(IMG_STAT_KEYS, map(float, stats[bi]))), merge=False)

    def _consume(self, batch, emb_dev, stats_dev, futures: list) -> None:
        spans = self.run.spans
        n = batch.n_valid
        with spans.span("cpu_wait"):
            emb = emb_dev[:n].cpu().numpy()
            stats = stats_dev[:n].cpu().numpy()
        with spans.span("store_write"):
            for bi, path in enumerate(batch.paths):
                self.store.write_rows(self.row_of[_uuid(path)], emb[bi:bi + 1],
                                      stats[bi:bi + 1])
        futures.append(self.writer.submit(self._write_sidecars, batch.paths, emb, stats))
        self.done.append((n, list(batch.paths)))

    def one_pass(self, paths: list[str]) -> None:
        """One embed of ``paths`` as the stage runs it, to its last sidecar."""
        from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader

        spans, mix = self.run.spans, self.mix
        loader = BatchedImageLoader(
            paths, canvas_size=mix["canvas_size"], out_size=self.encoder.img_resolution,
            batch_size=mix["batch_size"], num_workers=mix["decode_workers"],
            crop_names=self.crop_names, bucketed=True, sort_by_size=True)
        batches = iter(loader)
        pending: collections.deque = collections.deque()
        futures: list = []
        try:
            while True:
                with spans.span("loader_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                with spans.span("dispatch"):
                    pending.append((batch, *self._dispatch(batch)))
                if len(pending) > 1:
                    self._consume(*pending.popleft(), futures)
            while pending:
                self._consume(*pending.popleft(), futures)
        finally:
            batches.close()
            with spans.span("sidecar_wait"):
                for f in futures:
                    f.result()
        self.skipped += loader.skipped


def buckets(canvas: int) -> list[int]:
    """The canvas buckets of the port's loader (``BatchedImageLoader.bucket_sizes``)."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader

    return BatchedImageLoader([], canvas_size=canvas, out_size=1, batch_size=1,
                              bucketed=True).bucket_sizes


def drive(run) -> None:
    from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build

    cfg, mix = run.config, run.traffic
    check_config(cfg)
    if run.device.type == "cuda":
        _cuda_build.build_all()
    root = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        _drive(run, cfg, mix, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _drive(run, cfg: dict, mix: dict, root: str) -> None:
    per = mix["per_size"]
    paths = write_pool(run.seed, mix, root, run.device)
    stage = Stage1(run, paths, root)
    try:
        # one batch of each canvas bucket the pool fills; the first calibrates
        sizes, first_of = buckets(mix["canvas_size"]), {}
        for gi, (w, h) in enumerate(mix["sizes"]):
            edge = min(max(w, h), mix["canvas_size"])  # larger images are pre-downscaled
            first_of.setdefault(next(b for b in sizes if b >= edge), gi)
        warm = [p for gi in first_of.values()
                for p in paths[gi * per: gi * per + min(per, mix["batch_size"])]]
        stage.one_pass(warm)
        _clear_outputs(stage, warm)
        stage.done.clear()
        order = list(paths)
        random.Random(synth.derive(run.seed, "order")).shuffle(order)
        counters0 = launch_counters()
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

        run.start_window()
        with run.traced_window():
            t0 = time.perf_counter()
            passes = 0
            while not passes or time.perf_counter() < t0 + run.seconds:
                stage.one_pass(order)
                passes += 1
            t_end = time.perf_counter()
        counters = launch_counters()
        run.counters = {k: counters[k] - counters0.get(k, 0) for k in counters}
        run.read_peak()
        images = sum(n for n, _p in stage.done)
        run.window = {
            "images": images, "seconds": t_end - t0, "batches": len(stage.done),
            "passes": passes, "crops_per_forward": mix["batch_size"] * len(stage.crop_names),
        }
        written = {_uuid(p) for _n, ps in stage.done for p in ps}
        n_skipped = len(stage.skipped)
    finally:
        stage.close()
    store = stage.store
    store.flush()
    del stage
    run.free_device()
    run.attempted = images
    _check(run, cfg, mix, paths, written, store, n_skipped)


def _clear_outputs(stage: Stage1, paths: list[str]) -> None:
    """Undo the warm-up's writes, so whatever the check reads the window wrote."""
    stage.store.embeddings[:] = 0
    stage.store.img_stats[:] = 0
    stage.store.valid[:] = False
    for p in paths:
        if os.path.exists(_sidecar(p)):
            os.remove(_sidecar(p))


def sample(seed: int, mix: dict, written: set[str]) -> list[int]:
    """Pool indices held against the reference: ``check_per_size`` of each
    size, drawn from the seed among the images the window wrote."""
    rng = random.Random(synth.derive(seed, "check"))
    per, out = mix["per_size"], []
    for gi in range(len(mix["sizes"])):
        have = [gi * per + j for j in range(per) if f"img_{gi * per + j:05d}" in written]
        out += sorted(rng.sample(have, min(mix["check_per_size"], len(have))))
    return out


def reference_outputs(run, cfg: dict, mix: dict, picks: list[int], control: bool):
    """The plain reference's (or the control's) embeddings [n, 4, D] and
    stats [n, 22] of the picked pool images, made again from the seed."""
    ref = run.reference_module
    per = mix["per_size"]
    params = weights.vit_params(cfg, run.seed, run.device)
    embs, stats = [], []
    by_group = collections.defaultdict(list)
    for i in picks:
        by_group[i // per].append(i % per)
    with tf32(False), torch.inference_mode():
        for gi, js in sorted(by_group.items()):
            w, h = mix["sizes"][gi]
            group = synth.image_group(run.seed, gi, per, w, h, mix["shapes"], run.device)
            imgs = [ref_crops.shrink_to_canvas(group[j], mix["canvas_size"]) for j in js]
            del group
            crops = torch.cat([ref_crops.image_crops(img, cfg["image_size"], cfg["norm_mean"],
                                                     cfg["norm_std"], control) for img in imgs])
            for c0 in range(0, len(crops), mix["check_batch"]):
                embs.append(ref.encode(params, cfg, crops[c0:c0 + mix["check_batch"]], control))
            stats += [ref_stats.image_stats(img, control) for img in imgs]
            del imgs, crops
    n_crops = len(ref_crops.CROPS)
    return (torch.cat(embs).reshape(len(picks), n_crops, -1).double().cpu().numpy(),
            torch.stack(stats).cpu().numpy())


def gaps(prog_emb: np.ndarray, prog_stats: np.ndarray, ref_emb: np.ndarray,
         ref_stats_: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per image: the worst 1 − cosine of its crops, and the widest absolute
    gap of its stats. A row that was never written (zeros, NaN) reads 1 and inf."""
    p = prog_emb.astype(np.float64)
    norms = np.linalg.norm(p, axis=-1) * np.linalg.norm(ref_emb, axis=-1)
    cos = np.where(norms > 0, (p * ref_emb).sum(-1) / np.where(norms > 0, norms, 1.0), 0.0)
    emb_gap = np.nan_to_num(1.0 - cos, nan=1.0).max(axis=-1)
    stat_gap = np.nan_to_num(np.abs(prog_stats.astype(np.float64) - ref_stats_),
                             nan=np.inf).max(axis=-1)
    return emb_gap, stat_gap


def misplaced(prog_emb: np.ndarray, ref_emb: np.ndarray, apart: float) -> np.ndarray:
    """Per image: its crops' rows ([n, crops, D]) that lie nearer, by cosine,
    to another reference row of the sample (another crop of it, or any crop of
    another image) than to their own. Only reference rows that lie more than
    ``apart`` (1 − cosine) from a row's own are counted against it: crops that
    all but coincide cannot be told apart, and a swap of them is no error."""
    n, c, d = ref_emb.shape
    ref = ref_emb.reshape(n * c, d).astype(np.float64)
    ref /= np.linalg.norm(ref, axis=-1, keepdims=True)
    prog = prog_emb.reshape(n * c, d).astype(np.float64)
    prog /= np.maximum(np.linalg.norm(prog, axis=-1, keepdims=True), 1e-30)
    to_ref = prog @ ref.T
    own = np.diagonal(to_ref)
    others = np.where(1.0 - ref @ ref.T > apart, to_ref, -np.inf)
    return (others.max(axis=-1) > own).reshape(n, c).sum(axis=-1)


def _check(run, cfg: dict, mix: dict, paths: list[str], written: set[str], store,
           n_skipped: int) -> None:
    """Hold what the window wrote (the store's float16 rows and the sidecars'
    float32 crops and stats) of a seeded sample against the plain reference:
    each row near its own reference (``embed_gap``, ``stats_gap``), and no
    row nearer to another image's or crop's (``misplaced``)."""
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    picks = sample(run.seed, mix, written)
    ref_emb, ref_stat = reference_outputs(run, cfg, mix, picks, control=False)
    names = list(ref_crops.CROPS)
    d = ref_emb.shape[-1]
    rows = picks  # the store's rows are in pool order
    valid = np.asarray(store.valid)[rows]
    st_emb = np.where(valid[:, None, None], np.asarray(store.embeddings[rows], np.float32), 0.0)
    st_stat = np.where(valid[:, None], np.asarray(store.img_stats[rows], np.float32), np.nan)
    sc_emb = np.zeros((len(picks), len(names), d), np.float32)
    sc_stat = np.full((len(picks), len(IMG_STAT_KEYS)), np.nan, np.float32)
    for k, i in enumerate(picks):
        path = _sidecar(paths[i])
        if not os.path.exists(path):
            continue
        entry = read_sidecar(path).get(cfg["model_name"], {})
        for ci, c in enumerate(names):
            if c in entry:
                sc_emb[k, ci] = np.asarray(entry[c], np.float32).reshape(-1)
        sc_stat[k] = [float(entry.get(key, np.nan)) for key in IMG_STAT_KEYS]
    e1, s1 = gaps(st_emb, st_stat, ref_emb, ref_stat)
    e2, s2 = gaps(sc_emb, sc_stat, ref_emb, ref_stat)
    emb_gap, stat_gap = np.maximum(e1, e2), np.maximum(s1, s2)
    limits = run.limits
    moved = (misplaced(st_emb, ref_emb, limits["misplaced_apart"])
             + misplaced(sc_emb, ref_emb, limits["misplaced_apart"]))
    bad = ((emb_gap > limits["embed_gap"]) | (stat_gap > limits["stats_gap"])
           | (moved > limits["misplaced"]))
    run.failed = int(bad.sum()) + n_skipped
    run.add_check("embed_gap", float(emb_gap.max(initial=0.0)))
    run.add_check("stats_gap", float(stat_gap.max(initial=0.0)))
    run.add_check("misplaced", int(moved.sum()))
    run.add_check("images_checked", len(picks), limits["images_checked"], at_least=True)


def fault_readings(ref_emb: np.ndarray, ref_stats_: np.ndarray) -> dict:
    """What a misplaced answer would read, from the reference's own outputs
    on the sample: ``crop_swap``, the least 1 − cosine between two crops of
    one image (a crop's row holding its sibling's), over the pairs that differ
    (a square image's crops can coincide, and a swap of those is no error);
    ``image_swap``, the least
    1 − cosine between one crop of two images (a row or a sidecar holding
    another image's); ``batch_mean``, the least 1 − cosine between an image's
    crop and the sample's mean of that crop (half a batch filled with the
    other half's mean); ``stats_swap``, the least over two images of their
    stats' widest absolute gap. A fault reads past a limit only where its
    reading lies above it."""
    e = ref_emb / np.linalg.norm(ref_emb, axis=-1, keepdims=True)
    n, c, _d = e.shape
    crop_cos = np.einsum("nad,nbd->nab", e, e)[:, *np.triu_indices(c, 1)]
    crop_cos = crop_cos[np.abs(ref_emb[:, :, None] - ref_emb[:, None, :]).max(-1)[
        :, *np.triu_indices(c, 1)] > 0]
    img_cos = np.einsum("acd,bcd->cab", e, e)[:, *np.triu_indices(n, 1)]
    mean = e.mean(axis=0)
    mean /= np.linalg.norm(mean, axis=-1, keepdims=True)
    mean_cos = np.einsum("ncd,cd->nc", e, mean)
    stats_gap = np.abs(ref_stats_[:, None, :] - ref_stats_[None, :, :]).max(-1)
    return {"crop_swap": float(1.0 - crop_cos.max(initial=-1.0)), "image_swap": float(1.0 - img_cos.max()),
            "batch_mean": float(1.0 - mean_cos.max()),
            "stats_swap": float(stats_gap[np.triu_indices(n, 1)].min())}


def control(run) -> dict:
    """The control's numbers: the reference one precision step lower
    (``control=True``) in the program's place, on the sample a run checks;
    the faults' readings go to ``run.faults``."""
    cfg, mix = run.config, run.traffic
    every = {f"img_{i:05d}" for i in range(len(mix["sizes"]) * mix["per_size"])}
    picks = sample(run.seed, mix, every)
    ref_emb, ref_stat = reference_outputs(run, cfg, mix, picks, control=False)
    run.faults = fault_readings(ref_emb, ref_stat)
    ctl_emb, ctl_stat = reference_outputs(run, cfg, mix, picks, control=True)
    emb_gap, stat_gap = gaps(ctl_emb, ctl_stat, ref_emb, ref_stat)
    return {"embed_gap": float(emb_gap.max()), "stats_gap": float(stat_gap.max())}
