"""What the embed mixes that run the stage's own loop share: a ``Stage1``
whose pass is ``pipeline/embed.embed_batches`` (the port's depth-2 loop:
``loader_wait``, ``dispatch``, ``cpu_wait``, ``store_write``,
``sidecar_wait``, each a harness span here), and the set-up, window and
check of ``drivers/embed`` around such a stage.

A subclass names the embedder the loop drives (the encoder, or a
``ShardedEmbedder``), the crop columns it writes and, for ``--aspect
native``, the loader's preparation and the native forward."""
from __future__ import annotations

import contextlib
import os
import random
import shutil
import sys
import tempfile
import time

import torch

from portbench import synth
from portbench.drivers import embed


class _SpanTimer:
    """The loop's ``StageTimer`` stages as the harness's spans."""

    def __init__(self, spans):
        self.spans = spans

    def time(self, name: str, items: int = 0):
        return self.spans.span(name)


class LoopStage(embed.Stage1):
    """``Stage1`` with its pass on ``embed_batches``. ``embedder``: what the
    loop drives; ``native``, ``prep``: the native forward and the loader's
    preparation, or None; ``calibrate``: a ``ShardedEmbedder``'s
    int8_static calibration on its first batch."""

    embedder = None
    native = None
    prep = None
    calibrate = False

    def start_window(self) -> None:
        """Set-up has ended: forget what the warm-up recorded."""

    def window_extra(self) -> dict:
        """What the stage adds to ``run.window``."""
        return {}

    def _write(self, paths, emb, stats) -> None:
        """A batch's sidecars (a writer thread), then the batch counts as done."""
        self._write_sidecars(paths, emb, stats)
        self.done.append((len(paths), list(paths)))

    def one_pass(self, paths: list[str]) -> None:
        from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
        from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
        from clip_assisted_data_labeling_tpu_torch.pipeline.embed import embed_batches

        mix = self.mix
        loader = BatchedImageLoader(
            paths, canvas_size=mix["canvas_size"], out_size=self.encoder.img_resolution,
            batch_size=mix["batch_size"], num_workers=mix["decode_workers"],
            crop_names=list(ALL_CROPS), bucketed=True, sort_by_size=True,
            **({} if self.prep is None else {"native": self.prep}))
        # the loop's progress lines go to stderr: stdout carries the result line
        with contextlib.redirect_stdout(sys.stderr):
            embed_batches(self.embedder or self.encoder, loader, self.store, self.writer,
                          _SpanTimer(self.run.spans), device=self.run.device, row_of=self.row_of,
                          write_sidecars=self._write, stats="device", native=self.native,
                          calibrate=self.calibrate)
        self.skipped += loader.skipped


def drive(run, make_stage, check) -> None:
    """``drivers/embed.drive`` with the stage ``make_stage(run, paths, root)``
    and the check ``check(run, cfg, mix, paths, written, store, n_skipped)``."""
    from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build

    cfg, mix = run.config, run.traffic
    embed.check_config(cfg)
    if run.device.type == "cuda":
        _cuda_build.build_all()
    root = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        _drive(run, cfg, mix, root, make_stage, check)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _drive(run, cfg: dict, mix: dict, root: str, make_stage, check) -> None:
    per = mix["per_size"]
    paths = embed.write_pool(run.seed, mix, root, run.device)
    stage = make_stage(run, paths, root)
    try:
        # one batch of each canvas bucket the pool fills; the first calibrates
        sizes, first_of = embed.buckets(mix["canvas_size"]), {}
        for gi, (w, h) in enumerate(mix["sizes"]):
            edge = min(max(w, h), mix["canvas_size"])  # larger images are pre-downscaled
            first_of.setdefault(next(b for b in sizes if b >= edge), gi)
        warm = [p for gi in first_of.values()
                for p in paths[gi * per: gi * per + min(per, mix["batch_size"])]]
        stage.one_pass(warm)
        embed._clear_outputs(stage, warm)
        stage.done.clear()
        stage.start_window()
        order = list(paths)
        random.Random(synth.derive(run.seed, "order")).shuffle(order)
        counters0 = embed.launch_counters()
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
        counters = embed.launch_counters()
        run.counters = {k: counters[k] - counters0.get(k, 0) for k in counters}
        run.read_peak()
        images = sum(n for n, _p in stage.done)
        run.window = {
            "images": images, "seconds": t_end - t0, "batches": len(stage.done),
            "passes": passes, "crops_per_forward": mix["batch_size"] * len(embed.ref_crops.CROPS),
            **stage.window_extra(),
        }
        written = {embed._uuid(p) for _n, ps in stage.done for p in ps}
        n_skipped = len(stage.skipped)
    finally:
        stage.close()
    store = stage.store
    store.flush()
    del stage
    run.free_device()
    run.attempted = images
    check(run, cfg, mix, paths, written, store, n_skipped)
