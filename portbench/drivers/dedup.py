"""The generator of the dedup mixes: stage 2's all-pairs search, whole passes
of ``ops.similarity.find_duplicate_pairs`` back to back, each from the host
float32 array (what ``pipeline/dedup.run_dedup`` hands it after loading a
store).

Set-up makes the rows on the device from the seed (``synth.dedup_rows``),
copies them to the host, and runs one pass over the first ``warm_rows`` rows
(every shape of the scan's tiles and the extraction's panels). The window then
runs whole passes until ``--seconds`` have passed, the last one to its end.
The port's ``StageTimer`` is handed a subclass that also marks its
``prepare``, ``scan`` and ``extract`` in the trace.

The mix's parameters (``traffic/<mix>.json``): ``rows``, ``threshold``,
``wire``, ``max_pairs_per_row``, ``row_block``, ``warm_rows`` and the
background's and the planted duplicates' shape (``synth.dedup_rows``). The
rows' width is the configuration's ``embed_dim``.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import synth
from portbench.reference import dedup as ref_dedup


def timer_class():
    """The port's ``StageTimer``, each stage also a span of the run."""
    from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

    class SpanTimer(StageTimer):
        def __init__(self, spans):
            super().__init__()
            self.spans = spans

        @contextlib.contextmanager
        def time(self, name: str, items: int = 0):
            with self.spans.span(name), super().time(name, items):
                yield

    return SpanTimer


def one_pass(run, rows: np.ndarray, timer=None):
    from clip_assisted_data_labeling_tpu_torch.ops.similarity import find_duplicate_pairs

    mix = run.traffic
    return find_duplicate_pairs(
        rows, threshold=mix["threshold"], sim_type="cosine", row_block=mix["row_block"],
        max_per_row=mix["max_pairs_per_row"], wire=mix["wire"], device=run.device, timer=timer)


def make_rows(run) -> torch.Tensor:
    mix = run.traffic
    return synth.dedup_rows(run.seed, mix["rows"], run.config["embed_dim"], mix, run.device)


def drive(run) -> None:
    mix = run.traffic
    rows = make_rows(run).cpu().numpy()
    one_pass(run, rows[: mix["warm_rows"]])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    timer = timer_class()(run.spans)
    results, pass_s = [], []

    run.start_window()
    with run.traced_window():
        t0 = time.perf_counter()
        while not pass_s or time.perf_counter() < t0 + run.seconds:
            t = time.perf_counter()
            results.append(one_pass(run, rows, timer))
            pass_s.append(time.perf_counter() - t)
    run.read_peak()
    run.window = {"passes": len(pass_s), "seconds": sum(pass_s), "rows": mix["rows"],
                  "stage_s": dict(timer.totals)}
    del rows
    run.free_device()
    run.attempted = len(results)
    _check(run, results)


def pair_numbers(prog, ref) -> dict:
    """missing (reference pairs the pass lacks), extra (pairs it reports that
    the reference does not) and the widest gap between the two cosines of a
    pair both report. ``prog``, ``ref``: (i, j, cosine) arrays."""
    n = 1 << 32
    pk = prog[0].astype(np.int64) * n + prog[1].astype(np.int64)
    rk = ref[0].astype(np.int64) * n + ref[1].astype(np.int64)
    both, pi, ri = np.intersect1d(pk, rk, return_indices=True)
    gap = np.abs(prog[2][pi].astype(np.float64) - ref[2][ri].astype(np.float64))
    return {"missing": len(rk) - len(both), "extra": len(pk) - len(both),
            "metric_gap": float(gap.max(initial=0.0))}


def reference_pairs(run, control: bool = False):
    mix = run.traffic
    x = make_rows(run)
    out = ref_dedup.pairs_above(x, mix["threshold"], mix["row_block"], control)
    del x
    return out


def _check(run, results) -> None:
    """Every pass's pair set and cosines against the plain float32 scan."""
    ref = reference_pairs(run)
    worst = {"missing": 0, "extra": 0, "metric_gap": 0.0}
    for res in results:
        got = pair_numbers((res.rows, res.cols, res.metrics), ref)
        bad = any(got[k] > run.limits[k] for k in worst)
        run.failed += int(bad)
        worst = {k: max(worst[k], got[k]) for k in worst}
    for k, v in worst.items():
        run.add_check(k, v)
    run.add_check("reference_pairs", len(ref[0]), run.limits["reference_pairs"], at_least=True)


def control(run) -> dict:
    """The control's numbers: the float32 scan with TF32 on in the program's place."""
    ref = reference_pairs(run)
    return pair_numbers(reference_pairs(run, control=True), ref)
