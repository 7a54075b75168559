"""What decides ``correct`` has to be able to come out false: the control
(the reference one precision step lower, in the program's place) reads past
the cells' numbers, and a run whose timed path is broken underneath, one fault
at a time, comes out not correct. On the CPU at tiny sizes; the readings at the
cells' own sizes come from ``python3 -m portbench.control`` on the card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import registry
from portbench import run as pbrun

SEED = 2**31 + 11


def _control(root, bench, name, seed=SEED):
    cell = registry.cell(bench, name, root)
    run = pbrun.Run(cell, seed, 0.0, False, torch.device("cpu"))
    return registry.driver(cell["traffic"]).control(run), cell["limits"]


@pytest.mark.parametrize("name", ["tiny.embed", "tinysig.embed", "tiny.dedup"])
def test_the_control_is_not_correct(tiny_root, name):
    root, bench = tiny_root
    program = pbrun.execute(bench, name, SEED, 5.0, False, "cpu", root=root)
    assert program["correct"]
    numbers, limits = _control(root, bench, name)
    over = [k for k, v in numbers.items() if v > limits[k]]
    assert over, (numbers, limits)
    for k in over:  # the control reads three times the program or more
        assert numbers[k] >= 3 * program["checks"][k]["value"]


def test_the_embed_control_reads_the_faults(tiny_root):
    """The control also reads, from the reference's outputs, what each misplaced
    answer would read; at the tiny tower each lies past the cell's limit."""
    root, bench = tiny_root
    cell = registry.cell(bench, "tiny.embed", root)
    run = pbrun.Run(cell, SEED, 0.0, False, torch.device("cpu"))
    registry.driver(cell["traffic"]).control(run)
    assert set(run.faults) == {"crop_swap", "image_swap", "batch_mean", "stats_swap"}
    limits = cell["limits"]
    assert run.faults["stats_swap"] > limits["stats_gap"]
    for k in ("crop_swap", "image_swap", "batch_mean"):
        assert run.faults[k] > limits["embed_gap"], (k, run.faults)


def _encoder_cls():
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder

    return CLIPImageEncoder


def _alter_one_answer(monkeypatch):
    enc = _encoder_cls()
    real = enc.embed_crops

    def embed_crops(self, canvas, params):
        out = real(self, canvas, params).clone()
        out[0, 0] = out[0, 1]  # one crop's embedding replaced where it is produced
        return out

    monkeypatch.setattr(enc, "embed_crops", embed_crops)


def _alter_one_stat(monkeypatch):
    from clip_assisted_data_labeling_tpu_torch.ops import image_stats

    real = image_stats.image_stats_batch

    def image_stats_batch(canvas, params):
        out = real(canvas, params).clone()
        out[0, 11] += 0.01  # one image's mean grey
        return out

    monkeypatch.setattr(image_stats, "image_stats_batch", image_stats_batch)


def _half_the_batch(monkeypatch):
    enc = _encoder_cls()
    real = enc.embed_crops

    def embed_crops(self, canvas, params):
        half = max(1, canvas.shape[0] // 2)
        out = real(self, canvas[:half], params[:half])
        mean = out.mean(0, keepdim=True)
        mean = mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
        return torch.cat([out, mean.expand(canvas.shape[0] - half, -1, -1)])

    monkeypatch.setattr(enc, "embed_crops", embed_crops)


def _swap_two_images(monkeypatch):
    enc = _encoder_cls()
    real = enc.embed_crops

    def embed_crops(self, canvas, params):
        out = real(self, canvas, params)
        order = list(range(len(out)))
        order[0], order[1] = 1, 0  # two images' rows written to each other's places
        return out[order]

    monkeypatch.setattr(enc, "embed_crops", embed_crops)


@pytest.mark.parametrize("fault", [_alter_one_answer, _alter_one_stat, _half_the_batch,
                                   _swap_two_images])
def test_a_broken_embed_path_is_not_correct(tiny_root, monkeypatch, fault):
    root, bench = tiny_root
    fault(monkeypatch)
    res = pbrun.execute(bench, "tiny.embed", SEED, 5.0, False, "cpu", root=root)
    assert not res["correct"] and res["failed"] > 0
    if fault is _swap_two_images:
        assert res["checks"]["misplaced"]["value"] >= 2


def test_misplaced_counts_rows_nearer_another_reference():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((5, 4, 32))
    ref[2, 3] = ref[2, 2] + 1e-6  # two crops that all but coincide
    prog = ref + 1e-3 * rng.standard_normal(ref.shape)
    from portbench.drivers import embed

    assert embed.misplaced(prog, ref, 1e-3).tolist() == [0, 0, 0, 0, 0]
    prog[[0, 1]] = prog[[1, 0]]
    prog[2, 3], prog[2, 2] = prog[2, 2].copy(), prog[2, 3].copy()
    assert embed.misplaced(prog, ref, 1e-3).tolist() == [4, 4, 0, 0, 0]


def _drop_one_pair(monkeypatch):
    from clip_assisted_data_labeling_tpu_torch.ops import similarity

    real = similarity.find_duplicate_pairs

    def find_duplicate_pairs(x, **kw):
        res = real(x, **kw)
        if len(x) > 1000:
            res.rows, res.cols, res.metrics = res.rows[1:], res.cols[1:], res.metrics[1:]
        return res

    monkeypatch.setattr(similarity, "find_duplicate_pairs", find_duplicate_pairs)


def _alter_one_metric(monkeypatch):
    from clip_assisted_data_labeling_tpu_torch.ops import similarity

    real = similarity.find_duplicate_pairs

    def find_duplicate_pairs(x, **kw):
        res = real(x, **kw)
        res.metrics = res.metrics.copy()
        res.metrics[0] = np.float32(res.metrics[0] - 1e-3)
        return res

    monkeypatch.setattr(similarity, "find_duplicate_pairs", find_duplicate_pairs)


def _half_the_rows(monkeypatch):
    from clip_assisted_data_labeling_tpu_torch.ops import similarity

    real = similarity.find_duplicate_pairs
    monkeypatch.setattr(similarity, "find_duplicate_pairs",
                        lambda x, **kw: real(x[: len(x) // 2], **kw))


@pytest.mark.parametrize("fault", [_drop_one_pair, _alter_one_metric, _half_the_rows])
def test_a_broken_dedup_path_is_not_correct(tiny_root, monkeypatch, fault):
    root, bench = tiny_root
    fault(monkeypatch)
    res = pbrun.execute(bench, "tiny.dedup", SEED, 5.0, False, "cpu", root=root)
    assert not res["correct"] and res["failed"] > 0
