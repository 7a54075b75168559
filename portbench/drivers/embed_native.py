"""The generator of the ``--aspect native`` mixes: ``drivers/embed``'s pool,
set-up and whole passes, with the stage's loop (``pipeline/embed.
embed_batches``) writing a fifth column ``native_aspect``: each image on its
own aspect-preserving patch grid of at most the configuration's
``max_patches`` patches, prepared in the loader's decode workers
(``models/naflex.preprocess_variable``, span ``naflex_prep``) and run by
``CLIPImageEncoder.encode_patches`` beside the crops at the loop's depth 2.
``run.window`` gains ``native_batches`` (each native forward's real patch
counts) and ``varlen_launches`` (the attention launches given per-image key
lengths).

The check holds ``drivers/embed``'s seeded sample (``check_per_size`` images
of each size) against ``reference/naflex``: the four crops and the native
row of each image, over the store's five float16 columns and the sidecars'
five float32 rows (``embed_gap``, ``misplaced`` over the sample's 5·n
reference rows), and its stats (``stats_gap``)."""
from __future__ import annotations

import collections
import os

import numpy as np
import torch

from portbench import synth, weights
from portbench.drivers import embed, stage_loop
from portbench.reference import crops as ref_crops
from portbench.reference import stats as ref_stats
from portbench.reference import tf32

NATIVE = "native_aspect"


def varlen_launches() -> int:
    """The port's attention launches given per-sequence key lengths so far
    (0 where its wrappers count none)."""
    from clip_assisted_data_labeling_tpu_torch.ops import attention

    return sum(getattr(fn, "varlen_launches", 0) for fn in (
        attention.fused_attention_packed, attention.flash_attention_packed))


class NativeStage(stage_loop.LoopStage):
    """The encoder's crops and native rows, five columns in the store and the
    sidecars."""

    def __init__(self, run, paths: list[str], root: str):
        from clip_assisted_data_labeling_tpu_torch.pipeline.embed import native_prep
        from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

        super().__init__(run, paths, root)
        self.crop_names = self.crop_names + [NATIVE]
        self.store = EmbeddingStore.create(
            root, self.model_name, self.crop_names, self.encoder.embed_dim,
            [embed._uuid(p) for p in paths], with_stats=True,
            rel_paths=[os.path.basename(p) for p in paths])
        self.prep = native_prep(self.encoder.cfg, run.config["max_patches"])
        self.native_batches: list[list[int]] = []
        self.varlen0 = 0

    def native(self, patches, masks, grids):
        self.native_batches.append([gh * gw for gh, gw in grids])
        return self.encoder.encode_patches(patches, masks, grids)

    def start_window(self) -> None:
        self.native_batches.clear()
        self.varlen0 = varlen_launches()

    def window_extra(self) -> dict:
        return {"native_batches": [list(b) for b in self.native_batches],
                "varlen_launches": varlen_launches() - self.varlen0}


def drive(run) -> None:
    # a port whose loop has no native rows fails here, before any set-up
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import native_prep  # noqa: F401

    stage_loop.drive(run, NativeStage, _check)


def reference_outputs(run, cfg: dict, mix: dict, picks: list[int], control: bool):
    """The reference's (or the control's) embeddings [n, 5, D] (the four
    crops, then the native row) and stats [n, 22] of the picked pool images,
    made again from the seed."""
    ref = run.reference_module
    per = mix["per_size"]
    params = weights.vit_params(cfg, run.seed, run.device)
    embs, natives, stats = [], [], []
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
            natives += [ref.encode_native(params, cfg, img, cfg["max_patches"], control)
                        for img in imgs]
            stats += [ref_stats.image_stats(img, control) for img in imgs]
            del imgs, crops
    n_crops = len(ref_crops.CROPS)
    crop_emb = torch.cat(embs).reshape(len(picks), n_crops, -1)
    emb = torch.cat([crop_emb, torch.stack(natives)[:, None]], dim=1)
    return emb.double().cpu().numpy(), torch.stack(stats).cpu().numpy()


def _check(run, cfg: dict, mix: dict, paths: list[str], written: set[str], store,
           n_skipped: int) -> None:
    """``drivers/embed._check`` over five columns: what the window wrote of
    a seeded sample (the store's float16 rows and the sidecars' float32 rows
    and stats) against the reference's crops, native rows and stats."""
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import IMG_STAT_KEYS
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    picks = embed.sample(run.seed, mix, written)
    ref_emb, ref_stat = reference_outputs(run, cfg, mix, picks, control=False)
    names = list(ref_crops.CROPS) + [NATIVE]
    cols = [store.meta["crop_names"].index(c) if c in store.meta["crop_names"] else -1
            for c in names]
    d = ref_emb.shape[-1]
    valid = np.asarray(store.valid)[picks]
    st_emb = np.zeros((len(picks), len(names), d), np.float32)
    for ci, col in enumerate(cols):
        if col >= 0:
            st_emb[:, ci] = np.asarray(store.embeddings[picks, col], np.float32)
    st_emb = np.where(valid[:, None, None], st_emb, 0.0)
    st_stat = np.where(valid[:, None], np.asarray(store.img_stats[picks], np.float32), np.nan)
    sc_emb = np.zeros((len(picks), len(names), d), np.float32)
    sc_stat = np.full((len(picks), len(IMG_STAT_KEYS)), np.nan, np.float32)
    for k, i in enumerate(picks):
        path = embed._sidecar(paths[i])
        if not os.path.exists(path):
            continue
        entry = read_sidecar(path).get(cfg["model_name"], {})
        for ci, c in enumerate(names):
            if c in entry:
                sc_emb[k, ci] = np.asarray(entry[c], np.float32).reshape(-1)
        sc_stat[k] = [float(entry.get(key, np.nan)) for key in IMG_STAT_KEYS]
    e1, s1 = embed.gaps(st_emb, st_stat, ref_emb, ref_stat)
    e2, s2 = embed.gaps(sc_emb, sc_stat, ref_emb, ref_stat)
    emb_gap, stat_gap = np.maximum(e1, e2), np.maximum(s1, s2)
    limits = run.limits
    moved = (embed.misplaced(st_emb, ref_emb, limits["misplaced_apart"])
             + embed.misplaced(sc_emb, ref_emb, limits["misplaced_apart"]))
    bad = ((emb_gap > limits["embed_gap"]) | (stat_gap > limits["stats_gap"])
           | (moved > limits["misplaced"]))
    run.failed = int(bad.sum()) + n_skipped
    run.add_check("embed_gap", float(emb_gap.max(initial=0.0)))
    run.add_check("stats_gap", float(stat_gap.max(initial=0.0)))
    run.add_check("misplaced", int(moved.sum()))
    run.add_check("images_checked", len(picks), limits["images_checked"], at_least=True)


def control(run) -> dict:
    """The control's numbers (the reference one precision step lower in the
    program's place, on the sample a run checks) and the faults' readings in
    ``run.faults``, as ``drivers/embed.control``, over the five columns."""
    cfg, mix = run.config, run.traffic
    every = {f"img_{i:05d}" for i in range(len(mix["sizes"]) * mix["per_size"])}
    picks = embed.sample(run.seed, mix, every)
    ref_emb, ref_stat = reference_outputs(run, cfg, mix, picks, control=False)
    run.faults = embed.fault_readings(ref_emb, ref_stat)
    ctl_emb, ctl_stat = reference_outputs(run, cfg, mix, picks, control=True)
    emb_gap, stat_gap = embed.gaps(ctl_emb, ctl_stat, ref_emb, ref_stat)
    native_gap, _ = embed.gaps(ctl_emb[:, -1:], ctl_stat, ref_emb[:, -1:], ref_stat)
    return {"embed_gap": float(emb_gap.max()), "stats_gap": float(stat_gap.max()),
            "native_embed_gap": float(native_gap.max())}
