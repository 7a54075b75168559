"""Data-parallel and tensor-parallel embedding over the device mesh (port of
the JAX package's ``parallel/embed_sharded.py``).

On a 1-D ``('data',)`` mesh the canvases and crop params split on their
leading axis, the tower is replicated (one module per distinct device), and
each shard runs the ordinary single-device program — crops, the family's
forward (ViT, modified ResNet or ConvNeXt, with their kernels) and, where
asked, the image stats — as ``shard_map`` runs it per device. On a 2-D
``('data', 'model')`` mesh a ViT runs tensor-parallel (``parallel/tp.py``;
int8_static after calibration through ``parallel/tp_static.py``), and a conv
tower keeps replicated params and runs data-parallel over the data axis.
Results are gathered on the mesh's first device.
"""
from __future__ import annotations

import copy
import os
from typing import Mapping

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models import clip_weights
from clip_assisted_data_labeling_tpu_torch.models.conv_tower import conv_family
from clip_assisted_data_labeling_tpu_torch.models.encoders import (
    check_calibration,
    load_calibration,
    save_calibration,
)
from clip_assisted_data_labeling_tpu_torch.models.vit import (
    attach_act_amax,
    int8_wire_enabled,
    vit_act_amax,
    vit_encode_image,
)
from clip_assisted_data_labeling_tpu_torch.ops.crops import fused_crop_resize_normalize
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import image_stats_batch
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import Mesh


def _replica(model, device: torch.device):
    """``model`` itself where its buffers live on ``device``, else a copy
    there."""
    if next(iter(model.buffers())).device == device:
        return model
    return copy.deepcopy(model).to(device)


def _max_trees(trees: list[dict]) -> dict:
    """The elementwise maximum of per-shard amax dicts: the amax over the
    whole batch."""
    return {k: np.maximum.reduce([np.asarray(t[k], np.float32) for t in trees]) for k in trees[0]}


class ShardedEmbedder:
    """Embeds batches whose leading dim is a multiple of the mesh's data
    size (the loader's fixed batch shape makes this free). ``model``: the
    port's tower module, or flat (or JAX-nested) params with ``cfg``;
    quantized params run dynamic int8 until :meth:`calibrate_static`
    attaches static scales."""

    def __init__(self, model, cfg, mesh: Mesh, compute_dtype=torch.bfloat16,
                 parity_preprocess: bool = False, calibration_path: str | None = None,
                 model_name: str = "", debug_nans: bool = False):
        # int8_static persistence (the encoder's contract): saved scales load
        # when the file exists, a fresh calibration is saved, and the model
        # name is recorded so same-geometry towers cannot swap scale files
        if calibration_path and not model_name:
            raise ValueError(
                "ShardedEmbedder(calibration_path=...) needs model_name — "
                "calibration files are validated by recorded model name"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.parity_preprocess = parity_preprocess
        self.calibration_path = calibration_path
        self.model_name = model_name
        self.debug_nans = debug_nans
        self.family = conv_family(cfg)
        first = mesh.devices.flat[0]
        if isinstance(model, Mapping):
            model = clip_weights.module_from_params(clip_weights.flatten_params(model), cfg, first)
        self.model = model
        # a conv tower has no tensor-parallel layout: data-parallel on any mesh
        self._dp_only = "model" not in mesh.axis_names or self.family is not None
        self._tp_static = False  # set by calibrate_static on 2-D meshes
        self.data_devices = (list(mesh.devices.flat) if "model" not in mesh.axis_names
                             else mesh.local_devices("data"))
        self.n_devices = len(self.data_devices)
        if self._dp_only:
            replicas: dict[torch.device, torch.nn.Module] = {}
            self.replicas = [replicas.setdefault(d, _replica(model, d)) for d in self.data_devices]
        elif model.calibrated:
            self._place_tp_static()
        else:
            from clip_assisted_data_labeling_tpu_torch.parallel.tp import apply_tp_sharding

            self.tp = apply_tp_sharding(model, mesh)

    def _place_tp_static(self) -> None:
        from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import place_tp_static

        self.tp = place_tp_static(self.model, self.mesh, self.cfg)
        self._tp_static = True
        print(f"int8_static: explicit-collective TP over {self.mesh.shape}")

    def _crops(self, canvas, crop_params, device) -> torch.Tensor:
        """[b, C, C, 3] uint8 + [b, n, 2, 4] → flat [b·n, R, R, 3] crops on
        ``device``."""
        crops = fused_crop_resize_normalize(
            torch.as_tensor(canvas).to(device), torch.as_tensor(crop_params).to(device),
            out_size=self.cfg.image_size, parity=self.parity_preprocess,
            dtype=self.compute_dtype, mean=self.cfg.norm_mean, std=self.cfg.norm_std,
        )
        return crops.reshape((-1,) + crops.shape[2:])

    def _split(self, array) -> list:
        n = self.n_devices
        if array.shape[0] % n:
            raise ValueError(f"batch {array.shape[0]} must divide over {n} devices")
        m = array.shape[0] // n
        return [array[i * m:(i + 1) * m] for i in range(n)]

    def _calibration_amax(self, canvas_u8, crop_params, act_amax) -> dict:
        """The raw amax of this batch: each data shard's calibration forward
        (on its replica; on a 2-D mesh on the full tower, kept on the first
        device until it is placed), then the elementwise maximum."""
        if self._dp_only:
            pairs = list(zip(self.replicas, self.data_devices))
        else:
            pairs = [(self.model, self.mesh.devices.flat[0])] * self.n_devices
        return _max_trees([
            act_amax(model, self._crops(canvas, cp, dev), self.compute_dtype)
            for (model, dev), canvas, cp in zip(pairs, self._split(canvas_u8),
                                                self._split(crop_params))])

    def _load(self, wire: bool = False) -> dict | None:
        if not (self.calibration_path and os.path.exists(self.calibration_path)):
            return None
        amax = load_calibration(self.calibration_path)
        check_calibration(amax, self.cfg, self.calibration_path, self.model_name)
        amax.pop("_model_name", None)
        if wire and "qkv_amax" not in amax:
            return None  # saved without the wire scales; recalibrate
        print(f"Loaded static int8 calibration from {self.calibration_path}")
        return amax

    def _save(self, amax: dict) -> None:
        if self.calibration_path:
            save_calibration(self.calibration_path, amax, self.model_name)
            print(f"Saved static int8 calibration to {self.calibration_path}")

    def calibrate_static(self, canvas_u8, crop_params) -> None:
        """int8_static on the mesh: the calibration forward on this batch's
        shards (the elementwise max of their amax is the amax of the whole
        batch), or the ``.calib.npz`` when it exists, then the scales
        attached to every replica; on a 2-D mesh the tower is then placed
        for the explicit-collective TP forward (``parallel/tp_static``)."""
        if self._tp_static or (self._dp_only and self.replicas[0].calibrated):
            return
        if self.family is not None:
            amax = self._load()
            if amax is None:
                amax = self._calibration_amax(canvas_u8, crop_params, self.family.act_amax)
                self._save(amax)
            for rep in {id(r): r for r in self.replicas}.values():
                rep.attach_act_amax(amax)
            return
        if self.cfg.block_norm == "post" and not self._dp_only:
            # tp_static's explicit-collective blocks are pre-norm formulations
            from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import POST_NORM_REFUSED

            raise ValueError(POST_NORM_REFUSED)
        # the wire follows the GLOBAL tower shape; on 2-D meshes tp_static
        # re-gates it at each shard's local shape
        wire = int8_wire_enabled(self.cfg)
        amax = self._load(wire)
        if amax is None:
            amax = self._calibration_amax(canvas_u8, crop_params, vit_act_amax)
            self._save(amax)
        if not wire:
            amax = {"act_amax": amax["act_amax"]}
        if self._dp_only:
            for rep in {id(r): r for r in self.replicas}.values():
                attach_act_amax(rep, amax, wire=wire)
            return
        attach_act_amax(self.model, amax, wire=wire)
        self._place_tp_static()

    @torch.inference_mode()
    def embed(self, canvas_u8, crop_params, stat_params=None):
        """[B, C, C, 3] uint8 + [B, n, 2, 4] → [B, n, D] float32 embeddings
        on the mesh's first device (and [B, 22] stats with ``stat_params``)."""
        first = self.mesh.devices.flat[0]
        b, n = crop_params.shape[:2]
        if self._dp_only:
            encode = self.family.encode if self.family else vit_encode_image
            embs = []
            for rep, dev, canvas, cp in zip(self.replicas, self.data_devices,
                                            self._split(canvas_u8), self._split(crop_params)):
                emb = encode(rep, self._crops(canvas, cp, dev), self.compute_dtype,
                             debug_nans=self.debug_nans)
                embs.append(emb.reshape(canvas.shape[0], n, -1))
            emb = torch.cat([e.to(first) for e in embs])
        else:
            from clip_assisted_data_labeling_tpu_torch.parallel.tp import vit_encode_tp
            from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import (
                vit_encode_tp_static,
            )

            self._split(canvas_u8)  # the data-row divisibility check
            fn = vit_encode_tp_static if self._tp_static else vit_encode_tp
            emb = fn(self.tp, self._crops(canvas_u8, crop_params, first),
                     self.compute_dtype).reshape(b, n, -1)
        if stat_params is None:
            return emb
        stats = []
        for dev, canvas, sp in zip(self.data_devices, self._split(canvas_u8),
                                   self._split(stat_params)):
            stats.append(image_stats_batch(torch.as_tensor(canvas).to(dev),
                                           torch.as_tensor(sp).to(dev)))
        return emb, torch.cat([s.to(first) for s in stats])
