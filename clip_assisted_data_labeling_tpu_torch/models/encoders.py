"""The CLIP image encoder (port of the JAX package's ``models/encoders.py``
for the ViT-trunk towers: CLIP, SigLIP/SigLIP2 with naflex, PE, EVA, CoCa,
CLIPA).

A ``CLIPImageEncoder`` owns the ViT config and module and exposes:

  * ``img_resolution`` — drives the fused preprocess output size,
  * ``embed_crops(canvas, crop_params)`` — uint8 canvases → 4-crop
    preprocess → ViT → [B, n_crops, D] embeddings on the device,
  * ``encode_variable(images)`` — a naflex tower's native-aspect path
    (``models/naflex.py``), float32 or bfloat16 only.

Modes: ``float32`` and ``bfloat16`` (strict parity), ``int8`` (W8A8 with
dynamic per-row activation scales: quantized weights, bf16 compute, no
calibration) and ``int8_static`` (W8A8 with per-layer activation scales
calibrated on the first batch and persisted to ``.calib.npz`` in the JAX
package's format, so either package reads the other's file). EVA02's
swiglu/sub-LN block has no dynamic-int8 form: ``int8`` runs it in bfloat16,
with the JAX package's warning. Where
``models.vit.int8_wire_enabled`` says so (SO400M-384 by default; every tower
under ``CTPU_INT8_WIRE=1``, none under ``=0``), int8_static also calibrates
and attaches the per-channel ``qkv_amax``, and a file saved without it is
recalibrated; its blocks then run the int8 attention wire where
``models.vit.block_route`` takes it (no RoPE, the wire kernel's gate), as
``CTPU_LN_KERNEL`` and ``CTPU_INT8_BLOCK`` pick the other blocks.

Weight resolution order (no network — only local files are read):
  1. explicit ``params`` argument (flat or JAX-nested dict of arrays),
  2. ``<model_path>/<model-name-with-slashes-as-dashes>.npz`` (or an .npz
     file); a RoPE tower's ``.npz`` saved before the ``rope_half`` marker is
     brought to the half-split pairing (``clip_weights.ensure_rope_half``),
  3. ``<model_path>/*.{pt,pth,bin}`` torch checkpoints (converted),
  4. deterministic random init (seeded by model name) with a loud warning.
"""
from __future__ import annotations

import logging
import os
import zlib

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models import clip_weights
from clip_assisted_data_labeling_tpu_torch.models.vit import (
    VitConfig,
    attach_act_amax,
    init_vit_params,
    int8_wire_enabled,
    resolve_config,
    vit_act_amax,
    vit_encode_image,
)
from clip_assisted_data_labeling_tpu_torch.ops.crops import fused_crop_resize_normalize
from clip_assisted_data_labeling_tpu_torch.ops.quant import is_quantized, quantize_vit_params
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stable_seed(name: str) -> int:
    # hash the WHOLE name so same-geometry towers get different random weights
    return zlib.crc32(name.encode()) % (2**31)


def calibration_file(model_name: str, directory: str) -> str:
    """Canonical on-disk location of a model's int8_static calibration."""
    safe = model_name.replace("/", "-")
    return os.path.join(directory, f"{safe}.calib.npz")


def save_calibration(path: str, amax: dict, model_name: str | None = None) -> None:
    """Persist the RAW (pre-margin) amax dict from vit_act_amax — every site
    it produced, qkv_amax included, as the JAX package writes it."""
    flat = {k: np.asarray(v, np.float32) for k, v in amax.items()}
    if model_name is not None:
        flat["_model_name"] = np.asarray(model_name)
    # atomic replace; the pid keeps concurrent writers' temp names apart
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_calibration(path: str) -> dict:
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def check_calibration(amax: dict, cfg: VitConfig, path: str, model_name: str = "") -> None:
    """Reject a calibration file recorded for a different tower: first the
    recorded model name, then the amax shapes."""
    recorded = str(amax.get("_model_name", ""))
    if recorded and model_name and recorded != model_name:
        raise ValueError(
            f"{path} was calibrated for {recorded}, not {model_name} — "
            "wrong model's file (delete it or pass --calibration)"
        )
    if not recorded:
        log.warning(
            "%s records no model name — only shape-checked; delete it to "
            "recalibrate with provenance", path,
        )
    if "act_amax" not in amax:
        raise ValueError(
            f"{path} is not a calibration file (no act_amax key) — wrong "
            "file passed as --calibration?"
        )
    shape = np.asarray(amax["act_amax"]).shape
    qshape = np.asarray(amax["qkv_amax"]).shape if "qkv_amax" in amax else None
    if shape != (cfg.layers, 4) or (qshape is not None
                                    and qshape != (cfg.layers, 3 * cfg.width)):
        raise ValueError(
            f"{path} holds a {shape}/{qshape} calibration (recorded for "
            f"{amax.get('_model_name', 'unknown model')}); model {model_name} needs "
            f"({cfg.layers}, 4)/({cfg.layers}, {3 * cfg.width}) — wrong model's file "
            "(delete it or pass --calibration)"
        )


class CLIPImageEncoder:
    def __init__(
        self,
        model_name: str,
        model_path: str | None = None,
        params: dict | None = None,
        compute_dtype: str | torch.dtype = "bfloat16",
        parity_preprocess: bool = True,
        calibration_path: str | None = None,
        device: str | torch.device = "cuda",
        wire: bool | None = None,
        debug_nans: bool = False,
    ):
        """``wire`` forces the int8_static attention wire on or off; None
        takes the JAX package's per-shape rule. ``debug_nans``: every
        forward checks each block's output and the readout and raises
        ``FloatingPointError`` at the first NaN."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.calibration_path = calibration_path
        self.debug_nans = debug_nans
        self.cfg = resolve_config(model_name)
        self.wire = int8_wire_enabled(self.cfg, wire)
        if compute_dtype == "int8" and (self.cfg.mlp_type == "swiglu" or self.cfg.attn_inner_ln):
            # the int8_static lnk block has EVA02 branches; dynamic int8 none
            log.warning(
                "%s (EVA02 swiglu/sub-LN block) has no dynamic-int8 formulation — use "
                "int8_static for the fast path; running bfloat16", model_name,
            )
            compute_dtype = "bfloat16"
        # "int8" quantizes the weights once here and the activations per row
        # on the fly; "int8_static" also calibrates fixed activation scales
        # on the first batch. Both compute the rest in bf16.
        self.static_quant = compute_dtype == "int8_static"
        self.quantized = compute_dtype in ("int8", "int8_static")
        if self.quantized:
            self.compute_dtype = torch.bfloat16
        elif isinstance(compute_dtype, torch.dtype):
            self.compute_dtype = compute_dtype
        else:
            self.compute_dtype = _DTYPES[str(compute_dtype)]
        self.parity_preprocess = parity_preprocess
        params = params if params is not None else self._load_params(model_path)
        params = clip_weights.flatten_params(params)
        if self.quantized and not is_quantized(params):
            log.info("Quantizing %s weights to W8A8", model_name)
            params = quantize_vit_params(params)
        self.model = clip_weights.module_from_params(params, self.cfg, self.device)

    @property
    def img_resolution(self) -> int:
        return self.cfg.image_size

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    def _load_params(self, model_path: str | None) -> dict:
        if model_path and not os.path.exists(model_path):
            # a typo'd weights path must fail loudly, not fall to random init
            raise FileNotFoundError(f"--model_path {model_path} does not exist")
        if model_path and os.path.isfile(model_path):
            if model_path.endswith(".npz"):
                return self._load_npz(model_path)
            return self._convert_torch_file(model_path)
        if model_path and os.path.isdir(model_path):
            safe = self.model_name.replace("/", "-")
            npz = os.path.join(model_path, f"{safe}.npz")
            if os.path.exists(npz):
                log.info("Loading %s weights from %s", self.model_name, npz)
                return self._load_npz(npz)
            candidates = [f for f in sorted(os.listdir(model_path))
                          if f.endswith((".pt", ".pth", ".bin"))]
            arch = self.model_name.split("/")[0]
            named = ([f for f in candidates if os.path.splitext(f)[0] in (safe, arch)]
                     or (candidates if len(candidates) == 1 else []))
            if named:
                return self._convert_torch_file(os.path.join(model_path, named[0]))
            if candidates:
                raise FileNotFoundError(
                    f"{model_path} holds {candidates} but none matches "
                    f"{self.model_name} (looked for '{safe}'/'{arch}')"
                )
        log.warning(
            "No local weights found for %s — using deterministic random init "
            "(fine for benchmarks/tests; NOT a trained encoder).",
            self.model_name,
        )
        gen = torch.Generator(device=self.device).manual_seed(_stable_seed(self.model_name))
        return init_vit_params(self.cfg, gen, self.device)

    def _load_npz(self, path: str) -> dict:
        return clip_weights.ensure_rope_half(clip_weights.load_params_npz(path), self.cfg)

    def _convert_torch_file(self, path: str) -> dict:
        log.info("Converting torch checkpoint %s", path)
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        return clip_weights.convert_torch_state_dict(sd, self.cfg)

    def load_calibration(self) -> bool:
        """Attach persisted int8_static scales if a calibration file exists.
        Returns True when scales are attached (loaded now or previously)."""
        if not self.static_quant:
            return False
        if self.model.calibrated:
            return True
        if not (self.calibration_path and os.path.exists(self.calibration_path)):
            return False
        amax = load_calibration(self.calibration_path)
        check_calibration(amax, self.cfg, self.calibration_path, self.model_name)
        if self.wire and "qkv_amax" not in amax:
            log.info("%s lacks qkv_amax (saved without the int8 wire); recalibrating",
                     self.calibration_path)
            return False
        log.info("Loaded static int8 calibration from %s", self.calibration_path)
        attach_act_amax(self.model, amax, wire=self.wire)
        return True

    def _maybe_calibrate(self, images: torch.Tensor) -> None:
        """int8_static: derive per-layer static activation scales from the
        FIRST batch (one extra forward), reloading/persisting them through
        ``calibration_path`` when set."""
        if not self.static_quant or self.model.calibrated or self.load_calibration():
            return
        log.info("Calibrating static int8 activation scales on the first batch")
        amax = vit_act_amax(self.model, images, self.compute_dtype)
        if self.calibration_path:
            save_calibration(self.calibration_path, amax, self.model_name)
            log.info("Saved static int8 calibration to %s", self.calibration_path)
        attach_act_amax(self.model, amax, wire=self.wire)

    @torch.inference_mode()
    def embed_crops(self, canvas_u8, crop_params) -> torch.Tensor:
        """[B, C, C, 3] uint8 + [B, n_crops, 2, 4] → [B, n_crops, D] float32 on
        the device (asynchronous on the card)."""
        canvas = torch.as_tensor(canvas_u8).to(self.device, non_blocking=True)
        params = torch.as_tensor(crop_params).to(self.device, non_blocking=True)
        crops = fused_crop_resize_normalize(
            canvas, params, out_size=self.cfg.image_size, parity=self.parity_preprocess,
            dtype=self.compute_dtype, mean=self.cfg.norm_mean, std=self.cfg.norm_std,
        )
        b, n = crops.shape[:2]
        flat = crops.reshape((b * n,) + crops.shape[2:])
        self._maybe_calibrate(flat)
        emb = vit_encode_image(self.model, flat, self.compute_dtype, debug_nans=self.debug_nans)
        return emb.reshape(b, n, -1)

    def encode_variable(self, images: list) -> torch.Tensor:
        """A naflex tower's native-aspect path: [H, W, 3] uint8 arrays →
        [B, width] float32 unit embeddings on the device, each image on its
        own aspect-preserving patch grid (``models/naflex.py``). The square
        crops never need it: ``embed_crops`` fills the whole positional
        grid."""
        if not self.cfg.naflex:
            raise ValueError(f"{self.model_name} is not a naflex tower; use embed_crops")
        if self.quantized:
            raise ValueError(
                "the masked variable-aspect path has no int8 formulation — construct the "
                "encoder with compute_dtype='bfloat16' (the square-crop path does support "
                "the int8 modes)"
            )
        from clip_assisted_data_labeling_tpu_torch.models.naflex import (
            build_pos_weights,
            naflex_encode,
            preprocess_variable,
        )

        n_max = self.cfg.seq_len
        prepped = [preprocess_variable(np.asarray(im), self.cfg, n_max) for im in images]
        patches = torch.from_numpy(np.stack([p for p, _, _ in prepped])).to(self.device)
        masks = torch.from_numpy(np.stack([m for _, m, _ in prepped])).to(self.device)
        pos_w = torch.from_numpy(build_pos_weights([s for _, _, s in prepped], n_max,
                                                   self.cfg.grid)).to(self.device)
        return naflex_encode(self.model, patches, pos_w, masks, self.compute_dtype,
                             debug_nans=self.debug_nans)


def create_encoder(model_name: str, model_path: str | None = None, **kw) -> CLIPImageEncoder:
    """The reference's dispatch: 'Arch/pretrained' and 'PE-…' names both
    resolve to a ``CLIPImageEncoder`` (``kw`` as its arguments: compute
    dtype, device, ...)."""
    return CLIPImageEncoder(model_name, model_path=model_path, **kw)
