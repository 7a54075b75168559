"""The CLIP image encoder (port of the JAX package's ``models/encoders.py``):
every tower of the open_clip name surface — the ViT trunks (CLIP, SigLIP/
SigLIP2 with naflex, PE, EVA, CoCa, CLIPA), the modified ResNets and
ConvNeXt — dispatched on the config's type as the JAX package's
``_encode_fn``/``_init_fn`` do: a conv config's family descriptor
(``models/conv_tower.conv_family``) carries its init, forward, quantize and
calibration, and a ViT config takes ``models/vit``'s.

A ``CLIPImageEncoder`` owns the config and the tower module and exposes:

  * ``img_resolution`` — drives the fused preprocess output size,
  * ``embed_crops(canvas, crop_params)`` — uint8 canvases → 4-crop
    preprocess → tower → [B, n_crops, D] embeddings on the device,
  * ``encode_variable(images, max_patches)`` — a naflex tower's
    native-aspect path (``models/naflex.py``), float32 or bfloat16 only;
    ``encode_patches`` takes the same images already prepared
    (``models/naflex.preprocess_variable``, as the loader's workers do for
    the embed stage's ``--aspect native``).

Modes: ``float32`` and ``bfloat16`` (strict parity), ``int8`` (W8A8 with
dynamic per-row activation scales: quantized weights, bf16 compute, no
calibration) and ``int8_static`` (W8A8 with per-layer activation scales
calibrated on the first batch and persisted to ``.calib.npz`` in the JAX
package's format, so either package reads the other's file). As in the JAX
package, EVA02's swiglu/sub-LN block and the conv towers have no dynamic-int8
form: ``int8`` runs them in bfloat16, with the JAX package's warning; and
int8_static runs a ResNet or ConvNeXt tower in bfloat16 where
``rn_int8_static_enabled`` / ``cnx_int8_static_enabled`` say it loses
(``CTPU_RN_INT8``, ``CTPU_CNX_INT8``). Where
``models.vit.int8_wire_enabled`` says so (SO400M-384 by default; every tower
under ``CTPU_INT8_WIRE=1``, none under ``=0``), int8_static also calibrates
and attaches the per-channel ``qkv_amax``, and a file saved without it is
recalibrated; its blocks then run the int8 attention wire where
``models.vit.block_route`` takes it (no RoPE, the wire kernel's gate), as
``CTPU_LN_KERNEL`` and ``CTPU_INT8_BLOCK`` pick the other blocks.

Weight resolution order (no network — only local files are read), the JAX
``_load_params``'s (models/encoders.py:298-369):
  1. explicit ``params`` argument (flat or JAX-nested dict of arrays),
  2. ``--model_path`` a file: an ``.npz`` loads, any other file (``.pt``,
     ``.pth``, ``.bin``, ``.safetensors``) is converted; a missing path raises,
  3. ``<model_path>/<name>.orbax`` (the name with slashes as dashes): JAX's
     orbax format, which the port cannot read — it raises
     :data:`ORBAX_NEEDS_JAX`, naming the conversion to ``.npz`` through the
     JAX package,
  4. ``<model_path>/<name>.npz``; a RoPE tower's ``.npz`` saved before the
     ``rope_half`` marker is brought to the half-split pairing
     (``clip_weights.ensure_rope_half``),
  5. ``<model_path>/*.{pt,pth,bin,safetensors}``: the stem equal to the name,
     then to the architecture, then a name containing the model name, then the
     only checkpoint, then ``pytorch_model``, ``model`` or
     ``open_clip_pytorch_model``; a directory whose checkpoints match none of
     these raises ``FileNotFoundError``,
  6. only without a path, or in a directory with no checkpoint: deterministic
     random init (seeded by model name) with a loud warning.
"""
from __future__ import annotations

import logging
import os
import zlib

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models import clip_weights
from clip_assisted_data_labeling_tpu_torch.models.conv_tower import conv_family
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
from clip_assisted_data_labeling_tpu_torch.utils.timer import layer, span

log = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# a '<name>.orbax' directory: JAX's orbax checkpoint format, which only the
# JAX package reads
ORBAX_NEEDS_JAX = (
    "{path} is an orbax checkpoint, which needs JAX's orbax to read; the PyTorch port "
    "does not import JAX. Convert it once with the JAX package: "
    "clip_weights.save_params_npz('{npz}', clip_weights.load_params_orbax('{path}')), "
    "then pass --model_path {npz}"
)


def _stable_seed(name: str) -> int:
    # hash the WHOLE name so same-geometry towers get different random weights
    return zlib.crc32(name.encode()) % (2**31)


def _settled(params: dict) -> dict:
    """``params`` once the card's work on them has finished, so that the span
    that made them holds their device time (host tensors pass at once)."""
    for leaf in params.values():
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return params


def calibration_file(model_name: str, directory: str) -> str:
    """Canonical on-disk location of a model's int8_static calibration."""
    safe = model_name.replace("/", "-")
    return os.path.join(directory, f"{safe}.calib.npz")


def save_calibration(path: str, amax: dict, model_name: str | None = None) -> None:
    """Persist the RAW (pre-margin) amax dict of the calibration forward —
    every site it produced, qkv_amax included, as the JAX package writes it."""
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


def check_calibration(amax: dict, cfg, path: str, model_name: str = "") -> None:
    """Reject a calibration file recorded for a different tower: first the
    recorded model name, then the amax shapes — a modified ResNet's one [2]
    ``s{s}b{b}_act_amax`` a block, a ConvNeXt's one [depth, 2]
    ``s{s}_act_amax`` a stage, a ViT's ``act_amax`` [layers, 4] (and
    ``qkv_amax``), with the JAX package's messages."""
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
    fam = conv_family(cfg)
    if fam is not None:
        for k, want in fam.calib_shapes(cfg).items():
            got = np.asarray(amax[k]).shape if k in amax else None
            if got != want:
                raise ValueError(
                    f"{path} holds {k}={got}, expected {want} (recorded for "
                    f"{amax.get('_model_name', 'unknown model')}) — wrong "
                    "model's calibration file"
                )
        return
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


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card by way of a pinned copy, an
    asynchronous upload (a pageable one waits for the card's queue)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


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
        takes the JAX package's per-shape rule (a conv tower has none).
        ``debug_nans``: every forward checks each block's output and the
        readout and raises ``FloatingPointError`` at the first NaN."""
        self.model_name = model_name
        self.device = resolve_device(device)
        self.calibration_path = calibration_path
        self.debug_nans = debug_nans
        self.cfg = cfg = resolve_config(model_name)
        self.family = fam = conv_family(cfg)  # None: a ViT
        eva_block = (getattr(cfg, "mlp_type", "mlp") == "swiglu"
                     or getattr(cfg, "attn_inner_ln", False))
        # the JAX package's downgrades, with its log lines and levels
        if compute_dtype == "int8" and fam:
            log.warning(fam.no_int8, model_name)
            compute_dtype = "bfloat16"
        elif compute_dtype == "int8_static" and fam and not fam.int8_static_enabled(cfg):
            log.info(
                "%s: int8_static auto-resolves OFF for this %s "
                "geometry (measured slower than bf16); running bfloat16",
                model_name, fam.label,
            )
            compute_dtype = "bfloat16"
        elif compute_dtype == "int8" and eva_block:
            # the int8_static lnk block has EVA02 branches; dynamic int8 none
            log.warning(
                "%s (EVA02 swiglu/sub-LN block) has no dynamic-int8 formulation — use "
                "int8_static for the fast path; running bfloat16", model_name,
            )
            compute_dtype = "bfloat16"
        self.wire = False if fam else int8_wire_enabled(cfg, wire)
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
        if self.quantized:
            if fam:
                if not fam.is_quantized(params):
                    log.info("Quantizing %s %s to W8A8", model_name, fam.int8_sites)
                    with span("quantize_weights"):
                        params = _settled(fam.quantize(params))
            elif not is_quantized(params):
                log.info("Quantizing %s weights to W8A8", model_name)
                with span("quantize_weights"):
                    params = _settled(quantize_vit_params(params))
        self.model = clip_weights.module_from_params(params, cfg, self.device)

    @property
    def img_resolution(self) -> int:
        return self.cfg.image_size

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    def _load_params(self, model_path: str | None) -> dict:
        """The JAX ``_load_params``'s lookup (models/encoders.py:298-369);
        see the module docstring."""
        if model_path and not os.path.exists(model_path):
            # a typo'd weights path must fail loudly, not fall to random init
            raise FileNotFoundError(f"--model_path {model_path} does not exist")
        if model_path and os.path.isfile(model_path):
            if model_path.endswith(".npz"):
                return self._load_npz(model_path)
            return self._convert_torch_file(model_path)
        if model_path and os.path.isdir(model_path):
            safe = self.model_name.replace("/", "-")
            orbax_dir = os.path.join(model_path, f"{safe}.orbax")
            if os.path.isdir(orbax_dir):
                raise ValueError(ORBAX_NEEDS_JAX.format(
                    path=orbax_dir, npz=os.path.join(model_path, f"{safe}.npz")))
            npz = os.path.join(model_path, f"{safe}.npz")
            if os.path.exists(npz):
                log.info("Loading %s weights from %s", self.model_name, npz)
                return self._load_npz(npz)
            candidates = [f for f in sorted(os.listdir(model_path))
                          if f.endswith((".pt", ".pth", ".bin", ".safetensors"))]
            # the exact stem (the full name, then the bare architecture:
            # 'ViT-L-14/openai' finds ViT-L-14.pt), then a name containing
            # it, then the only checkpoint, then the standard names
            arch = self.model_name.split("/")[0]
            named = ([f for f in candidates if os.path.splitext(f)[0] == safe]
                     or [f for f in candidates if os.path.splitext(f)[0] == arch]
                     or [f for f in candidates if safe in f])
            if not named and len(candidates) == 1:
                named = candidates
            if not named:
                named = [f for f in candidates if os.path.splitext(f)[0] in
                         ("pytorch_model", "model", "open_clip_pytorch_model")]
            if named:
                return self._convert_torch_file(os.path.join(model_path, named[0]))
            if candidates:
                # checkpoints, but not this model's: a lookup miss, not a
                # request for random init
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
        init = self.family.init if self.family else init_vit_params
        return init(self.cfg, gen, self.device)

    def _load_npz(self, path: str) -> dict:
        params = clip_weights.load_params_npz(path)
        if isinstance(self.cfg, VitConfig):
            params = clip_weights.ensure_rope_half(params, self.cfg)
        return params

    def _convert_torch_file(self, path: str) -> dict:
        log.info("Converting torch checkpoint %s", path)
        if path.endswith(".safetensors"):
            sd = clip_weights.load_safetensors(path)
        else:
            obj = torch.load(path, map_location="cpu", weights_only=True)
            sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        return clip_weights.convert_torch_state_dict(sd, self.cfg)

    def _attach(self, amax: dict) -> None:
        amax = {k: v for k, v in amax.items() if k != "_model_name"}
        if self.family:
            self.model.attach_act_amax(amax)
        else:
            attach_act_amax(self.model, amax, wire=self.wire)

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
        self._attach(amax)
        return True

    def _maybe_calibrate(self, images: torch.Tensor) -> None:
        """int8_static: derive the static activation scales from the FIRST
        batch (one extra forward), reloading/persisting them through
        ``calibration_path`` when set."""
        if not self.static_quant or self.model.calibrated or self.load_calibration():
            return
        with span("calibrate", images.shape[0]):
            if self.family:
                log.info("Calibrating %s static int8 scales on the first batch",
                         self.family.label)
                amax = self.family.act_amax(self.model, images, self.compute_dtype)
            else:
                log.info("Calibrating static int8 activation scales on the first batch")
                amax = vit_act_amax(self.model, images, self.compute_dtype)
        if self.calibration_path:
            save_calibration(self.calibration_path, amax, self.model_name)
            log.info("Saved static int8 calibration to %s", self.calibration_path)
        self._attach(amax)

    @torch.inference_mode()
    def embed_crops(self, canvas_u8, crop_params) -> torch.Tensor:
        """[B, C, C, 3] uint8 + [B, n_crops, 2, 4] → [B, n_crops, D] float32 on
        the device (asynchronous on the card). Every family takes the same
        [B·n, R, R, 3] crops."""
        with layer("crops"):
            canvas = torch.as_tensor(canvas_u8).to(self.device, non_blocking=True)
            params = torch.as_tensor(crop_params).to(self.device, non_blocking=True)
            crops = fused_crop_resize_normalize(
                canvas, params, out_size=self.cfg.image_size, parity=self.parity_preprocess,
                dtype=self.compute_dtype, mean=self.cfg.norm_mean, std=self.cfg.norm_std,
            )
        b, n = crops.shape[:2]
        flat = crops.reshape((b * n,) + crops.shape[2:])
        self._maybe_calibrate(flat)
        encode = self.family.encode if self.family else vit_encode_image
        with layer("forward"):
            emb = encode(self.model, flat, self.compute_dtype, debug_nans=self.debug_nans)
        return emb.reshape(b, n, -1)

    def encode_variable(self, images: list, max_patches: int | None = None) -> torch.Tensor:
        """A naflex tower's native-aspect path: [H, W, 3] uint8 arrays →
        [B, width] float32 unit embeddings on the device, each image on its
        own aspect-preserving patch grid of at most ``max_patches`` patches
        (``models/naflex.py``; None: the tower's square grid, 256 patches at
        patch 16, HF's default). The square crops never need it:
        ``embed_crops`` fills the whole positional grid."""
        from clip_assisted_data_labeling_tpu_torch.models.naflex import preprocess_variable

        self._check_variable()
        n_max = max_patches or self.cfg.seq_len
        prepped = [preprocess_variable(np.asarray(im), self.cfg, n_max) for im in images]
        return self.encode_patches(np.stack([p for p, _, _ in prepped]),
                                   np.stack([m for _, m, _ in prepped]),
                                   [s for _, _, s in prepped])

    def encode_patches(self, patches: np.ndarray, masks: np.ndarray, grids) -> torch.Tensor:
        """``encode_variable`` on images already prepared: patches [B, N_max,
        p²·3], masks [B, N_max] and grids [(gh, gw), …] as
        ``models/naflex.preprocess_variable`` makes them → [B, width] float32
        unit embeddings on the device (asynchronous on the card: the arrays
        go up from pinned copies, so the upload does not wait for the card's
        queue to drain, and the position weights are made there)."""
        from clip_assisted_data_labeling_tpu_torch.models.naflex import (
            naflex_encode,
            pos_weights_on,
        )

        self._check_variable()
        pos_w = pos_weights_on(list(grids), patches.shape[1], self.cfg.grid, self.device)
        patches, masks = (_to_device(a, self.device) for a in (patches, masks))
        return naflex_encode(self.model, patches, pos_w, masks, self.compute_dtype,
                             debug_nans=self.debug_nans)

    def _check_variable(self) -> None:
        if not getattr(self.cfg, "naflex", False):
            raise ValueError(f"{self.model_name} is not a naflex tower; use embed_crops")
        if self.quantized:
            raise ValueError(
                "the masked variable-aspect path has no int8 formulation — construct the "
                "encoder with compute_dtype='bfloat16' (the square-crop path does support "
                "the int8 modes)"
            )


def create_encoder(model_name: str, model_path: str | None = None, **kw) -> CLIPImageEncoder:
    """The reference's dispatch: 'Arch/pretrained' and 'PE-…' names both
    resolve to a ``CLIPImageEncoder`` (``kw`` as its arguments: compute
    dtype, device, ...)."""
    return CLIPImageEncoder(model_name, model_path=model_path, **kw)
