"""Tensor parallelism for the int8_static path (port of the JAX package's
``parallel/tp_static.py``): the Megatron column → row dataflow with each
``model`` shard running the single-device static block's ops (kernels
included) on its weight slice — the single device's block code itself
(``models/vit._block`` on ``parallel/tp.TPShards``):

  * qkv/fc1 column-parallel: each shard computes its heads' or hidden
    slice's columns with no communication. The packed ``[q|k|v]`` layout must
    survive the split, so :func:`reorder_qkv_tp` permutes the qkv output
    columns from ``[q(w)|k(w)|v(w)]`` to per-shard ``[q_j|k_j|v_j]`` blocks (and
    EVA02's swiglu fc1 to ``[w1_j|w2_j]``): a contiguous equal split hands
    every shard a well-formed packed qkv of its own heads (scores are
    head-local, so this is exact).
  * out/fc2 row-parallel: each shard's partial INT32 accumulator; the
    partials are summed (``psum``) BEFORE the one dequant epilogue. Integer
    sums are exact in any order, so the tensor-parallel forward is
    bit-identical to the single-device int8_static forward where each shard
    takes the single device's route.
  * layernorms, patch embedding, pools and projection are replicated; they
    run once a data row on the row's first device.

The three static blocks run as on the single device: the int8 attention
wire (each shard's ``qkv_amax`` slice folded into K3's channel scales, K3 at
``heads/m`` heads), the lnk block (K2's layernorm + quantize on the
replicated residual stream, then K1/K4/K5 at the local head count) and the
generic static chain; the MLP keeps its hidden in int8 where the shard's
fc1 width allows; EVA02's two sub-LNs gather the full width. Routes are
gated as the JAX TP gates them (``models/vit.block_route``): the wire and
the attention kernel at the shard's LOCAL width and head count, lnk at the
full width — where that differs from the single device's route
(:func:`tp_static_routes`), bit-identity is not promised.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import VitBlock, VitConfig, block_route
from clip_assisted_data_labeling_tpu_torch.ops.attention import attention_route
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import Mesh
from clip_assisted_data_labeling_tpu_torch.parallel.tp import (
    TPModel,
    TPShards,
    _flat_params,
    encode_rows,
    place_tp,
    tp_block_spec,
)

POST_NORM_REFUSED = (
    "int8_static for post-norm towers has no tensor-parallel "
    "formulation (parallel/tp_static.py) — use a 1-D data mesh "
    "or --compute_dtype bfloat16"
)


def reorder_qkv_tp(params: dict, cfg: VitConfig, n_model: int) -> dict:
    """Permute the qkv output columns so that a contiguous ``n_model``-way
    split of the last axis gives every shard a packed ``[q_j|k_j|v_j]`` of
    its heads; every per-output-channel qkv leaf present (kernel, bias,
    scale, wire amax) moves with them. For a swiglu MLP the packed fc1
    columns (and their bias and scale) are paired per shard as
    ``[w1_j|w2_j]``. ``params``: a flat dict (``blocks/<name>`` stacked
    ``[L, …]``) of numpy arrays, or the port's module. Exact: the out
    projection reads the heads in their global order, so its rows stay."""
    if not isinstance(params, dict):
        params = _flat_params(params)
    if cfg.heads % n_model:
        raise ValueError(f"{cfg.heads} heads do not split over model={n_model}")
    w, d = cfg.width, cfg.head_dim
    hpd = cfg.heads // n_model  # heads a shard
    cols = []
    for j in range(n_model):
        head_cols = np.arange(j * hpd * d, (j + 1) * hpd * d)
        cols += [head_cols, w + head_cols, 2 * w + head_cols]
    perm = np.concatenate(cols)  # [3w] qkv output-column permutation
    out = dict(params)
    out["blocks/qkv_kernel"] = np.asarray(out["blocks/qkv_kernel"])[:, :, perm]
    for key in ("qkv_bias", "qkv_kernel_scale", "qkv_amax"):
        if f"blocks/{key}" in out:
            out[f"blocks/{key}"] = np.asarray(out[f"blocks/{key}"])[:, perm]
    if cfg.mlp_type == "swiglu":
        # the silu(h1) ⊙ h2 gate needs each shard to hold the SAME hidden
        # slice of both halves; fc2's rows and the ffn sub-LN read the gated
        # hidden in its natural order, which the contiguous split keeps
        mlp = np.asarray(out["blocks/fc1_kernel"]).shape[-1] // 2
        if mlp % n_model:
            raise ValueError(f"swiglu hidden {mlp} does not split over model={n_model}")
        ml = mlp // n_model
        fperm = np.concatenate([
            np.concatenate([np.arange(j * ml, (j + 1) * ml), mlp + np.arange(j * ml, (j + 1) * ml)])
            for j in range(n_model)
        ])
        out["blocks/fc1_kernel"] = np.asarray(out["blocks/fc1_kernel"])[:, :, fperm]
        for key in ("fc1_bias", "fc1_kernel_scale"):
            if f"blocks/{key}" in out:
                out[f"blocks/{key}"] = np.asarray(out[f"blocks/{key}"])[:, fperm]
    return out


def tp_static_specs(params: dict) -> dict:
    """The split spec of every leaf of flat params (block leaves by
    ``TP_BLOCK_SPECS``, every other leaf replicated: ``()``)."""
    return {k: tp_block_spec(k[len("blocks/"):]) if k.startswith("blocks/") else ()
            for k in params}


def place_tp_static(params, mesh: Mesh, cfg: VitConfig) -> TPModel:
    """Reorder the qkv packing for the mesh's model size and place every
    leaf on its shard. ``params``: the calibrated module or flat params with
    ``blocks/act_amax`` (and ``blocks/qkv_amax`` where the wire is on)."""
    return place_tp(reorder_qkv_tp(params, cfg, mesh.shape["model"]), cfg, mesh)


def tp_static_routes(cfg: VitConfig, n_model: int, wire: bool,
                     compute_dtype=torch.bfloat16) -> tuple[str, str]:
    """(the single device's route, a shard's route) of an int8_static block:
    the block route, and for lnk and static blocks the attention kernel
    (``attention_route``: packed = K1, grouped = K4, flash = K5) after a
    '/'. Bit-identity with the single device holds where the two agree."""
    rope = object() if cfg.use_rope2d else None
    leaves = {"qkv_kernel_scale": torch.ones(3 * cfg.width), "act_amax": torch.ones(4)}
    if wire:
        leaves["qkv_amax"] = torch.ones(3 * cfg.width)
    blk = VitBlock(leaves)
    single = block_route(blk, cfg, rope)
    shard = block_route(TPShards([blk] * n_model), cfg, rope)
    itemsize = torch.finfo(compute_dtype).bits // 8

    def name(route: str, width: int, heads: int) -> str:
        if route == "wire":
            return "wire/K3"
        size = 2 if route == "lnk" else itemsize
        return f"{route}/{attention_route(cfg.seq_len, width, heads, size)}"

    return (name(single, cfg.width, cfg.heads),
            name(shard, cfg.width // n_model, cfg.heads // n_model))


def vit_encode_tp_static(tpm: TPModel, images: torch.Tensor, compute_dtype=torch.bfloat16,
                         normalize: bool = True) -> torch.Tensor:
    """Tensor-parallel int8_static forward over a 2-D ``('data', 'model')``
    mesh → [B, embed_dim] float32 on the mesh's first device. ``tpm``: a
    calibrated tower placed by :func:`place_tp_static`. Bit-identical to the
    single-device int8_static forward where the routes agree (int32
    psums)."""
    if not tpm.shards[0][0][0].static:
        raise ValueError("vit_encode_tp_static needs calibrated act_amax "
                         "scales (models/vit.attach_act_amax)")
    if tpm.cfg.block_norm == "post":
        raise ValueError(POST_NORM_REFUSED)
    return encode_rows(tpm, images, compute_dtype, normalize)
