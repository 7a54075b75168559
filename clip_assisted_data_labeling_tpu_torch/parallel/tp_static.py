"""Tensor parallelism for the int8_static path (port of the JAX package's
``parallel/tp_static.py``): the Megatron column → row dataflow written out
by hand, each ``model`` shard running the single-device static block's ops
(kernels included) on its weight slice:

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

:func:`_block_tp_static` mirrors ``models/vit``'s three static blocks op for
op: the int8 attention wire (the local ``qkv_amax`` slice folded into K3's
channel scales, K3 at ``heads/m`` heads), the lnk block (K2's layernorm +
quantize on the replicated residual stream, then K1/K4/K5 at the local head
count), and the generic static chain; EVA02's two sub-LNs gather the full
width, run the replicated layernorm (K2 for the attention sub-LN in the lnk
block) and hand each shard its slice. Routes are gated as the JAX TP gates
them: the wire and the attention kernel at the shard's LOCAL width and head
count, lnk at the full width — where that differs from the single device's
route (:func:`tp_static_routes`), bit-identity is not promised.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import (
    VitBlock,
    VitConfig,
    _act,
    _layernorm,
    _silu,
    block_route,
)
from clip_assisted_data_labeling_tpu_torch.ops import knobs
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    attention_route,
    fused_attention_packed_q8s,
    packed_attention_auto,
    packed_q8s_fits,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    _dequant_epilogue,
    int_matmul,
    quant_static,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import q_matmul_pre, rowquant_static
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import Mesh, psum
from clip_assisted_data_labeling_tpu_torch.parallel.tp import (
    TPModel,
    _flat_params,
    col_linear,
    encode_rows,
    gather_slices,
    place_tp,
    row_linear,
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


def _shard_route(cfg: VitConfig, blk: VitBlock, heads_local: int, rope) -> str:
    """'wire', 'lnk' or 'static' for a shard's block, as the JAX TP gates
    it: the wire at the shard's local width and heads, lnk at the full
    width."""
    wl = blk.qkv_kernel_scale.numel() // 3
    eva = cfg.mlp_type == "swiglu" or cfg.attn_inner_ln
    if (blk.wire and rope is None and not eva
            and packed_q8s_fits(cfg.seq_len, wl, heads_local)):
        return "wire"
    if knobs.LN_KERNEL and cfg.width % 128 == 0:
        return "lnk"
    return "static"


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
    single = block_route(VitBlock(leaves), cfg, rope)
    local = {k: v[: v.numel() // n_model] for k, v in leaves.items() if k != "act_amax"}
    shard = _shard_route(cfg, VitBlock({**leaves, **local}), cfg.heads // n_model, rope)
    itemsize = torch.finfo(compute_dtype).bits // 8

    def name(route: str, width: int, heads: int) -> str:
        if route == "wire":
            return "wire/K3"
        size = 2 if route == "lnk" else itemsize
        return f"{route}/{attention_route(cfg.seq_len, width, heads, size)}"

    return (name(single, cfg.width, cfg.heads),
            name(shard, cfg.width // n_model, cfg.heads // n_model))


def _block_tp_static(x, blks: list[VitBlock], cfg: VitConfig, heads_local: int, ropes):
    """One int8_static block over the model shards, op for op the single
    device's ``_block_int8_static_wire``, ``_block_int8_static_lnk`` or the
    static chain of ``_block_generic`` (by :func:`_shard_route`), with the
    int32 partials of out and fc2 summed before their one epilogue."""
    B, S, w = x.shape
    b0 = blks[0]
    a = b0.act_amax
    d = cfg.head_dim
    inv127 = 1.0 / 127.0
    route = _shard_route(cfg, b0, heads_local, ropes[0])
    swiglu = cfg.mlp_type == "swiglu"

    if route == "wire":
        y = _layernorm(x, b0.ln1_scale, b0.ln1_bias, cfg.ln_eps)
        yq = quant_static(y, a[0]).reshape(B * S, w)
        attn = []
        for blk in blks:
            dev = blk.ln1_scale.device
            qkv_f = q_matmul_pre(yq.to(dev), blk.act_amax[0] * inv127, blk.qkv_kernel,
                                 blk.qkv_kernel_scale, blk.qkv_bias, out_dtype=torch.float32)
            qa = blk.qkv_amax  # the shard's [3·wl] per-channel slice
            wl = qa.numel() // 3
            qkv_q = quant_static(qkv_f, qa).reshape(B, S, 3 * wl)
            cs = torch.cat([qa[:wl] * (inv127 * d ** -0.5), qa[wl:2 * wl] * inv127,
                            qa[2 * wl:] / blk.act_amax[1]])
            attn.append(fused_attention_packed_q8s(qkv_q, cs, heads=heads_local))
        # K3's output is already int8 under a[1]: the out partials sum as is
        x = x + row_linear_q(attn, blks, "out_kernel", a[1] * inv127, x.dtype).reshape(B, S, w)
        y = _layernorm(x, b0.ln2_scale, b0.ln2_bias, cfg.ln_eps)
        h = col_linear(y, blks, "fc1_kernel", y.dtype, True,
                       rows=(quant_static(y, a[2]).reshape(B * S, w), a[2] * inv127))
        g = [_act(t, cfg.act, quantized=True) for t in h]
        return row_linear(g, blks, "fc2_kernel", "static", a[3], residual=x)

    if route == "lnk":
        x2 = x.reshape(B * S, w)
        xq = rowquant_static(x2, b0.ln1_scale, b0.ln1_bias, a[0:1], ln_eps=cfg.ln_eps)
        qkv = col_linear(x2, blks, "qkv_kernel", torch.bfloat16, True, rows=(xq, a[0] * inv127))
        attn = [packed_attention_auto(q.reshape(B, S, -1), heads=heads_local,
                                      scale=d ** -0.5, rope=r).reshape(B * S, -1)
                for q, r in zip(qkv, ropes)]
        if cfg.attn_inner_ln:
            aq = gather_slices(attn, blks, lambda t: rowquant_static(
                t, b0.attn_ln_scale, b0.attn_ln_bias, a[1:2], ln_eps=cfg.ln_eps))
            x2 = x2 + row_linear_q(aq, blks, "out_kernel", a[1] * inv127, x.dtype)
        else:
            x2 = x2 + row_linear(attn, blks, "out_kernel", "static", a[1])
        hq = rowquant_static(x2, b0.ln2_scale, b0.ln2_bias, a[2:3], ln_eps=cfg.ln_eps)
        h = col_linear(x2, blks, "fc1_kernel", torch.bfloat16, True, rows=(hq, a[2] * inv127))
        if swiglu:
            g = _swiglu_gather(h, blks, cfg)
        else:
            g = [_act(t, cfg.act, quantized=True) for t in h]
        out = row_linear(g, blks, "fc2_kernel", "static", a[3], residual=x2)
        return out.reshape(B, S, w)

    # the generic block with static scales (``_block_generic``'s static chain)
    y = _layernorm(x, b0.ln1_scale, b0.ln1_bias, cfg.ln_eps)
    qkv = col_linear(y, blks, "qkv_kernel", x.dtype, True,
                     rows=(quant_static(y, a[0]).reshape(B * S, w), a[0] * inv127))
    attn = [packed_attention_auto(q, heads=heads_local, scale=d ** -0.5, rope=r)
            for q, r in zip(qkv, ropes)]
    if cfg.attn_inner_ln:
        attn = gather_slices(attn, blks, lambda t: _layernorm(
            t, b0.attn_ln_scale, b0.attn_ln_bias, cfg.ln_eps))
    x = x + row_linear(attn, blks, "out_kernel", "static", a[1])
    y = _layernorm(x, b0.ln2_scale, b0.ln2_bias, cfg.ln_eps)
    if swiglu:  # EVA02's MLP quantizes dynamically, as on the single device
        g = _swiglu_gather(col_linear(y, blks, "fc1_kernel", y.dtype, True), blks, cfg)
        return x + row_linear(g, blks, "fc2_kernel", "dynamic")
    h = col_linear(y, blks, "fc1_kernel", x.dtype, True,
                   rows=(quant_static(y, a[2]).reshape(B * S, w), a[2] * inv127))
    g = [_act(t, cfg.act, quantized=True) for t in h]
    return row_linear(g, blks, "fc2_kernel", "static", a[3], residual=x)


def _swiglu_gather(h: list[torch.Tensor], blks: list[VitBlock], cfg: VitConfig):
    """EVA02's gate on each shard's paired ``[h1_j|h2_j]`` (shard-local),
    then the ffn sub-LN over the gathered full hidden width, sliced back."""
    b0 = blks[0]
    gates = [_silu(h1) * h2 for h1, h2 in (t.chunk(2, dim=-1) for t in h)]
    return gather_slices(gates, blks, lambda t: _layernorm(
        t, b0.ffn_ln_scale, b0.ffn_ln_bias, cfg.ln_eps))


def row_linear_q(parts_q: list[torch.Tensor], blks: list[VitBlock], name: str, x_scale,
                 out_dtype) -> torch.Tensor:
    """A row-parallel product over inputs already int8 (K3's output, or a
    gathered sub-LN's K2 rows): the int32 partials summed, then the single
    device's ``q_matmul_pre`` epilogue with the scalar ``x_scale``."""
    b0 = blks[0]
    dev0 = b0.ln1_scale.device
    flat = [p.reshape(-1, p.shape[-1]) for p in parts_q]
    acc = psum([int_matmul(q, getattr(b, name)) for q, b in zip(flat, blks)], dev0)
    return _dequant_epilogue(acc, x_scale, getattr(b0, name + "_scale"),
                             getattr(b0, name.replace("_kernel", "_bias")), None, out_dtype)


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
    return encode_rows(tpm, images, compute_dtype, normalize, _block_tp_static)
