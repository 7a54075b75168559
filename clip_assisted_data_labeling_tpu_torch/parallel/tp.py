"""Tensor parallelism for the ViT image towers (port of the JAX package's
``parallel/tp.py``), Megatron's column → row scheme over a 2-D
``('data', 'model')`` mesh:

  * ``qkv_kernel``/``fc1_kernel`` are column-parallel: each ``model`` shard
    computes its own heads or hidden slice with no communication,
  * ``out_kernel``/``fc2_kernel`` are row-parallel: each shard holds a slice
    of the input features and computes a partial product, and the partials
    are summed on the row's first device before bias and residual,
  * biases follow their kernel's output split; the layernorms, patch
    embedding, positional embeddings, pools and projection are replicated.

:data:`TP_BLOCK_SPECS` is the JAX package's rule for which axis of each
stacked ``[L, …]`` block leaf is split; :func:`apply_tp_sharding` builds the
shards from it, after ``parallel/tp_static.reorder_qkv_tp`` has permuted the
packed ``[q|k|v]`` columns so that each shard's contiguous slice is a packed
``[q_j|k_j|v_j]`` of its own heads (and EVA02's swiglu fc1 columns as
``[w1_j|w2_j]``).

The forward runs the single device's block code (``models/vit._block``:
its route, its three block bodies) on each layer's :class:`TPShards`, which
supplies the products over the shards: column products shard-local on the
input quantized once over the full width, attention at ``heads/m`` heads
(routed at the local shape), row-parallel partials summed — int32 before one
dequant epilogue (exact in any order, so an int8 forward is the single
device's bits where the routes agree), float32 for float — and EVA02's
sub-LNs over the gathered full width. In dynamic int8 every block is the
generic one (``CTPU_INT8_BLOCK`` and ``CTPU_FUSED_QMATMUL`` pick nothing
here: K6's row amax spans the full width), and a row-parallel input's row
scale is the maximum (``pmax``) of the shards' row amax. The replicated
work (stem, layernorms, readout) runs once a data row, on the row's first
device, and its outputs are copied to the shards.

Conv towers have no ``blocks``: on a 2-D mesh their params are replicated
and they run data-parallel (``parallel/embed_sharded.py``), as in the JAX
package.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models import clip_weights
from clip_assisted_data_labeling_tpu_torch.models.vit import (
    VisionTransformer,
    VitBlock,
    VitConfig,
    _block,
    _linear,
    _readout,
    _rope_on,
    _stem,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    _dequant_epilogue,
    int_matmul,
    quant_rows,
    quant_static,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import q_matmul_pre, q_matmul_pre_act_q8
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import Mesh, all_gather, pmax, psum

# The split axis of each params["blocks"] leaf (leading axis = depth), as
# the JAX package's PartitionSpecs name it; an unlisted leaf (layernorms,
# row-parallel biases) is replicated.
TP_BLOCK_SPECS: dict[str, tuple] = {
    # column-parallel (output features on 'model')
    "qkv_kernel": (None, None, "model"),
    "qkv_bias": (None, "model"),
    "fc1_kernel": (None, None, "model"),
    "fc1_bias": (None, "model"),
    # row-parallel (input features on 'model'; bias replicated)
    "out_kernel": (None, "model", None),
    "fc2_kernel": (None, "model", None),
    # W8A8 per-output-channel scales follow their kernel's output split
    "qkv_kernel_scale": (None, "model"),
    # the int8 attention wire's per-channel amax: one value a qkv column
    "qkv_amax": (None, "model"),
    "fc1_kernel_scale": (None, "model"),
    "out_kernel_scale": (None, None),
    "fc2_kernel_scale": (None, None),
}


def tp_block_spec(leaf_name: str) -> tuple:
    """The split spec of one params['blocks'] leaf (``()``: replicated)."""
    return TP_BLOCK_SPECS.get(leaf_name, ())


def shard_leaf(name: str, leaf: np.ndarray, n_model: int, j: int) -> np.ndarray:
    """Shard ``j`` of ``n_model`` of a stacked block leaf under its spec."""
    spec = tp_block_spec(name)
    if "model" not in spec:
        return leaf
    ax = spec.index("model")
    if leaf.shape[ax] % n_model:
        raise ValueError(f"blocks/{name} axis {ax} of {leaf.shape} does not split "
                         f"over model={n_model}")
    size = leaf.shape[ax] // n_model
    return np.take(leaf, np.arange(j * size, (j + 1) * size), axis=ax)


class TPModel:
    """A tower placed on a 2-D mesh: per data row, the replicated stem and
    readout (a ``VisionTransformer`` without blocks, on the row's first
    device), one list of ``VitBlock``s a ``model`` shard (each on its
    device, holding its slices) and each layer's :class:`TPShards` over
    them. Shards on a repeated device are distinct modules; rows on the
    same devices share them."""

    def __init__(self, cfg: VitConfig, mesh: Mesh, tops: list[VisionTransformer],
                 shards: list[list[list[VitBlock]]]):
        self.cfg = cfg
        self.mesh = mesh
        self.tops = tops  # [data row]
        self.shards = shards  # [data row][model index][layer]
        self.n_model = mesh.shape["model"]
        self.layers = []  # [data row][layer]
        for row in shards:
            ropes = ([_rope_on(cfg, blks[0].ln1_scale.device) for blks in row]
                     if cfg.use_rope2d else None)
            self.layers.append([TPShards([blks[i] for blks in row], ropes)
                                for i in range(cfg.layers)])

    @property
    def heads_local(self) -> int:
        return self.cfg.heads // self.n_model


def _flat_params(model_or_params) -> dict:
    """Flat numpy params from the port's module or a (flat or nested) dict."""
    if isinstance(model_or_params, Mapping):
        return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in clip_weights.flatten_params(model_or_params).items()}
    return clip_weights.params_from_module(model_or_params)


def place_tp(params: dict, cfg: VitConfig, mesh: Mesh) -> TPModel:
    """Flat params whose qkv (and swiglu fc1) columns are already in the
    per-shard order (``reorder_qkv_tp``) → a :class:`TPModel` on ``mesh``,
    each block leaf split by :data:`TP_BLOCK_SPECS`."""
    n_model = mesh.shape["model"]
    top = {k: v for k, v in params.items() if not k.startswith("blocks/")}
    stacked = {k[len("blocks/"):]: v for k, v in params.items() if k.startswith("blocks/")}
    tops_by_dev: dict[torch.device, VisionTransformer] = {}
    shards_by_key: dict[tuple, list[VitBlock]] = {}
    tops, shards = [], []
    for row in mesh.devices:
        dev0 = row[0]
        if dev0 not in tops_by_dev:
            tensors = {k: clip_weights._tensor(v, dev0) for k, v in top.items()}
            tops_by_dev[dev0] = VisionTransformer(cfg, tensors, [])
        tops.append(tops_by_dev[dev0])
        row_shards = []
        for j, dev in enumerate(row):
            if (dev, j) not in shards_by_key:
                local = {k: shard_leaf(k, v, n_model, j) for k, v in stacked.items()}
                shards_by_key[dev, j] = [VitBlock(t) for t in
                                         clip_weights.block_tensors(local, cfg.layers, dev)]
            row_shards.append(shards_by_key[dev, j])
        shards.append(row_shards)
    return TPModel(cfg, mesh, tops, shards)


def apply_tp_sharding(model, mesh: Mesh) -> TPModel:
    """Place the port's ViT tower module onto ``mesh`` in the
    tensor-parallel layout: the qkv columns reordered for the ``model``
    size, every block leaf split by :data:`TP_BLOCK_SPECS`, every other leaf
    replicated. Float and quantized towers alike; the int8_static path
    places through ``parallel/tp_static.place_tp_static``."""
    from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import reorder_qkv_tp

    if "model" not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} lack the tensor axis 'model'; "
            f"build one with parallel.mesh.get_mesh_2d(data, model)"
        )
    params = reorder_qkv_tp(_flat_params(model), model.cfg, mesh.shape["model"])
    return place_tp(params, model.cfg, mesh)


# ---- the products of one block over the model shards -------------------------------

def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w [K, N] with float32 sums and a float32 output."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, w.to(a.dtype), out_dtype=torch.float32)
    return a.to(torch.float32) @ w.to(torch.float32)


class TPShards:
    """One layer's block over a data row's ``model`` shards: the shard set
    that ``models/vit``'s block bodies take (a ``VitBlock`` is the one-card
    set). ``shards``: one VitBlock a shard on its device (the first's
    replicated leaves are read); ``ropes``: the RoPE tables on each shard's
    device, or None."""

    def __init__(self, shards: list[VitBlock], ropes=None):
        self.shards = shards
        self.ropes = ropes

    def col(self, x, name: str, amax=None, out_dtype=None, act=None) -> list[torch.Tensor]:
        """A column-parallel product on the replicated input x [..., w] (on
        the row's first device): each shard's output columns on its device.
        Float: ``x @ W_j + b_j`` in x's dtype, as the single device's
        ``_linear``; quantized: x's rows quantized once over the full width
        (static under ``amax``, none where x is int8 rows already under it,
        else dynamic), then ``q_matmul_pre`` a shard, or with ``act``
        ``q_matmul_pre_act_q8`` (fc1's int8 hidden under the shard's a[3])."""
        if not self.shards[0].quantized:
            return [_linear(x.to(s.ln1_scale.device), s, name) for s in self.shards]
        lead, x2 = x.shape[:-1], x.reshape(-1, x.shape[-1])
        if amax is None:
            xq, xs = quant_rows(x2)
        else:
            xq = x2 if x.dtype == torch.int8 else quant_static(x2, amax)
            xs = amax * (1.0 / 127.0)
        if out_dtype is None:
            out_dtype = torch.bfloat16 if x.dtype == torch.int8 else x.dtype
        outs = []
        for s in self.shards:
            dev, w = s.ln1_scale.device, getattr(s, name)
            args = (xq.to(dev), xs.to(dev), w, getattr(s, name + "_scale"),
                    getattr(s, name.replace("_kernel", "_bias")))
            out = (q_matmul_pre_act_q8(*args, act, s.act_amax[3:4]) if act is not None
                   else q_matmul_pre(*args, out_dtype=out_dtype))
            outs.append(out.reshape(lead + (w.shape[0],)))
        return outs

    def row(self, parts: list[torch.Tensor], name: str, amax=None, residual=None,
            out_dtype=None) -> torch.Tensor:
        """A row-parallel product of the shards' input slices ``parts``
        [..., k_j] → its output on the first shard's device, in
        ``out_dtype`` (by default the parts' float dtype, bfloat16 for int8
        parts). Float: the float32 partials summed, then the bias (and
        ``residual``) and the cast. Quantized: each slice quantized under
        ``amax`` (none where the parts are int8 already: K3's output, a K2
        sub-LN's rows, the int8 hidden), or dynamically with the row scale
        of the ``pmax`` of the slices' row amax; the int32 partials summed
        (exact in any order) before one dequant epilogue, as the single
        device's ``q_matmul``/``q_matmul_pre``."""
        b0 = self.shards[0]
        dev0 = b0.ln1_scale.device
        lead = parts[0].shape[:-1]
        if out_dtype is None:
            out_dtype = torch.bfloat16 if parts[0].dtype == torch.int8 else parts[0].dtype
        flat = [p.reshape(-1, p.shape[-1]) for p in parts]
        bias = getattr(b0, name.replace("_kernel", "_bias"))
        res = None if residual is None else residual.reshape(-1, residual.shape[-1])
        if not b0.quantized:
            acc = psum([_mm_f32(p, getattr(s, name)) for p, s in zip(flat, self.shards)], dev0)
            acc += bias.to(torch.float32)
            if res is not None:
                acc += res
            out = acc.to(out_dtype)
        else:
            if amax is None:
                row_amax = pmax([p.to(torch.float32).abs().amax(dim=-1, keepdim=True)
                                 for p in flat], dev0)
                quantized = [quant_rows(p, row_amax.to(p.device)) for p in flat]
                qs, x_scale = [q for q, _ in quantized], quantized[0][1]
            else:
                x_scale = amax * (1.0 / 127.0)
                qs = (flat if parts[0].dtype == torch.int8
                      else [quant_static(p, amax.to(p.device)) for p in flat])
            acc = psum([int_matmul(q, getattr(s, name)) for q, s in zip(qs, self.shards)], dev0)
            out = _dequant_epilogue(acc, x_scale, getattr(b0, name + "_scale"), bias, res,
                                    out_dtype)
        return out.reshape(lead + (out.shape[-1],))

    def full(self, parts: list[torch.Tensor], fn) -> list[torch.Tensor]:
        """A full-width function (EVA02's sub-LNs) on a sharded activation:
        the slices gathered on the first shard's device (each shard's
        columns are a contiguous slice in natural order), ``fn`` on the full
        width there (the same op on the same values as the single device),
        then each shard's slice of the result back on its device."""
        full = fn(all_gather(parts, self.shards[0].ln1_scale.device))
        widths = np.cumsum([0] + [p.shape[-1] for p in parts])
        return [full[..., widths[j]: widths[j + 1]].contiguous().to(s.ln1_scale.device)
                for j, s in enumerate(self.shards)]


@torch.inference_mode()
def encode_rows(tpm: TPModel, images: torch.Tensor, compute_dtype,
                normalize: bool) -> torch.Tensor:
    """The tower over a 2-D mesh: the images split over the data rows; per
    row the replicated stem, ``models/vit._block`` on each layer's
    :class:`TPShards` and the replicated readout; the embeddings gathered on
    the mesh's first device."""
    cfg = tpm.cfg
    n_rows = len(tpm.tops)
    if images.shape[0] % n_rows:
        raise ValueError(f"batch {images.shape[0]} must divide over {n_rows} data rows")
    outs = []
    for top, layers, part in zip(tpm.tops, tpm.layers, images.chunk(n_rows)):
        x, _ = _stem(top, part.to(top.ln_post_scale.device), compute_dtype)
        for blk in layers:
            x = _block(x, blk, cfg, blk.ropes)
        outs.append(_readout(x, top, compute_dtype, normalize))
    first = tpm.tops[0].ln_post_scale.device
    return torch.cat([o.to(first) for o in outs])


def vit_encode_tp(tpm: TPModel, images: torch.Tensor, compute_dtype=torch.bfloat16,
                  normalize: bool = True) -> torch.Tensor:
    """Tensor-parallel float32, bfloat16 or dynamic-int8 forward → [B,
    embed_dim] float32 on the mesh's first device (the dataflow of the
    module docstring)."""
    return encode_rows(tpm, images, compute_dtype, normalize)
