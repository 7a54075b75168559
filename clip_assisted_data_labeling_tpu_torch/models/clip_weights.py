"""Weights in and out of the port (port of the JAX package's
``models/clip_weights.py`` for the ViT-trunk towers).

  * ``save_params_npz`` / ``load_params_npz``: the JAX package's native
    ``.npz`` layout — top-level leaves by name, block leaves as
    ``blocks/<name>`` stacked ``[L, …]`` — so either package reads the other's
    file,
  * ``convert_open_clip_visual`` / ``convert_hf_clip_vision`` /
    ``convert_siglip_visual`` / ``convert_pe_visual`` /
    ``convert_coca_visual`` / ``convert_eva_visual``: torch checkpoints
    (open_clip/OpenAI ``visual.*`` — CLIPA's without ln_pre —, HF
    ``CLIPVisionModelWithProjection``, HF ``SiglipVisionModel`` (naflex's
    Linear patch embed too), Meta's Perception Encoder, open_clip's CoCa with
    its attentional pooler, and BAAI/timm EVA ``blocks.N.*`` with separate or
    fused q/k/v and a SwiGLU MLP) → that flat layout; ``convert_torch_state_dict``
    picks the converter by the checkpoint's keys and the config,
  * ``rope_interleaved_to_half`` / ``ensure_rope_half``: PE and EVA02
    checkpoints pair RoPE features interleaved; the port (like the JAX
    package) pairs halves, so the q/k projection columns are permuted once and
    the params marked with a ``rope_half`` leaf,
  * ``module_from_params``: THE function that carries weights across — a flat
    dict of arrays (as the JAX package's params or ``.npz`` give them) becomes
    the port's module state. The ``[in, out]`` kernel convention stays, so
    ``x @ W`` means the same in both packages; only quantized int8 block
    kernels are stored transposed (``[out, in]``, the layout ``torch._int_mm``
    takes on the card) with their K padded to ``ops/quant.K_ALIGN``.
    ``params_from_module`` goes back.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import VisionTransformer, VitConfig
from clip_assisted_data_labeling_tpu_torch.ops.quant import pad_k

_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "qkv_kernel", "qkv_bias", "out_kernel",
               "out_bias", "ln2_scale", "ln2_bias", "fc1_kernel", "fc1_bias",
               "fc2_kernel", "fc2_bias")


def _t(x) -> np.ndarray:
    """torch tensor (or array) → float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _conv_to_patch_kernel(weight) -> np.ndarray:
    """Conv2d weight [width, 3, p, p] → [p*p*3, width] in patch flatten order
    (row, col, channel)."""
    w = _t(weight)
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


def flatten_params(params: Mapping) -> dict:
    """Nested {"blocks": {...}} (the JAX package's pytree) or already-flat
    params → one flat dict keyed like the ``.npz``."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            for k2, v2 in v.items():
                flat[f"{k}/{k2}"] = v2
        else:
            flat[k] = v
    return flat


def _hf_blocks(sd: Mapping, pre: str, layers: int) -> dict:
    """The stacked ``blocks/<name>`` leaves of an HF 'encoder.layers.N.'
    transformer (the naming HF CLIPVisionModel and SiglipVisionModel share)."""
    def get(k):
        return _t(sd[pre + k])

    blocks: dict[str, list] = {k: [] for k in _BLOCK_KEYS}
    for i in range(layers):
        b = f"encoder.layers.{i}."
        blocks["ln1_scale"].append(get(b + "layer_norm1.weight"))
        blocks["ln1_bias"].append(get(b + "layer_norm1.bias"))
        blocks["qkv_kernel"].append(np.concatenate(
            [get(b + f"self_attn.{n}_proj.weight").T for n in ("q", "k", "v")], axis=1))
        blocks["qkv_bias"].append(np.concatenate(
            [get(b + f"self_attn.{n}_proj.bias") for n in ("q", "k", "v")], axis=0))
        blocks["out_kernel"].append(get(b + "self_attn.out_proj.weight").T)
        blocks["out_bias"].append(get(b + "self_attn.out_proj.bias"))
        blocks["ln2_scale"].append(get(b + "layer_norm2.weight"))
        blocks["ln2_bias"].append(get(b + "layer_norm2.bias"))
        blocks["fc1_kernel"].append(get(b + "mlp.fc1.weight").T)
        blocks["fc1_bias"].append(get(b + "mlp.fc1.bias"))
        blocks["fc2_kernel"].append(get(b + "mlp.fc2.weight").T)
        blocks["fc2_bias"].append(get(b + "mlp.fc2.bias"))
    return {f"blocks/{k}": np.stack(v) for k, v in blocks.items()}


def convert_hf_clip_vision(state_dict: Mapping, cfg: VitConfig) -> dict:
    """HF CLIPVisionModelWithProjection state dict → flat params."""
    pre = "vision_model."

    def get(k):
        return _t(state_dict[pre + k])

    return {
        "patch_kernel": _conv_to_patch_kernel(state_dict[pre + "embeddings.patch_embedding.weight"]),
        "class_emb": get("embeddings.class_embedding"),
        "pos_emb": get("embeddings.position_embedding.weight"),
        "ln_pre_scale": get("pre_layrnorm.weight"),  # sic — HF's historical typo
        "ln_pre_bias": get("pre_layrnorm.bias"),
        "ln_post_scale": get("post_layernorm.weight"),
        "ln_post_bias": get("post_layernorm.bias"),
        "proj": _t(state_dict["visual_projection.weight"]).T,
        **_hf_blocks(state_dict, pre, cfg.layers),
    }


def convert_siglip_visual(state_dict: Mapping, cfg: VitConfig) -> dict:
    """HF SiglipVisionModel state dict (with or without the 'vision_model.'
    prefix) → flat params. HF CLIP's block naming, but a patch conv with
    bias, no class embedding, no pre-layernorm, no projection, and the MAP
    head under ``head.{probe,attention,layernorm,mlp}``."""
    pre = "vision_model." if any(k.startswith("vision_model.") for k in state_dict) else ""

    def get(k):
        return _t(state_dict[pre + k])

    patch_w = get("embeddings.patch_embedding.weight")
    return {
        # a 2-D weight is a Linear over (p, p, c)-flattened patches — the
        # port's flatten order, so it only transposes; fixed-res towers use a Conv2d
        "patch_kernel": patch_w.T if patch_w.ndim == 2 else _conv_to_patch_kernel(patch_w),
        "patch_bias": get("embeddings.patch_embedding.bias"),
        "pos_emb": get("embeddings.position_embedding.weight"),
        **_hf_blocks(state_dict, pre, cfg.layers),
        "ln_post_scale": get("post_layernorm.weight"),
        "ln_post_bias": get("post_layernorm.bias"),
        "pool_probe": get("head.probe").reshape(-1),
        # nn.MultiheadAttention: in_proj [3w, w] row-ordered q|k|v → [w, 3w]
        "pool_in_kernel": get("head.attention.in_proj_weight").T,
        "pool_in_bias": get("head.attention.in_proj_bias"),
        "pool_out_kernel": get("head.attention.out_proj.weight").T,
        "pool_out_bias": get("head.attention.out_proj.bias"),
        "pool_ln_scale": get("head.layernorm.weight"),
        "pool_ln_bias": get("head.layernorm.bias"),
        "pool_fc1_kernel": get("head.mlp.fc1.weight").T,
        "pool_fc1_bias": get("head.mlp.fc1.bias"),
        "pool_fc2_kernel": get("head.mlp.fc2.weight").T,
        "pool_fc2_bias": get("head.mlp.fc2.bias"),
    }


def convert_open_clip_visual(state_dict: Mapping, cfg: VitConfig) -> dict:
    """open_clip / OpenAI 'visual.*' state dict → flat params."""
    sd = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    if not sd:  # already stripped
        sd = dict(state_dict)
    blocks: dict[str, list] = {k: [] for k in _BLOCK_KEYS}
    for i in range(cfg.layers):
        b = f"transformer.resblocks.{i}."
        blocks["ln1_scale"].append(_t(sd[b + "ln_1.weight"]))
        blocks["ln1_bias"].append(_t(sd[b + "ln_1.bias"]))
        blocks["qkv_kernel"].append(_t(sd[b + "attn.in_proj_weight"]).T)
        blocks["qkv_bias"].append(_t(sd[b + "attn.in_proj_bias"]))
        blocks["out_kernel"].append(_t(sd[b + "attn.out_proj.weight"]).T)
        blocks["out_bias"].append(_t(sd[b + "attn.out_proj.bias"]))
        blocks["ln2_scale"].append(_t(sd[b + "ln_2.weight"]))
        blocks["ln2_bias"].append(_t(sd[b + "ln_2.bias"]))
        blocks["fc1_kernel"].append(_t(sd[b + "mlp.c_fc.weight"]).T)
        blocks["fc1_bias"].append(_t(sd[b + "mlp.c_fc.bias"]))
        blocks["fc2_kernel"].append(_t(sd[b + "mlp.c_proj.weight"]).T)
        blocks["fc2_bias"].append(_t(sd[b + "mlp.c_proj.bias"]))
    out = {
        "patch_kernel": _conv_to_patch_kernel(sd["conv1.weight"]),
        "pos_emb": _t(sd["positional_embedding"]),
        "ln_post_scale": _t(sd["ln_post.weight"]),
        "ln_post_bias": _t(sd["ln_post.bias"]),
        "proj": _t(sd["proj"]),
    }
    if "ln_pre.weight" in sd:  # absent for no_ln_pre towers (CLIPA)
        out["ln_pre_scale"] = _t(sd["ln_pre.weight"])
        out["ln_pre_bias"] = _t(sd["ln_pre.bias"])
    if "class_embedding" in sd:  # absent for cls-token-free towers (PE G14)
        out["class_emb"] = _t(sd["class_embedding"])
    out.update({f"blocks/{k}": np.stack(v) for k, v in blocks.items()})
    return out


def rope_interleaved_to_half(params: Mapping, cfg: VitConfig) -> dict:
    """Permute each head's q and k projection columns from the interleaved
    RoPE pairing (q[2i], q[2i+1]) to the half-split one (q[i], q[i+d/2]) and
    mark the params with a ``rope_half`` leaf (JAX
    ``rope_interleaved_to_half``, models/clip_weights.py:358). Scores are
    unchanged under one permutation of both q and k of a head, so the two
    conventions give the same attention. A quantized checkpoint's per-column
    ``qkv_kernel_scale`` and a calibrated one's ``qkv_amax`` follow the same
    permutation. Returns flat params."""
    d, w = cfg.head_dim, cfg.width
    perm_head = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    perm = np.concatenate([h * d + perm_head for h in range(cfg.heads)])
    qkv_perm = np.concatenate([perm, w + perm, 2 * w + np.arange(w)])
    out = flatten_params(params)
    out["blocks/qkv_kernel"] = np.asarray(out["blocks/qkv_kernel"])[:, :, qkv_perm]
    for key in ("qkv_bias", "qkv_kernel_scale", "qkv_amax"):
        if f"blocks/{key}" in out:
            out[f"blocks/{key}"] = np.asarray(out[f"blocks/{key}"])[:, qkv_perm]
    out["rope_half"] = np.ones((), np.int8)
    return out


def ensure_rope_half(params: Mapping, cfg: VitConfig) -> Mapping:
    """Upgrade loaded params to the half-split RoPE pairing if they predate
    the ``rope_half`` marker (JAX ``ensure_rope_half``); params of a tower
    without RoPE, or already marked, come back as they are."""
    flat = flatten_params(params)
    if not cfg.use_rope2d or "rope_half" in flat:
        return params
    return rope_interleaved_to_half(flat, cfg)


def convert_pe_visual(state_dict: Mapping, cfg: VitConfig) -> dict:
    """Meta Perception Encoder 'visual.*' state dict → flat params (JAX
    ``convert_pe_visual``, models/clip_weights.py:179): CLIP's transformer
    naming, plus the probe attention pool (``attn_pool.probe``, one
    nn.MultiheadAttention, a layernorm), no class token on G14, and the q/k
    columns brought to the half-split RoPE pairing. RoPE itself has no
    weights: the tables come from the config."""
    base = rope_interleaved_to_half(convert_open_clip_visual(state_dict, cfg), cfg)
    sd = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    if not sd:
        sd = dict(state_dict)
    if not cfg.use_cls_token:
        base.pop("class_emb", None)
    if cfg.pool == "attn":
        base.update({
            "pool_probe": _t(sd["attn_pool.probe"]).reshape(-1),
            "pool_in_kernel": _t(sd["attn_pool.attn.in_proj_weight"]).T,
            "pool_in_bias": _t(sd["attn_pool.attn.in_proj_bias"]),
            "pool_out_kernel": _t(sd["attn_pool.attn.out_proj.weight"]).T,
            "pool_out_bias": _t(sd["attn_pool.attn.out_proj.bias"]),
            "pool_ln_scale": _t(sd["attn_pool.layernorm.weight"]),
            "pool_ln_bias": _t(sd["attn_pool.layernorm.bias"]),
        })
    return base


def _visual(state_dict: Mapping) -> dict:
    """The 'visual.*' entries with the prefix stripped, or all of them."""
    sd = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    return sd or dict(state_dict)


def convert_coca_visual(state_dict: Mapping, cfg: VitConfig) -> dict:
    """open_clip CoCa 'visual.*' state dict → flat params (JAX
    ``convert_coca_visual``, models/clip_weights.py:219): the trunk as a
    plain open_clip ViT (ln_post and proj already act on the pooled dim);
    the legacy AttentionalPooler's nn.MultiheadAttention (kdim = vdim = w ≠
    e) stores separate q/k/v weights beside one packed in_proj bias."""
    base = convert_open_clip_visual(state_dict, cfg)
    sd = _visual(state_dict)
    base.update({
        "pool_query": _t(sd["attn_pool.query"]),
        "pool_q_kernel": _t(sd["attn_pool.attn.q_proj_weight"]).T,
        "pool_k_kernel": _t(sd["attn_pool.attn.k_proj_weight"]).T,
        "pool_v_kernel": _t(sd["attn_pool.attn.v_proj_weight"]).T,
        "pool_in_bias": _t(sd["attn_pool.attn.in_proj_bias"]),
        "pool_out_kernel": _t(sd["attn_pool.attn.out_proj.weight"]).T,
        "pool_out_bias": _t(sd["attn_pool.attn.out_proj.bias"]),
        "pool_lnq_scale": _t(sd["attn_pool.ln_q.weight"]),
        "pool_lnq_bias": _t(sd["attn_pool.ln_q.bias"]),
        "pool_lnk_scale": _t(sd["attn_pool.ln_k.weight"]),
        "pool_lnk_bias": _t(sd["attn_pool.ln_k.bias"]),
    })
    return base


def convert_eva_visual(state_dict: Mapping, cfg: VitConfig) -> dict:
    """BAAI EVA / open_clip 'visual.*' EVA state dict (timm ``blocks.N.*``
    naming) → flat params (JAX ``convert_eva_visual``,
    models/clip_weights.py:252-356): separate q/k/v projections where only q
    and v carry biases (k's is zero-filled), or a fused ``attn.qkv`` with
    bare ``q_bias``/``v_bias``; the ``inner_attn_ln`` sub-LN; a SwiGLU MLP
    (``mlp.w1``/``w2``/``w3`` or fused ``w12``) with its ``ffn_ln``, w1‖w2
    packed into one fc1, or EVA01's plain ``mlp.fc1``/``fc2``; the head as
    the projection (a non-zero head bias is refused); EVA02's q/k columns
    brought from interleaved to half-split RoPE pairs."""
    sd = _visual(state_dict)
    w = cfg.width
    swiglu = cfg.mlp_type == "swiglu"
    keys = list(_BLOCK_KEYS)
    if cfg.attn_inner_ln:
        keys += ["attn_ln_scale", "attn_ln_bias"]
    if swiglu:
        keys += ["ffn_ln_scale", "ffn_ln_bias"]
    blocks: dict[str, list] = {k: [] for k in keys}
    zeros = np.zeros((w,), np.float32)
    for i in range(cfg.layers):
        b = f"blocks.{i}."

        def get(k):
            return _t(sd[b + k])

        def first(*names, default=None):  # the first key present
            found = next((n for n in names if b + n in sd), None)
            if found is None and default is None:
                raise KeyError(f"{b}{names[0]}")
            return default if found is None else get(found)

        blocks["ln1_scale"].append(get("norm1.weight"))
        blocks["ln1_bias"].append(get("norm1.bias"))
        if b + "attn.qkv.weight" in sd:  # fused qkv + bare q/v bias params
            qkv_w = get("attn.qkv.weight").T
            qb, vb = first("attn.q_bias", default=zeros), first("attn.v_bias", default=zeros)
        else:  # separate projections; k has no bias
            qkv_w = np.concatenate([get(f"attn.{n}_proj.weight").T for n in ("q", "k", "v")],
                                   axis=1)
            qb = first("attn.q_proj.bias", "attn.q_bias")
            vb = first("attn.v_proj.bias", "attn.v_bias")
        blocks["qkv_kernel"].append(qkv_w)
        blocks["qkv_bias"].append(np.concatenate([qb, zeros, vb]))
        if cfg.attn_inner_ln:
            blocks["attn_ln_scale"].append(get("attn.inner_attn_ln.weight"))
            blocks["attn_ln_bias"].append(get("attn.inner_attn_ln.bias"))
        blocks["out_kernel"].append(get("attn.proj.weight").T)
        blocks["out_bias"].append(get("attn.proj.bias"))
        blocks["ln2_scale"].append(get("norm2.weight"))
        blocks["ln2_bias"].append(get("norm2.bias"))
        if swiglu:
            if b + "mlp.w12.weight" in sd:  # fused w1‖w2 (row-stacked in torch)
                fc1_w, fc1_b = get("mlp.w12.weight").T, get("mlp.w12.bias")
            else:
                fc1_w = np.concatenate([get("mlp.w1.weight").T, get("mlp.w2.weight").T], axis=1)
                fc1_b = np.concatenate([get("mlp.w1.bias"), get("mlp.w2.bias")])
            blocks["fc1_kernel"].append(fc1_w)
            blocks["fc1_bias"].append(fc1_b)
            blocks["ffn_ln_scale"].append(get("mlp.ffn_ln.weight"))
            blocks["ffn_ln_bias"].append(get("mlp.ffn_ln.bias"))
            blocks["fc2_kernel"].append(get("mlp.w3.weight").T)
            blocks["fc2_bias"].append(get("mlp.w3.bias"))
        else:  # EVA01 / EVA02-E: timm's plain Mlp
            blocks["fc1_kernel"].append(get("mlp.fc1.weight").T)
            blocks["fc1_bias"].append(get("mlp.fc1.bias"))
            blocks["fc2_kernel"].append(get("mlp.fc2.weight").T)
            blocks["fc2_bias"].append(get("mlp.fc2.bias"))
    out = {
        "patch_kernel": _conv_to_patch_kernel(sd["patch_embed.proj.weight"]),
        "patch_bias": _t(sd["patch_embed.proj.bias"]),
        "class_emb": _t(sd["cls_token"]).reshape(-1),
        "pos_emb": _t(sd["pos_embed"]).reshape(-1, w),
        "ln_post_scale": _t(sd["norm.weight"]),
        "ln_post_bias": _t(sd["norm.bias"]),
        **{f"blocks/{k}": np.stack(v) for k, v in blocks.items()},
    }
    if "head.weight" in sd:  # a Linear head to the CLIP embedding dim
        out["proj"] = _t(sd["head.weight"]).T
        if "head.bias" in sd and np.abs(_t(sd["head.bias"])).max() > 0:
            # the readout has no projection bias; EVA's CLIP heads have none
            raise ValueError("EVA head.bias is non-zero — unsupported")
    elif "proj" in sd:
        out["proj"] = _t(sd["proj"])
    return rope_interleaved_to_half(out, cfg) if cfg.use_rope2d else out


def convert_torch_state_dict(state_dict: Mapping, cfg: VitConfig) -> dict:
    """A torch checkpoint → flat params, the converter picked as the JAX
    package's ``convert_torch_state_dict`` (models/clip_weights.py:543-575)
    picks it for the ViT-trunk towers."""
    keys = list(state_dict.keys())
    if any(k.endswith("head.probe") for k in keys) or cfg.pool == "map":
        # SigLIP's HF layout also starts with vision_model. — check first
        return convert_siglip_visual(state_dict, cfg)
    if any(k.startswith("vision_model.") for k in keys):
        return convert_hf_clip_vision(state_dict, cfg)
    if any(k.endswith("blocks.0.norm1.weight") for k in keys):
        # EVA trunks use timm-style 'blocks.N.' naming (never 'resblocks')
        return convert_eva_visual(state_dict, cfg)
    if any("attn_pool.ln_q." in k for k in keys) or cfg.pool == "coca":
        # CoCa's pooler (ln_q/ln_k exist in no other family) — before PE,
        # whose pooler also lives under 'attn_pool.'
        return convert_coca_visual(state_dict, cfg)
    if any("attn_pool." in k for k in keys) or cfg.pool == "attn":
        return convert_pe_visual(state_dict, cfg)
    if any("resblocks" in k for k in keys):
        return convert_open_clip_visual(state_dict, cfg)
    raise ValueError(
        "Unrecognized checkpoint layout; the port converts HF CLIP, HF SigLIP, PE, "
        "CoCa, EVA and open_clip/OpenAI ViT checkpoints (the ResNet and ConvNeXt "
        "towers are not ported yet)"
    )


def save_params_npz(path: str, params: Mapping) -> None:
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in flatten_params(params).items()}
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def _tensor(v, device) -> torch.Tensor:
    t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v))
    return t.to(device)


_POOL_KEYS = ("pool_probe", "pool_in_kernel", "pool_in_bias", "pool_out_kernel",
              "pool_out_bias", "pool_ln_scale", "pool_ln_bias")
_MAP_KEYS = _POOL_KEYS + ("pool_fc1_kernel", "pool_fc1_bias", "pool_fc2_kernel",
                          "pool_fc2_bias")
_COCA_KEYS = ("pool_query", "pool_q_kernel", "pool_k_kernel", "pool_v_kernel",
              "pool_in_bias", "pool_out_kernel", "pool_out_bias", "pool_lnq_scale",
              "pool_lnq_bias", "pool_lnk_scale", "pool_lnk_bias")


def _block_keys(cfg: VitConfig) -> list[str]:
    """The per-layer leaves a block of this config needs."""
    keys = list(_BLOCK_KEYS)
    if cfg.attn_inner_ln:
        keys += ["attn_ln_scale", "attn_ln_bias"]
    if cfg.mlp_type == "swiglu":
        keys += ["ffn_ln_scale", "ffn_ln_bias"]
    return keys


def _top_keys(cfg: VitConfig) -> list[str]:
    """The non-block leaves a tower of this config needs."""
    keys = ["patch_kernel", "pos_emb", "ln_post_scale", "ln_post_bias"]
    if cfg.use_cls_token:
        keys.append("class_emb")
    if cfg.use_ln_pre:
        keys += ["ln_pre_scale", "ln_pre_bias"]
    if cfg.use_proj:
        keys.append("proj")
    if cfg.patch_bias:
        keys.append("patch_bias")
    if cfg.use_rope2d:  # params must say which RoPE pairing their q/k columns use
        keys.append("rope_half")
    keys += {"map": _MAP_KEYS, "attn": _POOL_KEYS, "coca": _COCA_KEYS}.get(cfg.pool, ())
    return keys


def module_from_params(params: Mapping, cfg: VitConfig,
                       device: torch.device | str = "cpu") -> VisionTransformer:
    """Flat (or JAX-nested) params → the port's VisionTransformer on
    ``device``. Float leaves keep their dtype; int8 block kernels
    ([L, in, out]) are stored per layer as contiguous [out, in];
    ``blocks/act_amax`` and ``blocks/qkv_amax`` leaves (a calibrated pytree)
    are attached as they are. An int8 kernel's K is padded to
    ``ops/quant.K_ALIGN`` with zero columns (``ops/quant.pad_k``). A RoPE
    tower's params must carry the ``rope_half`` marker
    (:func:`ensure_rope_half` adds it to older ones)."""
    flat = flatten_params(params)
    top, stacked = {}, {}
    for k, v in flat.items():
        if k.startswith("blocks/"):
            stacked[k[len("blocks/"):]] = v
        else:
            top[k] = _tensor(v, device)
    missing = [k for k in _top_keys(cfg) if k not in top]
    missing += [f"blocks/{k}" for k in _block_keys(cfg) if k not in stacked]
    if missing:
        raise KeyError(f"params lack {missing} for {cfg}")
    blocks = []
    for i in range(cfg.layers):
        blk = {}
        for name, v in stacked.items():
            t = _tensor(v[i], device)
            if name.endswith("_kernel") and t.dtype == torch.int8:
                t = pad_k(t.t().contiguous())
            blk[name] = t
        blocks.append(blk)
    return VisionTransformer(cfg, top, blocks)


def params_from_module(model: VisionTransformer) -> dict[str, np.ndarray]:
    """The module's state back in the flat ``.npz`` layout (int8 block
    kernels without their K padding, transposed back to [L, in, out])."""
    cfg = model.cfg
    out = {k: v.detach().cpu().numpy() for k, v in model.named_buffers()
           if not k.startswith("blocks.")}
    names = [k for k, _ in model.blocks[0].named_buffers()]
    for name in names:
        layers = []
        for blk in model.blocks:
            t = getattr(blk, name).detach().cpu()
            if name.endswith("_kernel") and t.dtype == torch.int8:
                t = t[:, : cfg.mlp_dim if name == "fc2_kernel" else cfg.width].t()
            layers.append(t.numpy())
        out[f"blocks/{name}"] = np.stack(layers)
    return out
