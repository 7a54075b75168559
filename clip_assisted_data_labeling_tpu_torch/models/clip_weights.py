"""Weights in and out of the port (port of the JAX package's
``models/clip_weights.py`` for the plain CLIP and the SigLIP towers).

  * ``save_params_npz`` / ``load_params_npz``: the JAX package's native
    ``.npz`` layout — top-level leaves by name, block leaves as
    ``blocks/<name>`` stacked ``[L, …]`` — so either package reads the other's
    file,
  * ``convert_open_clip_visual`` / ``convert_hf_clip_vision`` /
    ``convert_siglip_visual``: torch checkpoints (open_clip/OpenAI
    ``visual.*``, HF ``CLIPVisionModelWithProjection`` and HF
    ``SiglipVisionModel``) → that flat layout,
  * ``module_from_params``: THE function that carries weights across — a flat
    dict of arrays (as the JAX package's params or ``.npz`` give them) becomes
    the port's module state. The ``[in, out]`` kernel convention stays, so
    ``x @ W`` means the same in both packages; only quantized int8 block
    kernels are stored transposed (``[out, in]``, the layout ``torch._int_mm``
    takes on the card). ``params_from_module`` goes back.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import VisionTransformer, VitConfig

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
        "class_emb": _t(sd["class_embedding"]),
        "pos_emb": _t(sd["positional_embedding"]),
        "ln_pre_scale": _t(sd["ln_pre.weight"]),
        "ln_pre_bias": _t(sd["ln_pre.bias"]),
        "ln_post_scale": _t(sd["ln_post.weight"]),
        "ln_post_bias": _t(sd["ln_post.bias"]),
        "proj": _t(sd["proj"]),
    }
    out.update({f"blocks/{k}": np.stack(v) for k, v in blocks.items()})
    return out


def convert_torch_state_dict(state_dict: Mapping, cfg: VitConfig) -> dict:
    keys = list(state_dict.keys())
    if any(k.endswith("head.probe") for k in keys) or cfg.pool == "map":
        # SigLIP's HF layout also starts with vision_model. — check first
        return convert_siglip_visual(state_dict, cfg)
    if any(k.startswith("vision_model.") for k in keys):
        return convert_hf_clip_vision(state_dict, cfg)
    if any("resblocks" in k for k in keys):
        return convert_open_clip_visual(state_dict, cfg)
    raise ValueError(
        "Unrecognized checkpoint layout; the port converts HF CLIP, HF SigLIP "
        "and open_clip/OpenAI plain-ViT checkpoints (other families not ported yet)"
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


_MAP_KEYS = ("pool_probe", "pool_in_kernel", "pool_in_bias", "pool_out_kernel",
             "pool_out_bias", "pool_ln_scale", "pool_ln_bias", "pool_fc1_kernel",
             "pool_fc1_bias", "pool_fc2_kernel", "pool_fc2_bias")


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
    if cfg.pool == "map":
        keys += _MAP_KEYS
    return keys


def module_from_params(params: Mapping, cfg: VitConfig,
                       device: torch.device | str = "cpu") -> VisionTransformer:
    """Flat (or JAX-nested) params → the port's VisionTransformer on
    ``device``. Float leaves keep their dtype; int8 block kernels
    ([L, in, out]) are stored per layer as contiguous [out, in];
    ``blocks/act_amax`` and ``blocks/qkv_amax`` leaves (a calibrated pytree)
    are attached as they are."""
    flat = flatten_params(params)
    top, stacked = {}, {}
    for k, v in flat.items():
        if k.startswith("blocks/"):
            stacked[k[len("blocks/"):]] = v
        elif k != "rope_half":
            top[k] = _tensor(v, device)
    missing = [k for k in _top_keys(cfg) if k not in top]
    missing += [f"blocks/{k}" for k in _BLOCK_KEYS if k not in stacked]
    if missing:
        raise KeyError(f"params lack {missing} for {cfg}")
    blocks = []
    for i in range(cfg.layers):
        blk = {}
        for name, v in stacked.items():
            t = _tensor(v[i], device)
            if name.endswith("_kernel") and t.dtype == torch.int8:
                t = t.t().contiguous()
            blk[name] = t
        blocks.append(blk)
    return VisionTransformer(cfg, top, blocks)


def params_from_module(model: VisionTransformer) -> dict[str, np.ndarray]:
    """The module's state back in the flat ``.npz`` layout (int8 block
    kernels transposed back to [L, in, out])."""
    out = {k: v.detach().cpu().numpy() for k, v in model.named_buffers()
           if not k.startswith("blocks.")}
    names = [k for k, _ in model.blocks[0].named_buffers()]
    for name in names:
        layers = []
        for blk in model.blocks:
            t = getattr(blk, name).detach().cpu()
            if name.endswith("_kernel") and t.dtype == torch.int8:
                t = t.t()
            layers.append(t.numpy())
        out[f"blocks/{name}"] = np.stack(layers)
    return out
