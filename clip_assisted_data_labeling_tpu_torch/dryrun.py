"""The flagship step and the multi-device dry run (port of the JAX package's
``__graft_entry__.py``).

``entry(device)`` returns the flagship embed step — uint8 canvases → the 4
crops → ViT-L-14/openai in bfloat16 (random weights from a seed) →
L2-normalized embeddings [B, 4, 768] — with its example args.

``dryrun_multichip(n_devices, device)`` runs the framework's multi-device
sequence on tiny towers over a mesh of ``parallel/``, each step held against
the one-device run:

  1. data-parallel embedding (ViT-Test/tiny, bfloat16); where n is even and
     at least 4, on an (n/2, 2) mesh with tensor parallelism
     (``parallel/tp.py``), then int8_static tensor parallelism
     (``parallel/tp_static.py``) for ViT-Test/tiny and EVA-Test-Wide/tiny,
     each ``torch.equal`` to the one-device forward; then the post-norm
     tower (EVA-Test-Post/tiny) data-parallel in int8_static,
  2. the ring dedup over the mesh, recovering exactly one planted pair,
  3. a data-parallel regressor SGD step: each shard's forward and backward
     on its rows, the gradients summed with ``parallel/mesh.psum``, one step
     at lr 0.01 (:func:`dp_sgd_step`),
  4. data-parallel prediction (``predict_sharded``, float32 wire) with the
     stepped weights against the one-device forward.

The mesh takes n distinct cards where the machine has them; otherwise it
lists the one card n times (its shards run one after another) and says so.
``device="cpu"`` lists the CPU n times. Without a card and without
``device="cpu"`` it raises: there is no fall back to the CPU.

    python -m clip_assisted_data_labeling_tpu_torch.dryrun --n_devices 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.clip_weights import module_from_params
from clip_assisted_data_labeling_tpu_torch.models.regressor import RegressorMeta, SimpleFCRegressor
from clip_assisted_data_labeling_tpu_torch.models.vit import (
    attach_act_amax,
    block_route,
    init_vit_params,
    resolve_config,
    vit_act_amax,
    vit_encode_image,
)
from clip_assisted_data_labeling_tpu_torch.ops.crops import (
    fused_crop_resize_normalize,
    make_crop_params,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_vit_params
from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
    find_duplicate_pairs_sharded,
)
from clip_assisted_data_labeling_tpu_torch.parallel.embed_sharded import ShardedEmbedder
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    get_mesh_2d,
    psum,
    shard_batch,
)
from clip_assisted_data_labeling_tpu_torch.parallel.predict_sharded import (
    net_from_params,
    predict_sharded,
)
from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import (
    place_tp_static,
    vit_encode_tp_static,
)
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

FLAGSHIP = "ViT-L-14/openai"
TINY, EVA_WIDE, POST = "ViT-Test/tiny", "EVA-Test-Wide/tiny", "EVA-Test-Post/tiny"
SGD_LR = 0.01
REGRESSOR_HIDDEN = (16, 8)


class DryRunError(RuntimeError):
    """A dry-run step disagreed with its one-device run."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise DryRunError(msg)


def _example_batch(batch: int, canvas: int, out_size: int, seed: int = 0):
    """``batch`` random uint8 canvases and their crop params, drawn with
    numpy as the JAX package's ``__graft_entry__._example_batch`` draws
    them."""
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (batch, canvas, canvas, 3)).astype(np.uint8)
    sizes = [(int(rng.integers(canvas // 2, canvas)), int(rng.integers(canvas // 2, canvas)))
             for _ in range(batch)]
    params = np.stack([make_crop_params(w, h, canvas, out_size) for w, h in sizes])
    return canvases, params.astype(np.float32)


def example_args() -> tuple[np.ndarray, np.ndarray]:
    """The flagship step's example canvases and crop params: two 512²
    canvases for the tower's 224-pixel crops."""
    return _example_batch(2, 512, resolve_config(FLAGSHIP).image_size)


def _tower(name: str, seed: int, device, quantized: bool = False):
    """The port's tower module of ``name`` with random weights from
    ``seed`` (W8A8 where ``quantized``) on ``device``."""
    cfg = resolve_config(name)
    params = init_vit_params(cfg, torch.Generator().manual_seed(seed))
    if quantized:
        params = quantize_vit_params(params)
    return module_from_params(params, cfg, device)


def _crops(model, canvas_u8, crop_params, dtype) -> torch.Tensor:
    """[B, C, C, 3] uint8 + [B, n, 2, 4] → flat [B·n, R, R, 3] crops on the
    tower's device."""
    cfg = model.cfg
    dev = model.ln_post_scale.device
    crops = fused_crop_resize_normalize(
        torch.as_tensor(canvas_u8).to(dev), torch.as_tensor(crop_params).to(dev),
        out_size=cfg.image_size, parity=False, dtype=dtype, mean=cfg.norm_mean,
        std=cfg.norm_std)
    return crops.reshape((-1,) + crops.shape[2:])


def embed_step(model, canvas_u8, crop_params) -> torch.Tensor:
    """The flagship step: the 4 crops in bfloat16, the tower in bfloat16 →
    [B, n_crops, embed_dim] float32 L2-normalized embeddings."""
    b, n = crop_params.shape[:2]
    emb = vit_encode_image(model, _crops(model, canvas_u8, crop_params, torch.bfloat16),
                           torch.bfloat16)
    return emb.reshape(b, n, -1)


def entry(device: str | torch.device = "cuda"):
    """(step, example_args): :func:`embed_step` and (the ViT-L-14/openai
    tower with random weights from seed 0 on ``device``, then
    :func:`example_args`)."""
    dev = resolve_device(device)
    return embed_step, (_tower(FLAGSHIP, 0, dev), *example_args())


def mesh_devices(n_devices: int, device: str | torch.device = "cuda") -> list[torch.device]:
    """n distinct cards where there are that many; else the one card (or
    the CPU) listed n times, which the dry run says."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    if dev.index is None and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    card = dev if dev.index is not None else torch.device("cuda", 0)
    print(f"[dryrun] {torch.cuda.device_count()} card(s) for {n_devices} devices — the mesh "
          f"lists {card} {n_devices} times (its shards run one after another)")
    return [card] * n_devices


def regressor_params(feat_dim: int, seed: int = 1) -> list[dict]:
    """A fresh regressor (hidden ``REGRESSOR_HIDDEN``, ``nn.Linear``'s
    initialization from a CPU generator seeded by ``seed``) in the JAX
    layout: one ``{"kernel": [in, out], "bias": [out]}`` a layer."""
    meta = RegressorMeta(clip_models=(TINY,), crop_names=("centre_crop",),
                         input_size=feat_dim, hidden_sizes=REGRESSOR_HIDDEN)
    return SimpleFCRegressor.create(meta, seed, "cpu").params()


def dp_sgd_step(params: list[dict], x: np.ndarray, y: np.ndarray, mesh: Mesh,
                lr: float = SGD_LR) -> tuple[list[dict], float]:
    """One data-parallel SGD step of the regressor (sigmoid head, no
    dropout) on the mean squared error over all N rows: each device's
    shard runs its forward and backward of Σ_shard (out − y)² / N, the
    gradients (and losses) are summed over the shards with
    :func:`parallel.mesh.psum` on the first device, and each weight takes
    ``w − lr·g`` there. Returns (the stepped params in the JAX layout as
    float32 numpy, the loss)."""
    n = len(x)
    devs = mesh.local_devices("data")
    grads, losses = [], []
    for dev, xs, ys in zip(devs, shard_batch(mesh, torch.from_numpy(np.asarray(x, np.float32))),
                           shard_batch(mesh, torch.from_numpy(np.asarray(y, np.float32)))):
        net = net_from_params(params, dev)
        loss = torch.sum((net(xs)[:, 0] - ys) ** 2) / n
        loss.backward()
        grads.append([(lin.weight.grad, lin.bias.grad) for lin in net.linears])
        losses.append(loss.detach())
    first = devs[0]
    new = []
    for i, p in enumerate(params):
        gw = psum([g[i][0] for g in grads], first)
        gb = psum([g[i][1] for g in grads], first)
        w = torch.from_numpy(np.asarray(p["kernel"], np.float32).T.copy()).to(first)
        b = torch.from_numpy(np.asarray(p["bias"], np.float32)).to(first)
        new.append({"kernel": (w - lr * gw).cpu().numpy().T.copy(),
                    "bias": (b - lr * gb).cpu().numpy()})
    return new, float(psum(losses, first))


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return np.sum(a * b, axis=-1)


def _match(got: np.ndarray, ref: np.ndarray, label: str, min_cos: float, atol: float) -> dict:
    cos = _cos(got, ref)
    diff = float(np.abs(got - ref).max())
    _check(bool(np.all(cos > min_cos)) and diff <= atol,
           f"{label} diverges from the single-device output (min cosine {cos.min():.7f}, "
           f"max abs {diff:.3g})")
    return {"min_cos": float(cos.min()), "max_abs_diff": diff}


def _static_tower(name: str, seed: int, images: torch.Tensor):
    """A W8A8 tower calibrated on ``images`` (float32, act_amax only), and
    the compute dtype its int8_static blocks run in: bfloat16 where they take
    the lnk route (its qkv is bf16), else float32."""
    model = _tower(name, seed, images.device, quantized=True)
    amax = vit_act_amax(model, images, torch.float32)
    attach_act_amax(model, {"act_amax": amax["act_amax"]})
    lnk = block_route(model.blocks[0], model.cfg,
                      object() if model.cfg.use_rope2d else None) == "lnk"
    return model, (torch.bfloat16 if lnk else torch.float32)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """Run the dry run's sequence (module docstring) over ``n_devices``;
    raises :class:`DryRunError` at the first step that disagrees with its
    one-device run. Returns each step's figures."""
    devs = mesh_devices(n_devices, device)
    mesh = get_mesh(devices=devs)
    first = devs[0]
    figures: dict = {"n_devices": n_devices, "devices": [str(d) for d in devs]}
    model = _tower(TINY, 0, first)
    cfg = model.cfg

    # ---- 1. the embedding forward: dp over the batch (+ tp on a 2-D mesh) ----
    batch = 2 * n_devices
    canvases, crop_params = _example_batch(batch, 128, cfg.image_size)
    ref_emb = embed_step(model, canvases, crop_params).cpu().numpy()

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = get_mesh_2d(n_devices // 2, 2, devices=devs)
        emb = ShardedEmbedder(model, cfg, mesh2, compute_dtype=torch.bfloat16).embed(
            canvases, crop_params)
        print(f"[dryrun] dp+tp embed over {mesh2.shape}: {tuple(emb.shape)}")
        emb_np = emb.cpu().numpy()
        label = f"dp+tp {mesh2.shape}"
        figures["embed"] = {"path": label, **_match(emb_np, ref_emb, label, 0.999, 2e-2)}
        print(f"[dryrun] {label} matches single-device output "
              f"(min cos {figures['embed']['min_cos']:.6f})")

        # ---- 1b. tensor-parallel int8_static: bit for bit the one device ----
        flat = _crops(model, canvases, crop_params, torch.float32)
        smodel, dt = _static_tower(TINY, 0, flat)
        single = vit_encode_image(smodel, flat.to(dt), dt)
        tp = vit_encode_tp_static(place_tp_static(smodel, mesh2, cfg), flat.to(dt), dt)
        figures["tp_static_equal"] = bool(torch.equal(tp, single))
        _check(figures["tp_static_equal"],
               "TP int8_static diverges from the single-device static forward")
        print(f"[dryrun] tp int8_static over {mesh2.shape}: BIT-identical "
              "to single-device int8_static")

        # ---- 1c. EVA02 (swiglu + sub-LN + rope) tensor-parallel int8_static;
        # at least 2 rows a data row, as the JAX dry run keeps
        ecfg = resolve_config(EVA_WIDE)
        tiny = torch.randn((max(4, n_devices), ecfg.image_size, ecfg.image_size, 3),
                           generator=torch.Generator().manual_seed(4)).to(first)
        emodel, dt = _static_tower(EVA_WIDE, 3, tiny)
        eva_single = vit_encode_image(emodel, tiny.to(dt), dt, normalize=False)
        eva_tp = vit_encode_tp_static(place_tp_static(emodel, mesh2, ecfg), tiny.to(dt), dt,
                                      normalize=False)
        figures["eva_tp_static_equal"] = bool(torch.equal(eva_tp, eva_single))
        _check(figures["eva_tp_static_equal"],
               "EVA02 TP int8_static diverges from the op-by-op single-device forward")
        print(f"[dryrun] EVA02 tp int8_static over {mesh2.shape}: "
              "BIT-identical to the op-faithful single-device forward")
    else:
        emb = ShardedEmbedder(model, cfg, mesh, compute_dtype=torch.bfloat16).embed(
            canvases, crop_params)
        print(f"[dryrun] dp embed over {mesh.shape}: {tuple(emb.shape)}")
        emb_np = emb.cpu().numpy()
        label = f"dp {mesh.shape}"
        figures["embed"] = {"path": label, **_match(emb_np, ref_emb, label, 0.999, 2e-2)}
        print(f"[dryrun] {label} matches single-device output "
              f"(min cos {figures['embed']['min_cos']:.6f})")

    # ---- 1d. post-norm (EVA02-E structure) data-parallel int8_static ---------
    pcfg = resolve_config(POST)
    tiny_p = torch.randn((2 * n_devices, pcfg.image_size, pcfg.image_size, 3),
                         generator=torch.Generator().manual_seed(6)).to(first)
    pmodel, dt = _static_tower(POST, 5, tiny_p)
    single_post = vit_encode_image(pmodel, tiny_p.to(dt), dt).cpu().numpy()
    replicas: dict = {}
    parts = [vit_encode_image(replicas.setdefault(d, pmodel if d == first else
                                                  copy.deepcopy(pmodel).to(d)),
                              part.to(dt), dt).to(first)
             for d, part in zip(devs, shard_batch(mesh, tiny_p))]
    dp_post = torch.cat(parts).cpu().numpy()
    figures["post_norm"] = _match(dp_post, single_post, "post-norm dp int8_static", 0.9999, 1e-4)
    print(f"[dryrun] post-norm dp int8_static over {mesh.shape}: matches "
          f"single-device (min cos {figures['post_norm']['min_cos']:.7f})")

    # ---- 2. the ring dedup over the mesh, one planted pair ---------------------
    flat_emb = emb_np.reshape(-1, emb_np.shape[-1]).astype(np.float32)
    dup_a, dup_b = 0, len(flat_emb) - 1
    flat_emb[dup_b] = flat_emb[dup_a] + 1e-4 * np.random.default_rng(2).normal(
        size=flat_emb.shape[-1])
    flat_emb /= np.linalg.norm(flat_emb, axis=-1, keepdims=True)
    result = find_duplicate_pairs_sharded(flat_emb, threshold=0.999, mesh=mesh)
    pairs = sorted(zip(np.asarray(result.rows).tolist(), np.asarray(result.cols).tolist()))
    figures["ring_pairs"] = pairs
    _check(pairs == [(dup_a, dup_b)],
           f"ring dedup must recover exactly the planted pair ({dup_a},{dup_b}); got {pairs}")
    print(f"[dryrun] ring dedup over {mesh.shape}: recovered planted pair {pairs[0]}")

    # ---- 3. a data-parallel regressor SGD step --------------------------------
    feat_dim = emb_np.shape[-1] * 2
    params = regressor_params(feat_dim)
    x = np.random.default_rng(0).normal(0, 1, (batch, feat_dim)).astype(np.float32)
    y = np.random.default_rng(1).uniform(0, 1, (batch,)).astype(np.float32)
    stepped, loss = dp_sgd_step(params, x, y, mesh)
    one, one_loss = dp_sgd_step(params, x, y, get_mesh(devices=[first]))
    sgd_diff = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(stepped, one)
                   for k in ("kernel", "bias"))
    figures["sgd"] = {"loss": loss, "one_device_loss": one_loss, "max_abs_diff": sgd_diff}
    _check(sgd_diff <= 1e-6 and abs(loss - one_loss) <= 1e-6,
           f"the data-parallel SGD step diverges from the one-device step ({sgd_diff:.3g})")
    print(f"[dryrun] dp train step over {mesh.shape}: loss={loss:.4f}")

    # ---- 4. data-parallel prediction with the stepped params ------------------
    with torch.no_grad():
        single_scores = net_from_params(stepped, first)(
            torch.from_numpy(x).to(first))[:, 0].cpu().numpy()
    sharded_scores = predict_sharded(stepped, x, mesh, wire="float32")
    pred_diff = float(np.abs(sharded_scores - single_scores).max())
    figures["predict_max_abs_diff"] = pred_diff
    _check(pred_diff <= 1e-6, "sharded predict diverges from the single-device forward")
    print(f"[dryrun] dp predict over {mesh.shape}: matches single-device")
    print(f"[dryrun] OK on {n_devices} devices")
    return figures


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n_devices", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
