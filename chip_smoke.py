"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. print the card's name and power limit (nvidia-smi); no card → exit 2,
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes and time kernel, plain version, the PyTorch library
     yardstick and the roofline bound (CUDA events, warmed up),
  4. write 32 synthetic PNGs of mixed sizes from a seed,
  5. run the port's embed CLI on them: ViT-L-14-336/openai, int8_static,
     batch 8, full width and depth (24 layers), random weights from the
     model name — with the kernel launch counters zeroed just before,
  6. check sidecars, store and .calib.npz, finite unit-norm embeddings, and
     that the launch counters equal layers × forwards; then time the same
     device work in steady state and profile one batch by kernel,
  7. run a few images through the float32 path (K1 in float32) and print the
     cosine against the int8_static embeddings,
then print one JSON line listing the kernels and, last, the device line.

Imports torch and the port only, never JAX.
"""
from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 (NVIDIA data sheet, SXM, 700 W)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES = 3.35e12  # HBM3 bytes/s
MODEL = "ViT-L-14-336/openai"
N_IMAGES, BATCH = 32, 8
K1_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/packed_attention.cu"
K2_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/rowquant_static.cu"
K1_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:860"
K2_TPU = "clip_assisted_data_labeling_tpu/ops/quant_kernel.py:410"


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(code)


def time_ms(fn, min_reps: int = 10, min_s: float = 0.2) -> float:
    """Mean milliseconds per call on the card: two warm-up calls, then CUDA
    events around a run of calls (at least min_reps, at least ~min_s)."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    reps = max(min_reps, int(min_s / one))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(gen: torch.Generator) -> list[dict]:
    """Phase 3: every kernel against its plain version at the main path's
    shapes, with times. Launches here are comparisons and are not counted
    (the counters are zeroed before the main path)."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        fused_attention_packed,
        fused_attention_packed_plain,
    )
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        rowquant_static,
        rowquant_static_plain,
    )

    rows = []
    heads, w = 16, 1024
    d = w // heads
    bf16, f32 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS), (torch.float32, 1e-5, H100_F32_FLOPS)
    # the main path's own shape first (BATCH images x 4 crops of ViT-L-14-336),
    # then the CLI's 64-crop forwards of ViT-L-14-336 and ViT-L-14 (224)
    for b, s, (dtype, tol, peak) in ((4 * BATCH, 577, bf16), (64, 577, bf16), (64, 577, f32),
                                     (64, 257, bf16), (64, 257, f32)):
        qkv = torch.randn((b, s, 3 * w), generator=gen, device="cuda").to(dtype)
        got = fused_attention_packed(qkv, heads, d ** -0.5)
        ref = fused_attention_packed_plain(qkv, heads, d ** -0.5)
        err = (got.float() - ref.float()).abs().max().item()
        del got, ref
        q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                   for t in qkv.split(w, dim=-1))
        flops = 4.0 * b * heads * s * s * d
        nbytes = b * s * 4 * w * qkv.element_size()  # qkv read once, out written once
        row = {
            "name": "packed_attention", "route": "cuda", "source": K1_SRC,
            "replaces": K1_TPU, "case": f"{str(dtype)[6:]} [{b},{s},{3 * w}] h={heads}",
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: fused_attention_packed(qkv, heads, d ** -0.5)),
            "plain_ms": time_ms(lambda: fused_attention_packed_plain(qkv, heads, d ** -0.5),
                                min_reps=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)),
            "bound_ms": 1e3 * max(flops / peak, nbytes / H100_BYTES),
            "bound_by": "operations" if flops / peak > nbytes / H100_BYTES else "bytes",
        }
        rows.append(row)
        print(f"K1 {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del qkv, q, k, v
        torch.cuda.empty_cache()

    k = 1024
    g = 1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
    bta = 0.1 * torch.randn((k,), generator=gen, device="cuda")
    amax = torch.tensor([6.0], device="cuda")
    inv = torch.tensor(127.0) / amax
    for m in (4 * BATCH * 577, 64 * 577):  # the main path's rows, then the CLI's
        x = (torch.randn((m, k), generator=gen, device="cuda") * 2).to(torch.bfloat16)
        diff = (rowquant_static(x, g, bta, amax).int()
                - rowquant_static_plain(x, g, bta, amax).int()).abs()

        def library():
            y = F.layer_norm(x.float(), (k,), g, bta, 1e-5)
            return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)

        nbytes = m * k * (x.element_size() + 1) + 2 * k * 4
        flops = 10.0 * m * k
        row = {
            "name": "rowquant_static", "route": "cuda", "source": K2_SRC, "replaces": K2_TPU,
            "case": f"bfloat16 [{m},{k}]", "max_abs_err": diff.max().item(), "tol": 1,
            "flip_share": (diff > 0).float().mean().item(),
            "ms": time_ms(lambda: rowquant_static(x, g, bta, amax)),
            "plain_ms": time_ms(lambda: rowquant_static_plain(x, g, bta, amax)),
            "library_ms": time_ms(library),
            "bound_ms": 1e3 * max(flops / H100_F32_FLOPS, nbytes / H100_BYTES),
            "bound_by": "operations" if flops / H100_F32_FLOPS > nbytes / H100_BYTES else "bytes",
        }
        rows.append(row)
        print(f"K2 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
              f"of entries, kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} "
              f"ln+quant {row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms", flush=True)
        if row["flip_share"] > 1e-3:
            fail(f"rowquant_static {row['case']}: ±1 flips on {row['flip_share']:.2e} of "
                 "entries (> 1e-3)")
        del x, diff
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


def profile_int8_static(root: str, calib: str, cfg) -> None:
    """The main path's device work again, steady state: the int8_static
    encoder with the saved calibration, all batches decoded up front, then
    (a) wall time over every batch (crops + ViT + image stats, H2D included,
    decode excluded) and (b) a torch.profiler trace of one batch, summed by
    kernel name. Its launches are counted on their own."""
    from torch.profiler import ProfilerActivity, profile

    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader, find_images
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.ops.attention import fused_attention_packed
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import image_stats_batch
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import rowquant_static

    enc = CLIPImageEncoder(MODEL, compute_dtype="int8_static", calibration_path=calib,
                           device="cuda")
    if not enc.load_calibration():
        fail("the saved calibration did not load")
    batches = list(BatchedImageLoader(find_images(root), canvas_size=1024,
                                      out_size=cfg.image_size, batch_size=BATCH,
                                      num_workers=4, bucketed=True, sort_by_size=True))

    def run(batch):
        canvas = torch.from_numpy(batch.canvas).to("cuda")
        emb = enc.embed_crops(canvas, batch.crop_params)
        with torch.inference_mode():
            stats = image_stats_batch(canvas, torch.from_numpy(batch.stat_params))
        return emb, stats

    run(batches[0])
    torch.cuda.synchronize()
    fused_attention_packed.launches = rowquant_static.launches = 0
    t0 = time.perf_counter()
    for b in batches:
        run(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_attention_packed.launches, rowquant_static.launches
    if (k1, k2) != (cfg.layers * len(batches), 2 * cfg.layers * len(batches)):
        fail(f"steady-state launches K1 {k1} K2 {k2} for {len(batches)} batches")
    n = sum(b.n_valid for b in batches)
    print(f"steady state: {n} images x 4 crops in {wall * 1e3:.1f} ms = {n / wall:.2f} imgs/s "
          f"({len(batches)} batches of {BATCH}, canvas buckets "
          f"{sorted({b.canvas.shape[1] for b in batches})})", flush=True)

    try:  # the trace is a reading aid: a profiler that cannot trace the card is reported
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(batches[-1])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    except Exception as e:  # noqa: BLE001
        print(f"profile: torch.profiler failed ({e!r}); no per-kernel breakdown", flush=True)
        events = []
    total = sum(e.self_device_time_total for e in events)
    print(f"profile of one batch ({BATCH} images, 4 crops, S={cfg.seq_len}): device time "
          f"{total / 1e3:.2f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / max(total, 1):5.1f}% x{e.count:<4d} {e.key[:100]}",
              flush=True)
    del enc, batches
    torch.cuda.empty_cache()


def write_pngs(directory: str, seed: int = 0) -> None:
    """Phase 4: N_IMAGES smooth-plus-noise RGB PNGs of mixed sizes."""
    from clip_assisted_data_labeling_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for i in range(N_IMAGES):
        w, h = (int(v) for v in rng.integers(180, 1000, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 40.0 * (i % 6))], -1)
        img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(os.path.join(directory, f"img_{i:03d}.png"), img)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False — this smoke run needs an NVIDIA card", 2)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}", 2)
    print(smi.splitlines()[0], flush=True)
    try:
        from clip_assisted_data_labeling_tpu_torch.data.loader import decoder_name
        from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config
        from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build
        from clip_assisted_data_labeling_tpu_torch.ops.attention import fused_attention_packed
        from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import rowquant_static
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    if any(m == "jax" or m.startswith(("jax.", "clip_assisted_data_labeling_tpu."))
           or m == "clip_assisted_data_labeling_tpu" for m in sys.modules):
        fail("JAX or the JAX package was imported")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; image decoder: {decoder_name()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _cuda_build.build_all()
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {regs}")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 3: kernels against their plain versions ----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_kernels(gen)
    torch.cuda.empty_cache()

    cfg = resolve_config(MODEL)
    n_batches = math.ceil(N_IMAGES / BATCH)
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        write_pngs(root)

        # --- phase 5: the main path through the user's entry point ------------
        fused_attention_packed.launches = 0
        rowquant_static.launches = 0
        t0 = time.perf_counter()
        stores = embed_main(["--root_dir", root, "--models_to_use", MODEL,
                             "--compute_dtype", "int8_static", "--batch_size", str(BATCH),
                             "--num_workers", "4", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = fused_attention_packed.launches, rowquant_static.launches

        # --- phase 6: outputs and counters --------------------------------------
        # int8_static: one calibration forward (K1 per layer, dynamic matmuls)
        # then one forward per batch (K1 once and K2 twice per layer)
        want_k1 = cfg.layers * (n_batches + 1)
        want_k2 = 2 * cfg.layers * n_batches
        print(f"main path: {N_IMAGES} images x 4 crops in {wall:.2f} s "
              f"({N_IMAGES / wall:.2f} imgs/s incl. model init and calibration, "
              f"{smi.splitlines()[0]}); launches K1 {k1} (want {want_k1}), "
              f"K2 {k2} (want {want_k2})", flush=True)
        if (k1, k2) != (want_k1, want_k2):
            fail(f"launch counters K1={k1} K2={k2}, expected {want_k1}/{want_k2}")
        rows = [dict(r, launches=k1 if r["name"] == "packed_attention" else k2) for r in rows]

        store = stores[MODEL]
        pts = sorted(glob.glob(os.path.join(root, "*.pt")))
        calib = os.path.join(root, MODEL.replace("/", "-") + ".calib.npz")
        if len(pts) != N_IMAGES or not os.path.exists(calib):
            fail(f"{len(pts)} sidecars (want {N_IMAGES}), calib exists: {os.path.exists(calib)}")
        reopened = EmbeddingStore.open(root, MODEL)
        emb = np.asarray(reopened.embeddings, np.float32)
        if emb.shape != (N_IMAGES, 4, cfg.embed_dim) or not np.asarray(reopened.valid).all():
            fail(f"store shape {emb.shape}, valid {np.asarray(reopened.valid).sum()}")
        side = np.stack([np.stack([read_sidecar(p)[MODEL][c].reshape(-1)
                                   for c in store.meta["crop_names"]]) for p in pts])
        norms = np.linalg.norm(side, axis=-1)
        stats = np.asarray(reopened.img_stats)
        if not (np.isfinite(side).all() and np.abs(norms - 1).max() < 1e-3
                and np.isfinite(stats).all()):
            fail(f"embeddings not finite unit vectors (norm range {norms.min()}..{norms.max()})")
        print(f"outputs: {len(pts)} sidecars, store {emb.shape}, calib "
              f"{os.path.basename(calib)}, |norm-1| max {np.abs(norms - 1).max():.2e}", flush=True)
        del stores, store, reopened
        torch.cuda.empty_cache()

        # --- phase 6b: steady state and where the device time goes ---------------
        profile_int8_static(root, calib, cfg)

        # --- phase 7: float32 path (K1 in float32) on a few images ---------------
        enc = CLIPImageEncoder(MODEL, compute_dtype="float32", device="cuda")
        first = pts[:4]
        loader = BatchedImageLoader([p[:-3] + ".png" for p in first], canvas_size=1024,
                                    out_size=cfg.image_size, batch_size=4, num_workers=4)
        fused_attention_packed.launches = 0
        rowquant_static.launches = 0
        batch = next(iter(loader))
        e32 = enc.embed_crops(batch.canvas, batch.crop_params)[: batch.n_valid].cpu().numpy()
        if (fused_attention_packed.launches, rowquant_static.launches) != (cfg.layers, 0):
            fail(f"float32 path launches K1 {fused_attention_packed.launches} K2 "
                 f"{rowquant_static.launches}, expected {cfg.layers}/0")
        order = [first.index(p[:-4] + ".pt") for p in batch.paths]
        cos = np.sum(e32 * side[order], axis=-1)
        print(f"float32 vs int8_static cosine over {cos.size} crops: min {cos.min():.5f} "
              f"mean {cos.mean():.5f}", flush=True)
        if not (np.isfinite(e32).all() and cos.min() > 0.95):
            fail(f"float32 and int8_static embeddings disagree (cosine min {cos.min()})")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
