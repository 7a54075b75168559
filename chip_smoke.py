"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. print the card's name and power limit (nvidia-smi); no card → exit 2,
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print each kernel's registers and stack frame (ptxas), by name and
     template arguments (exact_wgmma_kernel<DP,PANELS,WIRE,out type>),
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes and time kernel, plain version, the PyTorch library
     yardstick and the roofline bound (CUDA events, warmed up; the float32
     kernels of K1, K4, K5 and K10 at a third of the TF32 rate, their 3xTF32
     products, with the float32 FMA bound beside it): K1 (also with
     PE's RoPE; f32 at ViT-L-14's float32 path; bf16 at S=576 beside
     ViT-L-14-336's 577, the cost of the one-key tail chunk), K2 (also at
     SO400M-384's [23328, 1152], and with its device time), K4
     (bf16 with RoPE at PE-Core-G14-448's shape, bf16 without RoPE at
     ViT-B-16-SigLIP-512's, f32 at the 336-pixel towers' float32 paths, with PE-Core-L14-336's RoPE
     there; the RoPE rows of K1 and K4 also time the torch rotation + SDPA),
     K5 (bf16, and f32 at SO400M-384's float32 path), K3 (at SO400M-384's
     shape and at the L-336 CTPU_INT8_WIRE=1 route's), and dynamic int8's K6
     (ln at [18464, 1024], quick_gelu at [18464, 4096], bf16 and f32 in; the
     quantize alone at K9's [9232, 1024] and [9232, 4096] and quant_out's
     f32 [18464, 1024]; SO400M-384's ln [23328, 1152] and gelu_tanh
     [23328, 4304]), K9 (ViT-L's four products at M = 18464 and 9232, each
     beside torch._int_mm alone) and K1's quant_out option, each also at the
     CLI's 64-crop shapes or others that no path here runs (K6's, K8's and
     K9's rows also with their device time from torch.profiler, each call
     after an L2 flush); then the
     kernels no path of the JAX package reaches: K8 at ViT-L's four block
     linears (M = 18464), K7 at int8 [32, 577, 3072] (bf16 and quant_out),
     K10 at [32|8, 16, 577, 64], and K5 with RoPE at PE-Core-G14-448's shape,
  3b. K1's and K7's quant_out scales against their plain versions at S = 729,
     2048, 8192 and 24000 (one head of 128): within 2^-8, int8 within ±1 on
     at most 5e-3 of entries, with the share of tokens over 1e-5 printed,
  4. write 32 synthetic PNGs of mixed sizes from a seed,
  5. run the port's embed CLI on them: ViT-L-14-336/openai, int8_static,
     batch 8, full width and depth (24 layers), random weights from the
     model name — with the kernel launch counters zeroed just before,
  6. check sidecars, store and .calib.npz, finite unit-norm embeddings, and
     that the launch counters equal layers × forwards (K1, K2; no K3, K5);
     then time the same device work in steady state and profile one batch,
  7. run a few images through the float32 path (K4 in float32: the JAX
     package's grouped route) and print the cosine against the int8_static
     embeddings; then ViT-L-14/openai (224 px, S=257) in float32 on them (K1
     in float32: the whole-block route) against the same encoder on the
     CPU (1 - cosine ≤ 1e-5), each with its steady ms per forward,
  7a. the embed CLI on copies of the PNGs in a fresh directory (the CLI skips
     images already embedded): ViT-L-14-336/openai in dynamic int8
     (--compute_dtype int8) with CTPU_INT8_BLOCK=hybrid, batch 8, full width
     and depth — K1 with quant_out once and K6 three times a layer, nothing
     else counted (K1's quant_out counts as one K1 launch: its row quantize
     runs K6's C entry inside it); no .calib.npz; the cosine against the
     int8_static embeddings; steady state and profile,
  7b. four images through CLIPImageEncoder(compute_dtype="int8") in the other
     routes, each with exact counters and the cosine against the hybrid
     embeddings: xla-plain (K1), xla (K1 with quant_out), xla-plain with
     CTPU_FUSED_QMATMUL=1 (K1 and K9 four times a layer); then the knobs
     are read again from the restored environment,
  8. the embed CLI again on the same PNGs: ViT-SO400M-14-SigLIP-384/webli,
     int8_static (the int8 attention wire: K3 in each of the 27 layers, no
     K1, K2 or K5), batch 8, full width and depth, random weights; check
     outputs and the .calib.npz's qkv_amax, steady state, profile,
  9. four images through its bfloat16 path (K5 in every layer): the cosine
     against the int8_static embeddings and the steady ms per forward,
  9a. four images through its float32 path (K5's float32 kernel in all 27
     layers, nothing else counted): the cosine against the int8_static
     embeddings, the steady ms per forward, and the first image against the
     same encoder on the CPU (1 - cosine ≤ 1e-5, with the CPU's seconds),
 10. the embed CLI on the same PNGs: PE-Core-L14-336, int8_static (K1 with
     RoPE once and K2 twice in each of the 24 layers; no K3, K4, K5), batch
     8, full width and depth, random weights; outputs, steady state, profile,
 11. four images through its bfloat16 path (K1 with RoPE in every layer) and
     its float32 path (K4 with RoPE in every layer), each against the
     int8_static embeddings and with its steady ms per forward,
 12. PE-Core-G14-448 in bfloat16 on four images at full width and all 50
     layers (K4 with RoPE in every layer, no K1): finite unit embeddings and
     the steady ms per forward,
 13. the int8_static routes of the two knobs that pick the block, each
     through the embed CLI on copies of four of the PNGs in a fresh
     directory, full width and depth, exact counters, cosine against the
     default route: ViT-L-14-336 with CTPU_LN_KERNEL=0 (the generic block
     with static scales: K1, no K2), ViT-L-14-336 with CTPU_INT8_WIRE=1 (the
     wire: K3, no K1 or K2), SO400M-384 with CTPU_INT8_WIRE=0 (lnk: K5 and
     K2, no K3),
 14. stage 2 (dedup, torch products: no kernel of the table) at N = 262,144
     embeddings of width 768 from a seed, with planted pairs and a group of
     40 near-identical rows (k escalates): find_duplicate_pairs over the
     int8 and the fp16 wire, each timed by part, against a plain float32
     route on the card — the same pair set, every planted pair, the same
     overflow rows; the euclidean metric at N = 32,768 likewise,
 15. the dedup CLI end to end: six of the PNGs and byte-identical copies of
     two, embedded by the embed CLI (ViT-L-14-336/openai, bfloat16), then
     ``python -m ...pipeline.dedup --threshold 0.99 --mode copy`` in its own
     process (no pandas, matplotlib or JAX imported): the planted pairs
     found, the pairs equal to the plain route's on the same store, every
     pair's file groups copied,
then print one JSON line with phase 14's records, one JSON line listing
the kernels, each row with its launches
read from the counter of the main path above that runs its case (0 for a
shape no path runs; K7, K8, K10 and K5 with RoPE, which no path of the JAX
package reaches, summed over all of them) and, last, the device line.

Imports torch and the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 (NVIDIA data sheet, SXM, 700 W)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_TF32_FLOPS = 494.7e12  # dense tensor-core TF32
# float32 products on the tensor cores as three TF32 mmas each (3xTF32): the
# bound of K1's, K4's, K5's and K10's float32 kernels
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_INT8_OPS = 1979e12  # dense tensor-core int8
H100_BYTES = 3.35e12  # HBM3 bytes/s
MODEL = "ViT-L-14-336/openai"
L14 = "ViT-L-14/openai"  # 224 px, S=257: its float32 block takes K1 (the JAX whole-block gate)
SIGLIP = "ViT-SO400M-14-SigLIP-384/webli"
SIGLIP_B512 = "ViT-B-16-SigLIP-512/webli"  # S=1024, 12 heads of 64: K4 in bf16, no RoPE
PE_L = "PE-Core-L14-336"
PE_G = "PE-Core-G14-448"
N_IMAGES, BATCH = 32, 8
K1_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/packed_attention.cu"
K2_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/rowquant_static.cu"
K3_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/packed_attention_q8s.cu"
K4_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/packed_attention_grouped.cu"
K5_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/flash_attention.cu"
K6_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/rowquant.cu"
K7_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/packed_attention_q8.cu"
K9_SRC = "clip_assisted_data_labeling_tpu_torch/csrc/q_linear_fused.cu"
K8_SRC = K9_SRC  # K8's GEMM is K9's with the epilogue extended
K10_SRC = K1_SRC  # K10 runs K1's kernels through unpacked strides
K1_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:860"
K2_TPU = "clip_assisted_data_labeling_tpu/ops/quant_kernel.py:410"
K3_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:746"
K4_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:166"
K5_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:441"
K6_TPU = "clip_assisted_data_labeling_tpu/ops/quant_kernel.py:327"
K7_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:619"
K8_TPU = "clip_assisted_data_labeling_tpu/ops/quant_kernel.py:138"
K9_TPU = "clip_assisted_data_labeling_tpu/ops/quant_kernel.py:34"
K10_TPU = "clip_assisted_data_labeling_tpu/ops/attention.py:25"


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(code)


def kernels() -> dict:
    """The kernel wrappers by table number; each counts its launches (K1
    with quant_out counts one K1 launch, its row quantize none)."""
    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        flash_attention_packed,
        fused_attention,
        fused_attention_packed,
        fused_attention_packed_grouped,
        fused_attention_packed_q8,
        fused_attention_packed_q8s,
    )
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        q_block_linear,
        q_linear_fused,
        rowquant,
        rowquant_static,
    )

    return {"K1": fused_attention_packed, "K2": rowquant_static,
            "K3": fused_attention_packed_q8s, "K4": fused_attention_packed_grouped,
            "K5": flash_attention_packed, "K6": rowquant, "K7": fused_attention_packed_q8,
            "K8": q_block_linear, "K9": q_linear_fused, "K10": fused_attention}


@contextlib.contextmanager
def int8_knobs(**env):
    """CTPU_* variables set and the port's knobs read again for the block;
    the environment restored and the knobs re-read after it."""
    from clip_assisted_data_labeling_tpu_torch.ops import knobs

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    knobs.reload()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        knobs.reload()


def counters() -> dict:
    """(wrapper, attribute) of each launch counter by table number; K5's
    launches with RoPE tables have a counter of their own besides K5's."""
    ks = kernels()
    return {**{k: (fn, "launches") for k, fn in ks.items()},
            "K5+RoPE": (ks["K5"], "rope_launches")}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


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


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
TRACE_PAD_S = 0.05  # host idle at each end of a device_ms trace


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Milliseconds of device time per call: the kernels that ``reps``
    calls launch, summed from a torch.profiler trace, without the host's
    time between them (a wrapper's checks and allocations, which bound the
    CUDA-event time of a kernel shorter than them). Before each call a row
    sum over a 256 MB buffer evicts the L2, so each call reads its inputs
    from HBM as the bound assumes; it reduces 1024 floats a row into a
    256 KB output, a single kernel with no memset (a whole-buffer sum adds
    a ``Memset (Device)`` entry, a name that any call's memset would
    share). The sum's kernels, named from a trace of the sum alone, are
    left out of the total. The profiler keeps only the kernels whose device
    timestamps, mapped to the host's clock, fall inside its window, and
    that mapping drifts over a long process: kernels launched just after
    the window opens were sometimes dropped (the sum alone with no kernel,
    or 14 of 20 calls, on the H100), so each trace idles ``TRACE_PAD_S``
    on the host before and after its work. A trace is used only when it is
    whole: each eviction kernel appears exactly once a call and each of
    the call's kernels a multiple of ``reps`` times. An inconsistent trace
    is printed to stderr and taken again, at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    def counts(work) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            work()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        return {e.key: e for e in prof.key_averages() if e.device_type.name == "CUDA"}

    flush = torch.ones((L2_FLUSH_BYTES // 4096, 1024), device="cuda")
    sums = torch.empty(flush.shape[0], device="cuda")

    def evict():
        torch.sum(flush, 1, out=sums)

    def timed():
        for _ in range(reps):
            evict()
            fn()

    fn()
    evict()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        skip = {k: e.count for k, e in counts(evict).items()}
        got = counts(timed)
        seen = {k: e.count for k, e in got.items()}
        own = {k: c for k, c in seen.items() if k not in skip}
        if (skip and own and all(seen.get(k) == reps * c for k, c in skip.items())
                and all(c % reps == 0 for c in own.values())):
            total = sum(e.self_device_time_total for k, e in got.items() if k in own)
            break
        print(f"device_ms: trace {attempt} of {tries} is not whole: the eviction "
              f"alone {skip}, {reps} calls {seen}", file=sys.stderr, flush=True)
    else:
        fail(f"device_ms: no whole trace in {tries} tries (the eviction's kernels also "
             "run inside a timed call, or the profiler lost records)")
    del flush, sums
    if total <= 0:
        fail("torch.profiler recorded no device time for a phase-3 kernel")
    return total / reps / 1e3


def bound(flops: float, peak: float, nbytes: float, fma_peak: float | None = None) -> dict:
    """The least time the card could take: operations over the peak rate
    for their type or bytes over the memory rate, whichever is larger. With
    ``fma_peak`` (the 3xTF32 rows) the row also carries the bound at that
    rate (``bound_fma_ms``), that of the CUDA-core kernels they replaced."""
    row = {"bound_ms": 1e3 * max(flops / peak, nbytes / H100_BYTES),
           "bound_by": "operations" if flops / peak > nbytes / H100_BYTES else "bytes"}
    if fma_peak is not None:
        row["bound_fma_ms"] = 1e3 * max(flops / fma_peak, nbytes / H100_BYTES)
    return row


def check_kernels(gen: torch.Generator, pgen: torch.Generator, qgen: torch.Generator,
                  rgen: torch.Generator, sgen: torch.Generator,
                  tgen: torch.Generator, ugen: torch.Generator) -> list[dict]:
    """Phase 3: every kernel against its plain version at the main paths'
    shapes, with times. Launches here are comparisons and are not counted
    (the counters are zeroed before each main path). Each row names, as
    ``path``, the main path that runs its case and the counter that row
    reports (``main`` reads them), or None for a shape no main path runs
    (the CLI's 64-crop forwards, other types): its launches are 0. The rows
    that hold a path's own shape beside an older row of another shape draw
    their inputs from ``pgen``, so that every older row keeps the inputs
    ``gen`` gave it before they were added; rows added after those draw
    from ``qgen``, so that the rows of ``pgen`` keep theirs too, then from
    ``rgen``, then ``sgen``, K6's newer rows from ``tgen``, and the latest
    (K2's SO400M-384 row) from ``ugen``. K2's rows also carry ``device_ms``."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        flash_attention_packed,
        flash_attention_packed_plain,
        fused_attention_packed,
        fused_attention_packed_plain,
        fused_attention_packed_q8s,
        fused_attention_packed_q8s_plain,
    )
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        rowquant_static,
        rowquant_static_plain,
    )

    rows = []
    heads, w = 16, 1024
    d = w // heads
    # (type, tolerance, peak rate, FMA rate beside a 3xTF32 bound)
    bf16 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)
    # K1's and K5's float32: 3xTF32
    f32tc = (torch.float32, 1e-5, H100_3XTF32_FLOPS, H100_F32_FLOPS)
    # the main paths' own shapes first (BATCH images x 4 crops of ViT-L-14-336
    # int8_static; 4 x 4 of ViT-L-14 float32), then the CLI's 64-crop
    # forwards of ViT-L-14-336 and ViT-L-14 (224)
    # and last S=576 beside S=577 (577 = 9·64 + 1: the one-key tail chunk of
    # the bf16 kernel's 64-key chunks, and a 65-row last query tile)
    for b, s, (dtype, tol, peak, fma), path, rg in (
            (4 * BATCH, 577, bf16, ("l336", "K1"), gen), (16, 257, f32tc, ("l14_f32", "K1"), pgen),
            (64, 577, bf16, None, gen), (64, 577, f32tc, None, gen), (64, 257, bf16, None, gen),
            (64, 257, f32tc, None, gen), (4 * BATCH, 576, bf16, None, rgen)):
        qkv = torch.randn((b, s, 3 * w), generator=rg, device="cuda").to(dtype)
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
            "path": path, "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: fused_attention_packed(qkv, heads, d ** -0.5)),
            "plain_ms": time_ms(lambda: fused_attention_packed_plain(qkv, heads, d ** -0.5),
                                min_reps=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)),
            **bound(flops, peak, nbytes, fma),
        }
        rows.append(row)
        print(f"K1 {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del qkv, q, k, v
        torch.cuda.empty_cache()

    rows += check_rope_and_grouped(gen, pgen, qgen)
    rows += check_int8_kernels(gen, pgen, tgen)
    rows += check_block_linear(gen)
    rows += check_standalone_attention(gen)

    amax = torch.tensor([6.0], device="cuda")
    inv = torch.tensor(127.0) / amax
    # PE-Core-L14-336 int8_static's rows and the CLI's 64-crop forwards' (one
    # warp a row), then (from ugen) SO400M-384's under CTPU_INT8_WIRE=0 (two)
    k2_ln = {}
    for m, k, path, rg in ((4 * BATCH * 577, 1024, ("pe", "K2"), gen),
                           (64 * 577, 1024, None, gen),
                           (4 * BATCH * 729, 1152, ("so400m_wire0", "K2"), ugen)):
        if k not in k2_ln or rg is not gen:
            k2_ln[k] = (1 + 0.1 * torch.randn((k,), generator=rg, device="cuda"),
                        0.1 * torch.randn((k,), generator=rg, device="cuda"))
        g, bta = k2_ln[k]
        x = (torch.randn((m, k), generator=rg, device="cuda") * 2).to(torch.bfloat16)
        diff = (rowquant_static(x, g, bta, amax).int()
                - rowquant_static_plain(x, g, bta, amax).int()).abs()

        def library():
            y = F.layer_norm(x.float(), (k,), g, bta, 1e-5)
            return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)

        def call():
            return rowquant_static(x, g, bta, amax)

        nbytes = m * k * (x.element_size() + 1) + 2 * k * 4
        flops = 10.0 * m * k
        row = {
            "name": "rowquant_static", "route": "cuda", "source": K2_SRC, "replaces": K2_TPU,
            "case": f"bfloat16 [{m},{k}]", "path": path, "max_abs_err": diff.max().item(),
            "tol": 1,
            "flip_share": (diff > 0).float().mean().item(),
            "ms": time_ms(call), "device_ms": device_ms(call),
            "plain_ms": time_ms(lambda: rowquant_static_plain(x, g, bta, amax)),
            "library_ms": time_ms(library),
            **bound(flops, H100_F32_FLOPS, nbytes),
        }
        rows.append(row)
        print(f"K2 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
              f"of entries, kernel {row['ms']:.3f} ms (device {row['device_ms']:.4f}) plain "
              f"{row['plain_ms']:.3f} ln+quant {row['library_ms']:.3f} bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
        if row["flip_share"] > 1e-3:
            fail(f"rowquant_static {row['case']}: ±1 flips on {row['flip_share']:.2e} of "
                 "entries (> 1e-3)")
        del x, diff

    # ViT-SO400M-14-SigLIP-384 (S=729, 16 heads of 72): K5 bf16 at the bf16
    # path's 4 images x 4 crops, at 8 x 4 and f32 at 2 x 4, f32 at the float32
    # path's 4 x 4; K3 at int8_static's
    heads, w, s = 16, 1152, 729
    d = w // heads
    for b, (dtype, tol, peak, fma), path, rg in (
            (16, bf16, ("so400m_bf16", "K5"), pgen), (4 * BATCH, bf16, None, gen),
            (8, f32tc, None, gen), (16, f32tc, ("so400m_f32", "K5"), qgen)):
        qkv = torch.randn((b, s, 3 * w), generator=rg, device="cuda").to(dtype)
        err = (flash_attention_packed(qkv, heads, d ** -0.5).float()
               - flash_attention_packed_plain(qkv, heads, d ** -0.5).float()).abs().max().item()
        q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                   for t in qkv.split(w, dim=-1))
        row = {
            "name": "flash_attention", "route": "cuda", "source": K5_SRC, "replaces": K5_TPU,
            "case": f"{str(dtype)[6:]} [{b},{s},{3 * w}] h={heads}", "path": path,
            "max_abs_err": err,
            "tol": tol, "ms": time_ms(lambda: flash_attention_packed(qkv, heads, d ** -0.5)),
            "plain_ms": time_ms(lambda: flash_attention_packed_plain(qkv, heads, d ** -0.5),
                                min_reps=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)),
            **bound(4.0 * b * heads * s * s * d, peak, b * s * 4 * w * qkv.element_size(), fma),
        }
        rows.append(row)
        print(f"K5 {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del qkv, q, k, v
        torch.cuda.empty_cache()

    # K3 at SO400M-384 int8_static's shape, then (from sgen) at the L-336
    # CTPU_INT8_WIRE=1 route's: the CLI pads its 4 images to a batch of
    # BATCH, x 4 crops, S=577, 16 heads of 64
    for b, s, w, path, rg in ((4 * BATCH, s, w, ("so400m", "K3"), gen),
                              (4 * BATCH, 577, 1024, ("l336_wire", "K3"), sgen)):
        d = w // heads
        qkv = torch.randint(-127, 128, (b, s, 3 * w), generator=rg, device="cuda",
                            dtype=torch.int8)
        # scores of std ~3, outputs over much of the int8 range (as the tests)
        cs = torch.cat([torch.rand(2 * w, generator=rg, device="cuda") * 8e-3 + 4e-3,
                        torch.rand(w, generator=rg, device="cuda") * 0.5 + 0.25])
        diff = (fused_attention_packed_q8s(qkv, cs, heads).int()
                - fused_attention_packed_q8s_plain(qkv, cs, heads).int()).abs()

        def q8s_library():  # dequantize, SDPA, requantize
            deq = (qkv.float() * cs).to(torch.bfloat16).view(b, s, 3, heads, d)
            o = F.scaled_dot_product_attention(*deq.permute(2, 0, 3, 1, 4).unbind(0), scale=1.0)
            return o.transpose(1, 2).reshape(b, s, w).float().round_().clamp_(-127, 127).to(
                torch.int8)

        row = {
            "name": "packed_attention_q8s", "route": "cuda", "source": K3_SRC,
            "replaces": K3_TPU, "case": f"int8 [{b},{s},{3 * w}] h={heads}", "path": path,
            "max_abs_err": diff.max().item(), "tol": 1,
            "flip_share": (diff > 0).float().mean().item(),
            "ms": time_ms(lambda: fused_attention_packed_q8s(qkv, cs, heads)),
            "plain_ms": time_ms(lambda: fused_attention_packed_q8s_plain(qkv, cs, heads),
                                min_reps=3),
            "library_ms": time_ms(q8s_library),
            **bound(4.0 * b * heads * s * s * d, H100_BF16_FLOPS, b * s * 4 * w + 3 * w * 4),
        }
        rows.append(row)
        print(f"K3 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
              f"of entries, kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} "
              f"dequant+sdpa+quant {row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        if row["flip_share"] > 1e-3:
            fail(f"packed_attention_q8s {row['case']}: ±1 flips on {row['flip_share']:.2e} of "
                 "entries (> 1e-3)")
        del qkv, diff
        torch.cuda.empty_cache()
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


def check_rope_and_grouped(gen: torch.Generator, pgen: torch.Generator,
                           qgen: torch.Generator) -> list[dict]:
    """Phase 3, the PE slice's kernels: K1 with RoPE at PE-Core-L14-336's
    int8_static shape, and K4 at the shapes its routes give it — bf16 with
    RoPE at PE-Core-G14-448's (its bf16 path's 4 images x 4 crops, and 8 x
    4), bf16 without RoPE at ViT-B-16-SigLIP-512's (4 x 4, 12 heads of 64)
    and at G14's (4 x 4: K4 without its rotation pre-pass), float32 without
    RoPE at ViT-L-14-336's float32 path (4 images), float32 with RoPE at
    PE-Core-L14-336's float32 path (4 images) and at G14's (1 image, d=96).
    The yardstick ``library_ms`` is SDPA on q and k already rotated: it
    leaves the rotation out; with RoPE, ``library_rot_ms`` is the torch
    rotation and then SDPA. Rows carry ``path``, and draw from ``gen``,
    ``pgen`` or ``qgen``, as in ``check_kernels``."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.models.vit import _rope_on, resolve_config
    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        _rot_half,
        fused_attention_packed,
        fused_attention_packed_grouped,
        fused_attention_packed_grouped_plain,
        fused_attention_packed_plain,
    )

    pe_l, pe_g = resolve_config(PE_L), resolve_config(PE_G)
    bf16 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)
    f32tc = (torch.float32, 1e-5, H100_3XTF32_FLOPS, H100_F32_FLOPS)  # 3xTF32
    cases = (  # (kernel, config, batch, (dtype, tolerance, peak, FMA rate), RoPE, path,
        #  generator)
        ("K1", pe_l, 4 * BATCH, bf16, True, ("pe", "K1"), gen),
        ("K4", pe_g, 16, bf16, True, ("g14", "K4"), pgen),
        ("K4", pe_g, 4 * BATCH, bf16, True, None, gen),
        ("K4", resolve_config(MODEL), 16, f32tc, False, ("l336_f32", "K4"), gen),
        ("K4", pe_l, 16, f32tc, True, ("pe_f32", "K4"), pgen),
        ("K4", pe_g, 4, f32tc, True, None, gen),
        ("K4", resolve_config(SIGLIP_B512), 16, bf16, False, None, qgen),
        ("K4", pe_g, 16, bf16, False, None, qgen),  # G14's shape without its RoPE pre-pass
    )
    rows = []
    for kname, cfg, b, (dtype, tol, peak, fma), with_rope, path, rg in cases:
        s, w, heads, d = cfg.seq_len, cfg.width, cfg.heads, cfg.head_dim
        kernel, plain, name, src, tpu = (
            (fused_attention_packed, fused_attention_packed_plain, "packed_attention", K1_SRC,
             K1_TPU) if kname == "K1" else
            (fused_attention_packed_grouped, fused_attention_packed_grouped_plain,
             "packed_attention_grouped", K4_SRC, K4_TPU))
        rope = _rope_on(cfg, torch.device("cuda")) if with_rope else None
        qkv = torch.randn((b, s, 3 * w), generator=rg, device="cuda").to(dtype)
        err = (kernel(qkv, heads, d ** -0.5, None, rope).float()
               - plain(qkv, heads, d ** -0.5, None, rope).float()).abs().max().item()
        q0, k0, v = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                     for t in qkv.split(w, dim=-1))
        q, k = q0, k0
        rot = {}
        if rope is not None:
            cos, sin = (t.to(dtype) for t in rope)
            q, k = _rot_half(q0, cos, sin).contiguous(), _rot_half(k0, cos, sin).contiguous()
            rot["library_rot_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                _rot_half(q0, cos, sin), _rot_half(k0, cos, sin), v, scale=d ** -0.5))
        nbytes = b * s * 4 * w * qkv.element_size() + (2 * s * d // 2 * qkv.element_size()
                                                       if rope is not None else 0)
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "case": f"{str(dtype)[6:]} [{b},{s},{3 * w}] h={heads}"
                    + (" RoPE" if rope is not None else ""),
            "path": path, "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: kernel(qkv, heads, d ** -0.5, None, rope)),
            "plain_ms": time_ms(lambda: plain(qkv, heads, d ** -0.5, None, rope), min_reps=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)),
            **rot,
            **bound(4.0 * b * heads * s * s * d, peak, nbytes, fma),
        }
        rows.append(row)
        print(f"{kname} {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms "
              f"plain {row['plain_ms']:.3f} sdpa(rotated q,k) {row['library_ms']:.3f} "
              + (f"rotation+sdpa {rot['library_rot_ms']:.3f} " if rot else "")
              + f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del qkv, q, k, v, q0, k0
        torch.cuda.empty_cache()
    return rows


def row_quant_torch(y: torch.Tensor):
    """The library yardstick's dynamic per-row quantize, in torch ops."""
    amax = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    return (y * (127.0 / amax)).round_().clamp_(-127, 127).to(torch.int8), amax / 127.0


def check_int8_kernels(gen: torch.Generator, pgen: torch.Generator,
                       tgen: torch.Generator) -> list[dict]:
    """Phase 3, the dynamic-int8 slice's kernels at ViT-L-14-336's shapes (8
    images x 4 crops: M = 18464 token rows): K6 with ln (ln1, ln2; [M, 1024])
    and with quick_gelu (the MLP hidden; [M, 4096]), bf16 and f32 in; then
    (from ``tgen``) K6's pass with neither, as K9's prologue runs it on the
    CTPU_FUSED_QMATMUL=1 path ([9232, 1024] and [9232, 4096] bf16) and as
    K1's quant_out runs it on the hybrid path ([18464, 1024] f32), and at
    SO400M-384's hybrid shapes (32 crops of S=729: ln at [23328, 1152],
    gelu_tanh at [23328, 4304]), which no path here runs; K9 at the four
    products of a layer, each beside ``torch._int_mm`` alone at its shape
    (``library_gemm_ms``); K1 with quant_out at [32, 577, 3072]. K6's and
    K9's rows also carry ``device_ms``, the device time of a call."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        fused_attention_packed,
        fused_attention_packed_plain,
    )
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_weight
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        q_linear_fused,
        q_linear_fused_plain,
        rowquant,
        rowquant_plain,
    )

    rows = []
    m = 4 * BATCH * 577
    so_m = 4 * BATCH * 729
    # (rows, K, layernorm, act, type, path, generator)
    for rows_m, k, with_ln, act, dtype, path, rg in (
            (m, 1024, True, None, torch.bfloat16, ("dyn", "K6"), gen),
            (m, 1024, True, None, torch.float32, None, gen),
            (m, 4096, False, "quick_gelu", torch.bfloat16, ("dyn", "K6"), gen),
            (m, 4096, False, "quick_gelu", torch.float32, None, gen),
            (16 * 577, 1024, False, None, torch.bfloat16, None, tgen),
            (16 * 577, 4096, False, None, torch.bfloat16, None, tgen),
            (m, 1024, False, None, torch.float32, None, tgen),
            (so_m, 1152, True, None, torch.bfloat16, None, tgen),
            (so_m, 4304, False, "gelu_tanh", torch.bfloat16, None, tgen)):
        x = (torch.randn((rows_m, k), generator=rg, device="cuda") * 2).to(dtype)
        ln = (() if not with_ln else
              (1 + 0.1 * torch.randn((k,), generator=rg, device="cuda"),
               0.1 * torch.randn((k,), generator=rg, device="cuda")))

        def call():
            return rowquant(x, *ln, act=act)

        def plain():
            return rowquant_plain(x, *ln, act=act)

        (q, s), (rq, rs) = call(), plain()
        diff = (q.int() - rq.int()).abs()
        scale_err = ((s - rs).abs() / rs).max().item()

        def library():
            y = F.layer_norm(x.float(), (k,), *ln, 1e-5) if ln else x.float()
            if act == "quick_gelu":
                y = y * torch.sigmoid(1.702 * y)
            elif act == "gelu_tanh":
                y = F.gelu(y, approximate="tanh")
            return row_quant_torch(y)

        nbytes = rows_m * k * (x.element_size() + 1) + rows_m * 4 + (2 * k * 4 if ln else 0)
        # float32 operations an element: layernorm 12, activation 10, quantize alone 4
        flops = (12.0 if ln else 10.0 if act else 4.0) * rows_m * k
        label = "ln" if ln else act or "quantize"
        row = {
            "name": "rowquant", "route": "cuda", "source": K6_SRC, "replaces": K6_TPU,
            "case": f"{str(dtype)[6:]} [{rows_m},{k}] {label}",
            # the hybrid path's blocks run in bf16 (its ln and quick_gelu
            # rows); the quantize alone runs inside K9's and K1's launches,
            # under their counters
            "path": path,
            "max_abs_err": diff.max().item(), "tol": 1,
            "flip_share": (diff > 0).float().mean().item(), "scale_rel_err": scale_err,
            "ms": time_ms(call), "device_ms": device_ms(call), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library),
            **bound(flops, H100_F32_FLOPS, nbytes),
        }
        rows.append(row)
        print(f"K6 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
              f"of entries, scale rel err {scale_err:.2e}; kernel {row['ms']:.3f} ms (device "
              f"{row['device_ms']:.4f}) plain {row['plain_ms']:.3f} torch "
              f"{row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        if row["flip_share"] > 1e-3 or scale_err > 1e-6:
            fail(f"rowquant {row['case']}: ±1 flips on {row['flip_share']:.2e} of entries, "
                 f"scale rel err {scale_err:.2e}")
        del x, q, s, rq, rs, diff
        torch.cuda.empty_cache()

    x = torch.randn((m, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    # K9 at a layer's four products, at 8 images x 4 crops (M=18464), then at
    # the CTPU_FUSED_QMATMUL=1 path's 4 x 4 (M=9232)
    products = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
    for rows_m, (k, n), path, rg in [(m, kn, None, gen) for kn in products] + [
            (16 * 577, kn, ("fused_qmatmul", "K9"), pgen) for kn in products]:
        xk = x[:rows_m, :k].contiguous()
        wq, ws = quantize_weight(torch.randn((k, n), generator=rg, device="cuda") * k ** -0.5)
        wq_t = wq.t().contiguous()
        b = 0.1 * torch.randn((n,), generator=rg, device="cuda")
        got = q_linear_fused(xk, wq_t, ws, b)
        ref = q_linear_fused_plain(xk, wq_t, ws, b)
        err = (got.float() - ref.float()).abs()
        flip_rows = (err > 2.0 ** -7 * ref.float().abs() + 1e-6).any(dim=1).sum().item()
        xq_t = torch.empty((rows_m, k), dtype=torch.int8, device="cuda")
        xq_k, _ = rowquant_plain(xk)

        def library():  # the port's torch q_matmul: quantize, _int_mm, epilogue
            xf = xk.float()
            amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
            xq_t.copy_((xf * (127.0 / amax)).round_().clamp_(-127, 127))
            acc = torch._int_mm(xq_t, wq_t.t())
            return ((acc * (amax / 127.0)) * ws + b).to(torch.bfloat16)

        def call():
            return q_linear_fused(xk, wq_t, ws, b)

        def int_mm():  # the one library call that computes K9's product
            return torch._int_mm(xq_k, wq_t.t())

        row = {
            "name": "q_linear_fused", "route": "cuda", "source": K9_SRC, "replaces": K9_TPU,
            "case": f"bfloat16 [{rows_m},{k}] x int8 [{k},{n}] -> bfloat16", "path": path,
            "max_abs_err": err.max().item(), "tol": 2.0 ** -7 * ref.float().abs().max().item(),
            "flip_rows": flip_rows, "bit_identical": bool(torch.equal(got, ref)),
            "ms": time_ms(call), "device_ms": device_ms(call),
            "plain_ms": time_ms(lambda: q_linear_fused_plain(xk, wq_t, ws, b)),
            "library_ms": time_ms(library), "library_gemm_ms": time_ms(int_mm),
            "library_gemm_device_ms": device_ms(int_mm),
            **bound(2.0 * rows_m * n * k, H100_INT8_OPS,
                    rows_m * k * 2 + n * k + rows_m * n * 2 + 2 * n * 4),
        }
        rows.append(row)
        print(f"K9 {row['case']}: max |err| {row['max_abs_err']:.3g} (tol {row['tol']:.3g}), "
              f"{flip_rows} rows off, bit-identical {row['bit_identical']}; kernel "
              f"{row['ms']:.3f} ms (device {row['device_ms']:.4f}) plain {row['plain_ms']:.3f} "
              f"quant+_int_mm+epilogue {row['library_ms']:.3f} _int_mm alone "
              f"{row['library_gemm_ms']:.3f} (device {row['library_gemm_device_ms']:.4f}) bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        if flip_rows > 1e-3 * rows_m:
            fail(f"q_linear_fused {row['case']}: {flip_rows} rows off by more than a bf16 step")
        del xk, wq, wq_t, got, ref, err, xq_t, xq_k
        torch.cuda.empty_cache()
    del x

    b, s, heads, w = 4 * BATCH, 577, 16, 1024
    d = w // heads
    qkv = torch.randn((b, s, 3 * w), generator=gen, device="cuda").to(torch.bfloat16)
    (q, sc), (rq, rsc) = (fused_attention_packed(qkv, heads, d ** -0.5, quant_out=True),
                          fused_attention_packed_plain(qkv, heads, d ** -0.5, quant_out=True))
    diff = (q.int() - rq.int()).abs()
    # scores sum in another order than torch's, so a few bf16 P values round
    # to the other neighbour and move their token's scale by up to one bf16
    # step of that p: ≤ 2^-8 on all tokens, ≤ 1e-5 on all but ≤ 5%
    rel = (sc / rsc - 1).abs()
    scale_err, scale_off = rel.max().item(), (rel > 1e-5).float().mean().item()
    qh, kh, vh = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                  for t in qkv.split(w, dim=-1))

    def q_library():  # SDPA, then a torch row quantize
        o = F.scaled_dot_product_attention(qh, kh, vh, scale=d ** -0.5)
        return row_quant_torch(o.transpose(1, 2).reshape(b * s, w).float())

    row = {
        "name": "packed_attention", "route": "cuda", "source": K1_SRC, "replaces": K1_TPU,
        "case": f"bfloat16 [{b},{s},{3 * w}] h={heads} quant_out",
        "path": ("dyn", "K1"),  # the hybrid main path: every K1 launch has quant_out
        "max_abs_err": diff.max().item(), "tol": 1,
        "flip_share": (diff > 0).float().mean().item(), "scale_rel_err": scale_err,
        "scale_off_share": scale_off,
        "ms": time_ms(lambda: fused_attention_packed(qkv, heads, d ** -0.5, quant_out=True)),
        "plain_ms": time_ms(lambda: fused_attention_packed_plain(qkv, heads, d ** -0.5,
                                                                 quant_out=True), min_reps=3),
        "library_ms": time_ms(q_library),
        **bound(4.0 * b * heads * s * s * d, H100_BF16_FLOPS, b * s * (3 * w * 2 + w + 4)),
    }
    rows.append(row)
    print(f"K1 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} of "
          f"entries, scale rel err {scale_err:.2e} (> 1e-5 on {scale_off:.2e} of tokens); "
          f"kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} sdpa+quant "
          f"{row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
          flush=True)
    if row["flip_share"] > 1e-3 or scale_err > 2.0 ** -8 or scale_off > 5e-2:
        fail(f"K1 quant_out: ±1 flips on {row['flip_share']:.2e} of entries, scale rel err "
             f"{scale_err:.2e}, > 1e-5 on {scale_off:.2e} of tokens")
    del qkv, q, sc, rq, rsc, diff, qh, kh, vh
    torch.cuda.empty_cache()
    return rows


def check_block_linear(gen: torch.Generator) -> list[dict]:
    """Phase 3, K8 at ViT-L-14-336's four block linears (8 images x 4 crops:
    M = 18464): ln1 + quantize + qkv (1024→3072, bf16 out); the out
    projection over int8 rows with the residual (1024→1024); ln2 + quantize
    + fc1 + quick_gelu + requantize (1024→4096, quant_out); fc2 over those
    int8 rows with the residual (4096→1024). The yardstick is the port's
    torch chain for the same function: layer_norm and a row quantize, then
    ``torch._int_mm``, then the epilogue as torch passes."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_weight
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        q_block_linear,
        q_block_linear_plain,
        rowquant,
        rowquant_plain,
    )

    m = 4 * BATCH * 577
    rows = []
    x = (torch.randn((m, 1024), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    res = torch.randn((m, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    g = 1 + 0.1 * torch.randn((1024,), generator=gen, device="cuda")
    bta = 0.1 * torch.randn((1024,), generator=gen, device="cuda")
    xq8 = torch.randint(-127, 128, (m, 1024), generator=gen, device="cuda", dtype=torch.int8)
    xs8 = torch.rand((m, 1), generator=gen, device="cuda") * 0.02 + 0.01
    h_q = h_s = None
    for label, k, n in (("ln1+qkv", 1024, 3072), ("out+residual", 1024, 1024),
                        ("ln2+fc1+quick_gelu+quant_out", 1024, 4096),
                        ("fc2+residual", 4096, 1024)):
        wq, ws = quantize_weight(torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5)
        wq_t = wq.t().contiguous()
        bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
        if label == "ln1+qkv":
            args, kw = (x,), dict(ln_scale=g, ln_bias=bta)
        elif label == "out+residual":
            args, kw = (xq8,), dict(x_scale=xs8, residual=res)
        elif label.startswith("ln2"):
            args, kw = (x,), dict(ln_scale=g, ln_bias=bta, act="quick_gelu", quant_out=True)
        else:
            args, kw = (h_q,), dict(x_scale=h_s, residual=res)
        x_in = args[0]

        def call():
            return q_block_linear(x_in, wq_t, ws, bias, **kw)

        def plain():
            return q_block_linear_plain(x_in, wq_t, ws, bias, **kw)

        def library():  # layer_norm + row quantize, _int_mm, epilogue passes
            if "x_scale" in kw:
                xq, xs = x_in, kw["x_scale"]
            else:
                xq, xs = row_quant_torch(F.layer_norm(x_in.float(), (k,), g, bta, 1e-5))
            y = torch._int_mm(xq, wq_t.t()) * xs * ws + bias
            if kw.get("act"):
                y = y * torch.sigmoid(1.702 * y)
            if "residual" in kw:
                y = y + kw["residual"]
            return row_quant_torch(y) if kw.get("quant_out") else y.to(torch.bfloat16)

        got, ref = call(), plain()
        # rows where K6's prologue put an input value on the other side of a
        # .5 boundary (its layernorm sums in another order than torch's):
        # each flip moves the row's outputs by up to amax·w_scale, so those
        # rows are held to tests/test_quant_kernel.py's flip-aware bound,
        # 1.2·n_flips·amax·w_scale (the 1.2 for the activation's slope)
        flip_bound = torch.zeros((m, 1), device="cuda")
        if "ln_scale" in kw:
            (xq, _), (rxq, rxs) = rowquant(x_in, g, bta), rowquant_plain(x_in, g, bta)
            flip_bound = 1.2 * (xq != rxq).sum(dim=1, keepdim=True) * (rxs * 127) * ws.view(1, -1)
            del xq, rxq
        flipped = (flip_bound > 0).any(dim=1)
        n_flip = int(flipped.sum())
        if kw.get("quant_out"):
            (q, sc), (rq, rsc) = got, ref
            diff = (q.int() - rq.int()).abs()[~flipped]
            err, tol = diff.max().item(), 1
            share = (diff > 0).float().mean().item()
            scale_err = ((sc - rsc).abs() / rsc)[~flipped].max().item()
            # flipped rows: one output step plus the flip-aware bound
            over = ((q.float() * sc - rq.float() * rsc).abs()
                    > torch.maximum(sc, rsc) + flip_bound)[flipped].sum().item()
            ok = (n_flip <= 1e-3 * m and err <= tol and share <= 1e-3 and scale_err <= 1e-6
                  and over == 0)
            h_q, h_s = q, sc
            out_bytes = m * n + m * 4
            detail = (f"int8 ±{err} on {share:.2e} of entries outside {n_flip} rows with a "
                      f"flipped input, scale rel err {scale_err:.2e}; {over} entries of those "
                      f"rows over the flip-aware bound")
        else:
            e, r = (got.float() - ref.float()).abs(), ref.float()
            err, tol = e[~flipped].max().item(), 2.0 ** -7 * r[~flipped].abs().max().item()
            off = (e > 2.0 ** -7 * r.abs() + 1e-6 + flip_bound).any(dim=1)
            ok = n_flip <= 1e-3 * m and not off.any().item()
            out_bytes = m * n * 2
            detail = (f"max |err| {err:.3g} (tol {tol:.3g}) outside {n_flip} rows with a "
                      f"flipped input, {int(off.sum())} rows over one bf16 step plus the "
                      f"flip-aware bound")
        in_bytes = (m * k + m * 4) if "x_scale" in kw else m * k * 2 + 2 * k * 4
        nbytes = in_bytes + n * k + 2 * n * 4 + out_bytes + (m * n * 2 if "residual" in kw else 0)
        xq_gemm = x_in if "x_scale" in kw else rowquant_plain(x_in, g, bta)[0]

        def int_mm():  # the one library call that computes K8's product
            return torch._int_mm(xq_gemm, wq_t.t())

        row = {
            "name": "q_block_linear", "route": "cuda", "source": K8_SRC, "replaces": K8_TPU,
            "case": f"{label} M={m} {k}->{n}", "path": ("all", "K8"), "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(call), "device_ms": device_ms(call), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "library_gemm_ms": time_ms(int_mm),
            "library_gemm_device_ms": device_ms(int_mm),
            **bound(2.0 * m * n * k, H100_INT8_OPS, nbytes),
        }
        rows.append(row)
        print(f"K8 {row['case']}: {detail}; kernel {row['ms']:.3f} ms (device "
              f"{row['device_ms']:.4f}) plain {row['plain_ms']:.3f} ln/quant+_int_mm+epilogue "
              f"{row['library_ms']:.3f} _int_mm alone {row['library_gemm_ms']:.3f} (device "
              f"{row['library_gemm_device_ms']:.4f}) bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        if not ok:
            fail(f"q_block_linear {row['case']} disagrees with its plain version: {detail}")
        del wq, wq_t, got, ref, xq_gemm
        torch.cuda.empty_cache()
    return rows


def quant_out_long_sequences() -> None:
    """Phase 3b: the per-token scales of K1's and K7's quant_out against
    their plain versions as the sequence grows (one batch item, one head of
    128: S = 729 as SO400M-384, then 2048, 8192 and 24000): the largest
    relative error and the share of tokens over 1e-5, and the int8 outputs'
    ±1 share. A bf16 P value that rounds to its other neighbour (the scores
    sum in another order than torch's) moves its token's output by up to one
    bf16 step of that p, so the scales are held to 2^-8 and the int8 values
    to ±1, on at most 5e-3 of entries, at every S; the 1e-5 limit of the
    short-sequence checks is a share that grows with S and is reported, not
    held."""
    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        fused_attention_packed,
        fused_attention_packed_plain,
        fused_attention_packed_q8,
        fused_attention_packed_q8_plain,
    )

    w = 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    for s in (729, 2048, 8192, 24000):
        x = torch.randn((1, s, 3 * w), generator=gen, device="cuda")
        amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
        q8 = torch.round(x / (amax / 127)).clamp_(-127, 127).to(torch.int8)
        ts = amax / 127 * 1.7  # scores of std ~2
        for name, got, ref in (
                ("K1", fused_attention_packed(x.to(torch.bfloat16), 1, w ** -0.5, quant_out=True),
                 fused_attention_packed_plain(x.to(torch.bfloat16), 1, w ** -0.5,
                                              quant_out=True)),
                ("K7", fused_attention_packed_q8(q8, ts, 1, w ** -0.5, quant_out=True),
                 fused_attention_packed_q8_plain(q8, ts, 1, w ** -0.5, quant_out=True))):
            (q, sc), (rq, rsc) = got, ref
            diff = (q.int() - rq.int()).abs()
            rel = (sc / rsc - 1).abs()
            print(f"{name} quant_out [1,{s},{3 * w}] h=1: scale rel err max "
                  f"{rel.max().item():.3e}, > 1e-5 on {(rel > 1e-5).float().mean().item():.4f} "
                  f"of tokens; int8 ±{diff.max().item()} on "
                  f"{(diff > 0).float().mean().item():.2e} of entries", flush=True)
            # tests/test_torch_cuda.py's LONG_FLIP_SHARE: the ±1 share at most 5e-3
            share = (diff > 0).float().mean().item()
            if rel.max().item() > 2.0 ** -8 or diff.max().item() > 1 or share > 5e-3:
                fail(f"{name} quant_out at S={s}: scales {rel.max().item():.3e} off (> 2^-8), "
                     f"int8 values {diff.max().item()} apart or ±1 on {share:.2e} (> 5e-3)")
            del q, sc, rq, rsc, diff, rel
        del x, q8, ts
        torch.cuda.empty_cache()


def check_standalone_attention(gen: torch.Generator) -> list[dict]:
    """Phase 3, the attention kernels no path of the JAX package reaches: K7
    at int8 [32,577,3072] (ViT-L-14-336, 16 heads) with bf16 and quant_out
    outputs (yardstick: dequantize, SDPA, and a torch requantize); K10 at
    bf16 [32,16,577,64] and f32 [8,16,577,64] (SDPA); K5 with RoPE at
    PE-Core-G14-448's shape, bf16 [32,1024,4608] and f32 [4,1024,4608], 16
    heads of 96 (yardstick: the torch rotation, then SDPA)."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.models.vit import _rope_on, resolve_config
    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        _rot_half,
        flash_attention_packed,
        flash_attention_packed_plain,
        fused_attention,
        fused_attention_packed_q8,
        fused_attention_packed_q8_plain,
        fused_attention_plain,
    )

    rows = []
    b, s, heads, w = 4 * BATCH, 577, 16, 1024
    d = w // heads
    src = torch.randn((b, s, 3 * w), generator=gen, device="cuda")
    amax = src.abs().amax(dim=-1, keepdim=True)
    qkv = torch.round(src * (127.0 / amax)).clamp_(-127, 127).to(torch.int8)
    ts = amax / 127.0 * 1.7  # scores of std ~2
    del src
    for quant_out in (False, True):
        kw = dict(quant_out=quant_out)

        def call():
            return fused_attention_packed_q8(qkv, ts, heads, d ** -0.5, **kw)

        def plain():
            return fused_attention_packed_q8_plain(qkv, ts, heads, d ** -0.5, **kw)

        def library():  # dequantize, SDPA (+ a torch row requantize)
            deq = (qkv.float() * ts).to(torch.bfloat16).view(b, s, 3, heads, d)
            o = F.scaled_dot_product_attention(*deq.permute(2, 0, 3, 1, 4).unbind(0),
                                               scale=d ** -0.5).transpose(1, 2).reshape(b, s, w)
            return row_quant_torch(o.float()) if quant_out else o

        got, ref = call(), plain()
        if quant_out:
            (q, sc), (rq, rsc) = got, ref
            diff = (q.int() - rq.int()).abs()
            rel = (sc / rsc - 1).abs()
            err, tol = diff.max().item(), 1
            share, off = (diff > 0).float().mean().item(), (rel > 1e-5).float().mean().item()
            ok = share <= 1e-3 and rel.max().item() <= 2.0 ** -8 and off <= 5e-2
            detail = (f"int8 ±{err} on {share:.2e} of entries, scale rel err "
                      f"{rel.max().item():.2e} (> 1e-5 on {off:.2e} of tokens)")
            out_bytes = b * s * (w + 4)
        else:  # within 2e-2 or one bf16 step of the reference value, elementwise
            e, r = (got.float() - ref.float()).abs(), ref.float().abs()
            over = int((e > torch.clamp(2.0 ** -7 * r, min=2e-2)).sum())
            err, tol = e.max().item(), max(2e-2, 2.0 ** -7 * r.max().item())
            ok, out_bytes = over == 0, b * s * w * 2
            detail = f"err {err:.3g}, {over} entries over max(2e-2, 2^-7·|ref|)"
        row = {
            "name": "packed_attention_q8", "route": "cuda", "source": K7_SRC, "replaces": K7_TPU,
            "case": f"int8 [{b},{s},{3 * w}] h={heads} " + ("quant_out" if quant_out else "bf16"),
            "path": ("all", "K7"),
            "max_abs_err": err, "tol": tol, "ms": time_ms(call),
            "plain_ms": time_ms(plain, min_reps=3), "library_ms": time_ms(library),
            **bound(4.0 * b * heads * s * s * d, H100_BF16_FLOPS, b * s * (3 * w + 4) + out_bytes),
        }
        rows.append(row)
        print(f"K7 {row['case']}: {detail}; kernel {row['ms']:.3f} ms plain "
              f"{row['plain_ms']:.3f} dequant+sdpa{'+quant' if quant_out else ''} "
              f"{row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        if not ok:
            fail(f"packed_attention_q8 {row['case']} disagrees with its plain version: {detail}")
        del got, ref
    del qkv, ts
    torch.cuda.empty_cache()

    # (batch, type, tolerance, peak rate, FMA rate beside the 3xTF32 bound)
    for b, dtype, tol, peak, fma in ((4 * BATCH, torch.bfloat16, 2e-2, H100_BF16_FLOPS, None),
                                     (8, torch.float32, 1e-5, H100_3XTF32_FLOPS, H100_F32_FLOPS)):
        q, k, v = (torch.randn((b, heads, s, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        err = (fused_attention(q, k, v, d ** -0.5).float()
               - fused_attention_plain(q, k, v, d ** -0.5).float()).abs().max().item()
        row = {
            "name": "fused_attention", "route": "cuda", "source": K10_SRC, "replaces": K10_TPU,
            "case": f"{str(dtype)[6:]} [{b},{heads},{s},{d}]", "path": ("all", "K10"),
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: fused_attention(q, k, v, d ** -0.5)),
            "plain_ms": time_ms(lambda: fused_attention_plain(q, k, v, d ** -0.5), min_reps=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                          scale=d ** -0.5)),
            **bound(4.0 * b * heads * s * s * d, peak, 4 * q.numel() * q.element_size(), fma),
        }
        rows.append(row)
        print(f"K10 {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms plain "
              f"{row['plain_ms']:.3f} sdpa {row['library_ms']:.3f} bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    cfg = resolve_config(PE_G)
    s, w, heads, d = cfg.seq_len, cfg.width, cfg.heads, cfg.head_dim
    for b, (dtype, tol, peak, fma) in (
            (4 * BATCH, (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)),
            (4, (torch.float32, 1e-5, H100_3XTF32_FLOPS, H100_F32_FLOPS))):
        rope = _rope_on(cfg, torch.device("cuda"))
        qkv = torch.randn((b, s, 3 * w), generator=gen, device="cuda").to(dtype)
        err = (flash_attention_packed(qkv, heads, d ** -0.5, None, rope).float()
               - flash_attention_packed_plain(qkv, heads, d ** -0.5, None, rope).float()
               ).abs().max().item()
        qh, kh, vh = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                      for t in qkv.split(w, dim=-1))
        cos, sin = (t.to(dtype) for t in rope)

        def library():  # the torch rotation of q and k, then SDPA
            return F.scaled_dot_product_attention(_rot_half(qh, cos, sin), _rot_half(kh, cos, sin),
                                                  vh, scale=d ** -0.5)

        row = {
            "name": "flash_attention", "route": "cuda", "source": K5_SRC, "replaces": K5_TPU,
            "case": f"{str(dtype)[6:]} [{b},{s},{3 * w}] h={heads} RoPE",
            "path": ("all", "K5+RoPE"),  # a counter of its own
            "max_abs_err": err,
            "tol": tol, "ms": time_ms(lambda: flash_attention_packed(qkv, heads, d ** -0.5, None,
                                                                      rope)),
            "plain_ms": time_ms(lambda: flash_attention_packed_plain(qkv, heads, d ** -0.5, None,
                                                                     rope), min_reps=3),
            "library_ms": time_ms(library),
            **bound(4.0 * b * heads * s * s * d, peak,
                    b * s * 4 * w * qkv.element_size() + s * d * qkv.element_size(), fma),
        }
        rows.append(row)
        print(f"K5 {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms plain "
              f"{row['plain_ms']:.3f} rotation+sdpa {row['library_ms']:.3f} bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del qkv, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


def profile_steady(model: str, root: str, calib: str, cfg, per_batch: dict,
                   dtype: str) -> None:
    """A main path's device work again, steady state: the encoder (with the
    saved calibration, for int8_static), all batches decoded up front, then
    (a) wall time over every batch (crops + ViT + image stats, H2D included,
    decode excluded) and (b) a torch.profiler trace of one batch, summed by
    kernel name. Its launches are counted on their own and must be
    ``per_batch`` per batch; a profiler that fails or sees no device time
    fails the run."""
    from torch.profiler import ProfilerActivity, profile

    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader, find_images
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import image_stats_batch

    enc = CLIPImageEncoder(model, compute_dtype=dtype, calibration_path=calib, device="cuda")
    if dtype == "int8_static" and not enc.load_calibration():
        fail(f"{model}: the saved calibration did not load")
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
    reset_counts()
    t0 = time.perf_counter()
    for b in batches:
        run(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = {k: per_batch.get(k, 0) * len(batches) for k in got}
    if got != want:
        fail(f"{model} steady-state launches {got}, expected {want}")
    n = sum(b.n_valid for b in batches)
    print(f"steady state {model} {dtype}: {n} images x 4 crops in {wall * 1e3:.1f} ms = "
          f"{n / wall:.2f} imgs/s ({len(batches)} batches of {BATCH}, canvas buckets "
          f"{sorted({b.canvas.shape[1] for b in batches})})", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(batches[-1])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        fail(f"torch.profiler recorded no device time for {model}")
    print(f"profile of one batch of {model} {dtype} ({BATCH} images, 4 crops, "
          f"S={cfg.seq_len}): "
          f"device time {total / 1e3:.2f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:100]}",
              flush=True)
    del enc, batches
    torch.cuda.empty_cache()


def embed_and_check(root: str, model: str, cfg, per_forward: dict,
                    dtype: str = "int8_static") -> dict:
    """A main path through the user's entry point: the embed CLI on the PNGs
    (``dtype``, batch BATCH), with the launch counters zeroed just before
    and read just after — ``per_forward`` for each batch's forward, none for
    int8_static's calibration forward (its attention is the plain XLA-style
    path); then its outputs (a .calib.npz exactly for int8_static), steady
    state and profile. Returns the launch counts, the sidecar paths and their
    embeddings [N_IMAGES, 4, D]."""
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    n_batches = math.ceil(N_IMAGES / BATCH)
    reset_counts()
    t0 = time.perf_counter()
    stores = embed_main(["--root_dir", root, "--models_to_use", model,
                         "--compute_dtype", dtype, "--batch_size", str(BATCH),
                         "--num_workers", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = {k: n_batches * per_forward.get(k, 0) for k in got}
    print(f"main path {model} {dtype}: {N_IMAGES} images x 4 crops in {wall:.2f} s "
          f"({N_IMAGES / wall:.2f} imgs/s incl. model init and calibration); "
          f"launches {got} (want {want})", flush=True)
    if got != want:
        fail(f"{model}: launch counters {got}, expected {want}")

    store = stores[model]
    pts = sorted(glob.glob(os.path.join(root, "*.pt")))
    calib = os.path.join(root, model.replace("/", "-") + ".calib.npz")
    static = dtype == "int8_static"
    if len(pts) != N_IMAGES or os.path.exists(calib) != static:
        fail(f"{len(pts)} sidecars (want {N_IMAGES}), calib exists: {os.path.exists(calib)}")
    shapes = None
    if static:
        with np.load(calib) as f:
            shapes = {k: f[k].shape for k in ("act_amax", "qkv_amax")}
        if shapes != {"act_amax": (cfg.layers, 4), "qkv_amax": (cfg.layers, 3 * cfg.width)}:
            fail(f"{model}: calibration shapes {shapes}")
    reopened = EmbeddingStore.open(root, model)
    emb = np.asarray(reopened.embeddings, np.float32)
    if emb.shape != (N_IMAGES, 4, cfg.embed_dim) or not np.asarray(reopened.valid).all():
        fail(f"store shape {emb.shape}, valid {np.asarray(reopened.valid).sum()}")
    side = np.stack([np.stack([read_sidecar(p)[model][c].reshape(-1)
                               for c in store.meta["crop_names"]]) for p in pts])
    norms = np.linalg.norm(side, axis=-1)
    stats = np.asarray(reopened.img_stats)
    if not (np.isfinite(side).all() and np.abs(norms - 1).max() < 1e-3
            and np.isfinite(stats).all()):
        fail(f"embeddings not finite unit vectors (norm range {norms.min()}..{norms.max()})")
    print(f"outputs {model} {dtype}: {len(pts)} sidecars, store {emb.shape}, calib "
          f"{os.path.basename(calib) if static else 'none'} {shapes}, |norm-1| max "
          f"{np.abs(norms - 1).max():.2e}", flush=True)
    del stores, store, reopened
    torch.cuda.empty_cache()
    profile_steady(model, root, calib, cfg, per_forward, dtype)
    return {"launches": got, "side": side, "pts": pts}


def encoder_run(model: str, dtype: str, pts: list, side, cfg, per_forward: dict,
                side_name: str = "int8_static", timed: bool = False,
                cpu_ref: bool = False, cpu_images: int = 4) -> dict:
    """Four images through the encoder in ``dtype``; its launches must be
    ``per_forward``, its embeddings finite unit vectors and, where ``side``
    holds those of another run (``side_name``) of the same images, near
    them. ``timed``: then the steady per-forward ms of the same batch (crops
    and ViT, the canvas already on the card; CUDA events after two warm-up
    forwards). ``cpu_ref``: the weights are made once on the card, as the
    encoder makes them by default (seeded by the model name, so ``side``
    still compares like with like), and the same encoder on the CPU (plain
    versions throughout) embeds the first ``cpu_images`` images of the
    batch: the cosine of every crop within 1e-5 of the card's. Returns the
    launch counts."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.encoders import (
        CLIPImageEncoder,
        _stable_seed,
    )
    from clip_assisted_data_labeling_tpu_torch.models.vit import init_vit_params

    params = (init_vit_params(cfg, torch.Generator(device="cuda").manual_seed(
        _stable_seed(model)), "cuda") if cpu_ref else None)
    enc = CLIPImageEncoder(model, params=params, compute_dtype=dtype, device="cuda")
    first = pts[:4]
    loader = BatchedImageLoader([p[:-3] + ".png" for p in first], canvas_size=1024,
                                out_size=cfg.image_size, batch_size=4, num_workers=4)
    batch = next(iter(loader))
    reset_counts()
    emb = enc.embed_crops(batch.canvas, batch.crop_params)[: batch.n_valid].cpu().numpy()
    got = counts()
    want = {k: per_forward.get(k, 0) for k in got}
    if got != want:
        fail(f"{model} {dtype} path launches {got}, expected {want}")
    norms = np.linalg.norm(emb, axis=-1)
    if not (np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3):
        fail(f"{model} {dtype}: embeddings not finite unit vectors ({norms.min()}..{norms.max()})")
    if side is None:
        print(f"{model} {dtype}: {emb.shape[0]} images x {emb.shape[1]} crops, finite, "
              f"|norm-1| max {np.abs(norms - 1).max():.2e}; launches {got}", flush=True)
    else:
        order = [first.index(p[:-4] + ".pt") for p in batch.paths]
        cos = np.sum(emb * side[order], axis=-1)
        print(f"{model} {dtype} vs {side_name} cosine over {cos.size} crops: min "
              f"{cos.min():.5f} mean {cos.mean():.5f}; launches {got}", flush=True)
        if not cos.min() > 0.95:
            fail(f"{dtype} and {side_name} embeddings disagree (cosine min {cos.min()})")
    if cpu_ref:
        cpu = CLIPImageEncoder(model, params={k: v.cpu() for k, v in params.items()},
                               compute_dtype=dtype, device="cpu")
        n = min(cpu_images, batch.n_valid)
        t0 = time.perf_counter()
        ref = cpu.embed_crops(batch.canvas[:n], batch.crop_params[:n]).numpy()
        cos_err = 1.0 - np.sum(emb[:n] * ref, axis=-1).min()
        print(f"{model} {dtype} card vs CPU (same weights and images, {ref.shape[0]} x "
              f"{ref.shape[1]} crops, CPU {time.perf_counter() - t0:.1f} s): 1 - cosine max "
              f"{cos_err:.3g}", flush=True)
        if not cos_err <= 1e-5:
            fail(f"{model} {dtype}: card and CPU embeddings disagree (1 - cosine {cos_err})")
        del cpu, ref
    del params
    if timed:
        canvas = torch.from_numpy(batch.canvas).to("cuda")
        ms = time_ms(lambda: enc.embed_crops(canvas, batch.crop_params), min_reps=3, min_s=0.5)
        print(f"{model} {dtype}: {ms:.3f} ms per forward of {batch.canvas.shape[0]} images x "
              f"{emb.shape[1]} crops (steady, S={cfg.seq_len})", flush=True)
    del enc
    torch.cuda.empty_cache()
    return got


def dynamic_int8(root: str, cfg, l336: dict) -> tuple[dict, list[dict]]:
    """Phases 7a-7b: ViT-L-14-336 in dynamic int8. The embed CLI with
    CTPU_INT8_BLOCK=hybrid on copies of the PNGs in a fresh directory (K1
    with quant_out once and K6 three times a layer; no .calib.npz), its
    cosine against the int8_static embeddings; then four images through the
    encoder in each other route against the hybrid embeddings. Returns the
    hybrid path's results and the other routes' counts, the
    CTPU_FUSED_QMATMUL run's last."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as droot:
        for p in l336["pts"]:
            shutil.copy(p[:-3] + ".png", droot)
        with int8_knobs(CTPU_INT8_BLOCK="hybrid", CTPU_FUSED_QMATMUL="0"):
            dyn = embed_and_check(droot, MODEL, cfg, {"K1": cfg.layers, "K6": 3 * cfg.layers},
                                  dtype="int8")
        if [os.path.basename(p) for p in dyn["pts"]] != [os.path.basename(p)
                                                        for p in l336["pts"]]:
            fail("the dynamic-int8 run embedded other files than the int8_static run")
        cos = np.sum(dyn["side"] * l336["side"], axis=-1)
        print(f"{MODEL} int8 (hybrid) vs int8_static cosine over {cos.size} crops: min "
              f"{cos.min():.5f} mean {cos.mean():.5f}", flush=True)
        if not cos.min() > 0.95:
            fail(f"dynamic int8 and int8_static embeddings disagree (cosine min {cos.min()})")
        routes = []
        for block, fused_mm, want in (("xla-plain", "0", {"K1": cfg.layers}),
                                      ("xla", "0", {"K1": cfg.layers}),
                                      ("xla-plain", "1", {"K1": cfg.layers,
                                                          "K9": 4 * cfg.layers})):
            with int8_knobs(CTPU_INT8_BLOCK=block, CTPU_FUSED_QMATMUL=fused_mm):
                routes.append(encoder_run(MODEL, "int8", dyn["pts"], dyn["side"], cfg, want,
                                          side_name=f"int8 hybrid (this run: {block}, "
                                                    f"CTPU_FUSED_QMATMUL={fused_mm})"))
    return dyn, routes


def knob_routes(l336: dict, so400m: dict, cfg, scfg) -> list[dict]:
    """Phase 13: the int8_static routes that CTPU_LN_KERNEL and CTPU_INT8_WIRE
    pick, each through the embed CLI on copies of 4 of the PNGs in a fresh
    directory (the CLI skips embedded images, and the wire changes what
    .calib.npz holds), at full width and depth, with exact launch counters
    for the one forward (the calibration forward launches none), and the
    cosine against the default route's embeddings of the same images:
    ViT-L-14-336 with CTPU_LN_KERNEL=0 (the generic block with static
    scales: K1 a layer, no K2), ViT-L-14-336 with CTPU_INT8_WIRE=1 (the wire
    at S=577: K3 a layer, no K1 or K2), SO400M-384 with CTPU_INT8_WIRE=0
    (lnk with K5: K5 once and K2 twice a layer, no K3). Returns each
    route's counts."""
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    runs = []

    for model, mcfg, default, env, want in (
            (MODEL, cfg, l336, {"CTPU_LN_KERNEL": "0"}, {"K1": cfg.layers}),
            (MODEL, cfg, l336, {"CTPU_INT8_WIRE": "1"}, {"K3": cfg.layers}),
            (SIGLIP, scfg, so400m, {"CTPU_INT8_WIRE": "0"},
             {"K5": scfg.layers, "K2": 2 * scfg.layers})):
        names = [os.path.basename(p) for p in default["pts"]]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_route_") as rroot, \
                int8_knobs(**env):
            for p in default["pts"][:4]:
                shutil.copy(p[:-3] + ".png", rroot)
            reset_counts()
            t0 = time.perf_counter()
            stores = embed_main(["--root_dir", rroot, "--models_to_use", model,
                                 "--compute_dtype", "int8_static", "--batch_size", str(BATCH),
                                 "--num_workers", "4", "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
            if got != {k: want.get(k, 0) for k in got}:
                fail(f"{model} int8_static {env}: launches {got}, expected {want}")
            runs.append(got)
            crops = stores[model].meta["crop_names"]
            pts = sorted(glob.glob(os.path.join(rroot, "*.pt")))
            if len(pts) != 4:
                fail(f"{model} int8_static {env}: {len(pts)} sidecars, want 4")
            emb = np.stack([np.stack([read_sidecar(p)[model][c].reshape(-1) for c in crops])
                            for p in pts])
            ref = default["side"][[names.index(os.path.basename(p)) for p in pts]]
        norms = np.linalg.norm(emb, axis=-1)
        cos = np.sum(emb * ref, axis=-1)
        print(f"route {model} int8_static {env}: 4 images x 4 crops in {wall:.2f} s (model "
              f"init and calibration included); launches {got}; cosine against the default "
              f"route min {cos.min():.5f} mean {cos.mean():.5f}", flush=True)
        if not (np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3 and cos.min() > 0.95):
            fail(f"{model} int8_static {env}: embeddings not finite unit vectors near the "
                 f"default route's (cosine min {cos.min()})")
    return runs


DEDUP_N, DEDUP_D = 262144, 768  # ViT-L-14-336's embedding width
DEDUP_PAIRS, DEDUP_GROUP = 400, 40


def plain_pairs(emb: np.ndarray, threshold: float, euclidean: bool,
                b: int = 8192) -> set:
    """The plain route of stage 2 on the card: float32 ``torch.matmul``
    tiles (TF32 off) of the normalized embeddings over the upper triangle,
    every pair above ``threshold`` − 1e-4 a candidate, then the port's host
    recheck (``_exact_metric_host``, kept above threshold − THRESHOLD_SLACK).
    Returns the set of (i, j)."""
    from clip_assisted_data_labeling_tpu_torch.ops.similarity import (
        THRESHOLD_SLACK,
        _exact_metric_host,
        normalize_rows,
    )

    normed = normalize_rows(emb)
    x = torch.from_numpy(normed).cuda()
    n = len(x)
    rows, cols = [], []
    for r0 in range(0, n, b):
        for c0 in range(r0, n, b):
            sim = torch.matmul(x[r0:r0 + b], x[c0:c0 + b].t())
            metric = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0)) if euclidean else sim
            hit = metric > threshold - 1e-4
            if c0 == r0:
                hit = torch.triu(hit, diagonal=1)
            i, j = hit.nonzero(as_tuple=True)
            rows.append((i + r0).cpu().numpy())
            cols.append((j + c0).cpu().numpy())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = _exact_metric_host(normed, rows, cols, euclidean) > threshold - THRESHOLD_SLACK
    return set(zip(rows[keep].tolist(), cols[keep].tolist()))


def dedup_at_scale() -> list[dict]:
    """Phase 14: stage 2 at a real size. N = DEDUP_N embeddings of width
    DEDUP_D from a seeded generator on the card, with DEDUP_PAIRS planted
    pairs at cosine ~0.999 and one group of DEDUP_GROUP near-identical rows
    (39 matches a row > max_pairs_per_row = 16: k escalates). At threshold
    0.96 random rows stay far below (cosine std ~0.036), so the pair set is
    the planted one. ``find_duplicate_pairs`` on the card over the int8 and
    the fp16 wire, each timed (host preparation and upload, scan, extract
    with the recheck), against the plain route; then the euclidean metric
    at N = 32768 (its most dissimilar pairs) over both wires against the
    plain route. Fails unless the sets are identical, every planted pair is
    found and the wires' overflow rows agree. Returns one record a run."""
    from clip_assisted_data_labeling_tpu_torch.ops.similarity import find_duplicate_pairs
    from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

    gen = torch.Generator(device="cuda").manual_seed(12)
    emb = torch.randn((DEDUP_N, DEDUP_D), generator=gen, device="cuda")
    perm = torch.randperm(DEDUP_N, generator=gen, device="cuda").cpu().numpy()
    group = np.sort(perm[:DEDUP_GROUP])
    src = perm[DEDUP_GROUP:DEDUP_GROUP + DEDUP_PAIRS]
    dst = perm[DEDUP_GROUP + DEDUP_PAIRS:DEDUP_GROUP + 2 * DEDUP_PAIRS]
    emb[torch.from_numpy(dst).cuda()] = emb[torch.from_numpy(src).cuda()] + 0.05 * torch.randn(
        (DEDUP_PAIRS, DEDUP_D), generator=gen, device="cuda")
    emb[torch.from_numpy(group).cuda()] = emb[int(group[0])] + 0.01 * torch.randn(
        (DEDUP_GROUP, DEDUP_D), generator=gen, device="cuda")
    emb = emb.cpu().numpy()
    planted = {(min(a, b), max(a, b)) for a, b in zip(src.tolist(), dst.tolist())}
    planted |= {(int(a), int(b)) for i, a in enumerate(group) for b in group[i + 1:]}

    # warm cuBLAS and the allocator at a small size, outside the timed runs
    find_duplicate_pairs(emb[:20000], threshold=0.96)
    records, results = [], {}
    for wire in ("int8", "fp16"):
        timer = StageTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = find_duplicate_pairs(emb, threshold=0.96, wire=wire, timer=timer)
        total = time.perf_counter() - t0
        results[wire] = res
        rec = {"stage": "dedup", "metric": "cosine", "n": DEDUP_N, "d": DEDUP_D, "wire": wire,
               "seconds": total, **{f"{k}_s": v for k, v in timer.totals.items()},
               "embeddings_per_s": DEDUP_N / total, "pairs": len(res.rows),
               "overflow_rows": len(res.overflow_rows),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        records.append(rec)
        print(f"stage 2 {wire} wire, N={DEDUP_N} D={DEDUP_D}: {total:.3f} s = "
              f"{DEDUP_N / total:,.0f} embeddings/s (prepare and upload "
              f"{rec['prepare_s']:.3f} s, scan {rec['scan_s']:.3f} s, extract and recheck "
              f"{rec.get('extract_s', 0.0):.3f} s); {rec['pairs']} pairs, "
              f"{rec['overflow_rows']} overflow rows", flush=True)
    t0 = time.perf_counter()
    plain = plain_pairs(emb, 0.96, False)
    print(f"stage 2 plain f32 route: {len(plain)} pairs in {time.perf_counter() - t0:.3f} s",
          flush=True)
    sets = {w: set(zip(r.rows.tolist(), r.cols.tolist())) for w, r in results.items()}
    if not (sets["int8"] == sets["fp16"] == plain):
        fail(f"stage 2: the pair sets differ (int8 {len(sets['int8'])}, fp16 "
             f"{len(sets['fp16'])}, plain {len(plain)})")
    if not planted <= plain:
        fail(f"stage 2: {len(planted - plain)} planted pairs not found")
    if not (np.array_equal(results["int8"].overflow_rows, results["fp16"].overflow_rows)
            and len(results["int8"].overflow_rows) > 0):
        fail("stage 2: the wires' overflow rows differ, or k did not escalate")
    print(f"stage 2: int8 = fp16 = plain ({len(plain)} pairs, all {len(planted)} planted "
          f"found, {len(plain - planted)} others), overflow rows "
          f"{len(results['int8'].overflow_rows)} on both wires", flush=True)

    sub = emb[:32768]
    ref = plain_pairs(sub, 1.52, True)
    for wire in ("int8", "fp16"):
        t0 = time.perf_counter()
        res = find_duplicate_pairs(sub, threshold=1.52, sim_type="euclidean", wire=wire)
        dt = time.perf_counter() - t0
        got = set(zip(res.rows.tolist(), res.cols.tolist()))
        records.append({"stage": "dedup", "metric": "euclidean", "n": len(sub), "d": DEDUP_D,
                        "wire": wire, "seconds": dt, "embeddings_per_s": len(sub) / dt,
                        "pairs": len(got)})
        print(f"stage 2 euclidean {wire} wire, N={len(sub)}: {len(got)} pairs (plain "
              f"{len(ref)}) in {dt:.3f} s", flush=True)
        if got != ref or not got:
            fail(f"stage 2 euclidean {wire}: {len(got)} pairs, the plain route {len(ref)}")
    del emb
    return records


def dedup_cli(root: str) -> dict:
    """Phase 15: the dedup CLI end to end on the card. Six of the PNGs and
    byte-identical copies of two of them in a fresh directory, embedded by
    the embed CLI (ViT-L-14-336/openai, bfloat16; counters zeroed before and
    read after), then ``python -m ...pipeline.dedup --threshold 0.99 --mode
    copy`` in a process of its own (``-X importtime``: neither pandas nor
    matplotlib may be imported). Fails unless the planted pairs are found,
    the pairs its copies name equal the plain route's on the same store
    (random-weight towers make a narrow cone, so other pairs may pass too),
    and every pair's file groups are in near_duplicates_cosine_0.99. Returns
    the embed's launch counts."""
    from clip_assisted_data_labeling_tpu_torch.config import DedupConfig
    from clip_assisted_data_labeling_tpu_torch.pipeline.dedup import load_embeddings
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main

    base = tempfile.mkdtemp(prefix="chip_smoke_dedup_")
    try:
        droot = os.path.join(base, "mydata")
        os.makedirs(droot)
        for i in range(6):
            shutil.copy(os.path.join(root, f"img_{i:03d}.png"), droot)
        shutil.copy(os.path.join(root, "img_001.png"), os.path.join(droot, "zz_copy_a.png"))
        shutil.copy(os.path.join(root, "img_004.png"), os.path.join(droot, "zz_copy_b.png"))
        reset_counts()
        embed_main(["--root_dir", droot, "--models_to_use", MODEL, "--compute_dtype",
                    "bfloat16", "--batch_size", str(BATCH), "--num_workers", "4",
                    "--device", "cuda"])
        torch.cuda.synchronize()
        embed_counts = counts()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-X", "importtime", "-m",
             "clip_assisted_data_labeling_tpu_torch.pipeline.dedup", "--root_dir", droot,
             "--threshold", "0.99", "--mode", "copy"],
            capture_output=True, text=True, timeout=600, cwd=os.path.dirname(
                os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"dedup CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        imported = {ln.split("|")[-1].strip().split(".")[0] for ln in proc.stderr.splitlines()
                    if ln.startswith("import time:")}
        if imported & {"pandas", "matplotlib", "jax"}:
            fail(f"the dedup CLI imported {sorted(imported & {'pandas', 'matplotlib', 'jax'})}")
        outdir = os.path.join(base, "near_duplicates_cosine_0.99")
        found: dict[int, dict[str, set]] = {}  # pair → role → file group
        for f in os.listdir(outdir) if os.path.isdir(outdir) else []:
            _sim, idx, role, name = f.split("_", 3)
            found.setdefault(int(idx), {}).setdefault(role, set()).add(name)
        # each image's group is its PNG and its sidecar
        groups_ok = all(
            set(p) == {"source", "target"}
            and all(len(g) == 2 and {os.path.splitext(n)[1] for n in g} == {".png", ".pt"}
                    and len({os.path.splitext(n)[0] for n in g}) == 1 for g in p.values())
            for p in found.values())
        pairs = {frozenset(n for g in p.values() for n in g if n.endswith(".png"))
                 for p in found.values()}
        paths, emb = load_embeddings(droot, DedupConfig())
        names = [os.path.basename(p) for p in paths]
        plain = {frozenset((names[i], names[j])) for i, j in plain_pairs(emb, 0.99, False)}
        planted = {frozenset(("img_001.png", "zz_copy_a.png")),
                   frozenset(("img_004.png", "zz_copy_b.png"))}
        print(f"dedup CLI on {len(paths)} images ({wall:.2f} s, its own process): "
              f"{proc.stdout.strip().splitlines()[-2:]}; pairs {sorted(map(sorted, pairs))}; "
              f"plain route {len(plain)} pairs; embed launches {embed_counts}", flush=True)
        if not (planted <= pairs and pairs == plain and groups_ok):
            fail(f"dedup CLI: pairs {pairs}, plain route {plain}, planted {planted}")
        return embed_counts
    finally:
        shutil.rmtree(base, ignore_errors=True)


# mangled builtin types and classes a kernel's template arguments name
MANGLED_TYPES = {"f": "f32", "a": "i8", "__nv_bfloat16": "bf16"}


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    ``exact_wgmma_kernel<64,0,0,bf16>``: the first identifier of its
    (nested) name that ends in ``kernel``, with its integer arguments and
    the types among them (``MANGLED_TYPES``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while (n := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + n.end()
        pos = start + int(n.group())
        if mangled[start:pos].endswith("kernel"):
            args, at = [], pos + 1  # the arguments follow an I, up to their E
            while mangled[pos:pos + 1] == "I" and at < len(mangled) and mangled[at] != "E":
                if (m := re.match(r"L[a-z](n?\d+)E", mangled[at:])) is not None:
                    arg, at = m.group(1).replace("n", "-"), at + m.end()
                elif (m := re.match(r"\d+", mangled[at:])) is not None:  # a class
                    arg, at = mangled[at + m.end():at + m.end() + int(m.group())], \
                        at + m.end() + int(m.group())
                elif mangled[at].islower():  # a builtin type
                    arg, at = mangled[at], at + 1
                else:
                    break
                args.append(MANGLED_TYPES.get(arg, arg))
            return mangled[start:pos] + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an nvcc log built with ``-Xptxas -v``: its
    name, registers, static shared memory, stack frame and spills; and one
    for each warning that ptxas serialized a kernel's wgmma products."""
    out, name = [], None
    for line in log.splitlines():
        if "Performance Loss" in line and (m := re.search(r"'(_Z\w+)'", line)) is not None:
            out.append(f"{kernel_name(m.group(1))}: {line.split('Performance Loss:')[-1].strip()}")
        elif "Compiling entry function" in line:
            name, stack = kernel_name(line.split("'")[1]), ""
        elif name and "bytes stack frame" in line:
            stack = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs}, {smem.group(1) if smem else 0} bytes static smem; {stack}")
            name = None
    return out


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
        kernels()
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
        print(f"built {name}:")
        for line in ptxas_summary(log):
            print(f"  {line}")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 3: kernels against their plain versions ----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_kernels(gen, *(torch.Generator(device="cuda").manual_seed(i)
                                for i in (1, 2, 3, 4, 5, 6)))
    quant_out_long_sequences()
    torch.cuda.empty_cache()

    cfg, scfg = resolve_config(MODEL), resolve_config(SIGLIP)
    pcfg, gcfg = resolve_config(PE_L), resolve_config(PE_G)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        write_pngs(root)

        # --- phases 5-6: ViT-L-14-336 int8_static: K1 once and K2 twice a
        # layer; the calibration forward runs the XLA-style attention, no kernel
        l336 = embed_and_check(root, MODEL, cfg, {"K1": cfg.layers, "K2": 2 * cfg.layers})
        # --- phase 7: float32 paths on a few images: L-336 takes K4 (the JAX
        # package's grouped route for its shape), L-14 at 224 px K1
        l336_f32 = encoder_run(MODEL, "float32", l336["pts"], l336["side"], cfg,
                               {"K4": cfg.layers}, timed=True)
        l14cfg = resolve_config(L14)
        l14_f32 = encoder_run(L14, "float32", l336["pts"], None, l14cfg, {"K1": l14cfg.layers},
                              timed=True, cpu_ref=True)

        # --- phases 7a-7b: ViT-L-14-336 dynamic int8 in every block route
        dyn, dyn_routes = dynamic_int8(root, cfg, l336)

        # --- phases 8-9: ViT-SO400M-14-SigLIP-384 int8_static through the int8
        # attention wire (K3 a layer), then bfloat16 (K5 a layer)
        so400m = embed_and_check(root, SIGLIP, scfg, {"K3": scfg.layers})
        bf16 = encoder_run(SIGLIP, "bfloat16", so400m["pts"], so400m["side"], scfg,
                           {"K5": scfg.layers}, timed=True)
        # --- phase 9a: its float32 path (K5's float32 kernel a layer), held
        # against the same encoder on the CPU on one image
        so400m_f32 = encoder_run(SIGLIP, "float32", so400m["pts"], so400m["side"], scfg,
                                 {"K5": scfg.layers}, timed=True, cpu_ref=True, cpu_images=1)

        # --- phases 10-11: PE-Core-L14-336 int8_static (K1 with RoPE once and
        # K2 twice a layer), then its bf16 (K1) and float32 (K4) paths
        pe = embed_and_check(root, PE_L, pcfg, {"K1": pcfg.layers, "K2": 2 * pcfg.layers})
        pe_bf16 = encoder_run(PE_L, "bfloat16", pe["pts"], pe["side"], pcfg,
                              {"K1": pcfg.layers}, timed=True)
        pe_f32 = encoder_run(PE_L, "float32", pe["pts"], pe["side"], pcfg, {"K4": pcfg.layers},
                             timed=True)
        # --- phase 12: PE-Core-G14-448 bf16, all 50 layers (K4 with RoPE)
        g14 = encoder_run(PE_G, "bfloat16", pe["pts"], None, gcfg, {"K4": gcfg.layers},
                          timed=True)

        # --- phase 13: the int8_static routes of CTPU_LN_KERNEL and CTPU_INT8_WIRE
        routes = knob_routes(l336, so400m, cfg, scfg)

        # --- phases 14-15: stage 2 (no kernel of the table: torch products)
        # at N = 262144, then the dedup CLI end to end on embedded PNGs
        dedup_records = dedup_at_scale()
        dedup_embed = dedup_cli(root)

    # each row's launches: the counter its ``path`` names, read from that
    # main path; "all" (the kernels no path of the JAX package reaches) sums
    # the counter over every main path; None (a shape no path runs) is 0
    paths = {"l336": l336["launches"], "l336_f32": l336_f32, "l14_f32": l14_f32,
             "dyn": dyn["launches"], "fused_qmatmul": dyn_routes[-1],
             "so400m": so400m["launches"], "so400m_bf16": bf16, "so400m_f32": so400m_f32,
             "pe": pe["launches"],
             "pe_f32": pe_f32, "g14": g14, "l336_ln0": routes[0], "l336_wire": routes[1],
             "so400m_wire0": routes[2]}
    every = [*paths.values(), *dyn_routes[:-1], pe_bf16, dedup_embed]

    def path_launches(path) -> int:
        if path is None:
            return 0
        name, counter = path
        return sum(p[counter] for p in every) if name == "all" else paths[name][counter]

    rows = [dict(r, path=r["path"] and "/".join(r["path"]), launches=path_launches(r["path"]))
            for r in rows]
    print(json.dumps({"dedup": dedup_records}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
